"""The traffic generator is a function of the mix and the seed."""
from __future__ import annotations

import json

from litemat_bench.spec import BENCH
from litemat_bench.workload import BLOCK, RequestStream

FACETS = json.loads((BENCH / "traffic" / "facets.json").read_text())


def test_same_seed_same_requests():
    big = 2**31 + 12345
    a = RequestStream(FACETS, big).take(BLOCK + 100)
    b = RequestStream(FACETS, big).take(BLOCK + 100)
    assert a == b
    assert a != RequestStream(FACETS, big + 1).take(BLOCK + 100)


def test_requests_follow_the_mix():
    reqs = RequestStream(FACETS, 7).take(4 * BLOCK)
    kinds = [k for k, _, _ in reqs]
    assert abs(kinds.count("class_members") / len(kinds) - 0.5) < 0.03
    assert {c for _, c, _ in reqs} == set(FACETS["classes"])
    assert {p for k, _, p in reqs if k == "class_prop_join"} == set(
        FACETS["properties"])
    assert all(p is None for k, _, p in reqs if k == "class_members")

