"""The plain reference at LUBM-1 against a brute-force closure: the RDFS
rules applied to a Python set of triples until nothing new follows."""
from __future__ import annotations

from collections import Counter

import pytest
import torch

from litemat_bench.frozen import ontology as onto
from litemat_bench.frozen.generator import fingerprint_string, generate_lubm
from litemat_bench.reference.rdfs import Entailment, multiset_difference


@pytest.fixture(scope="module")
def lubm1():
    s, p, o = generate_lubm(1, 0)
    E = Entailment.build(s, p, o, "cpu")
    fp = fingerprint_string
    TYPE = fp(onto.RDF_TYPE)
    sub_c = {fp(a): fp(b) for a, b in onto.SUBCLASS}
    sub_p = {fp(a): fp(b) for a, b in onto.SUBPROP}
    dom = {fp(k): [fp(c) for c in v] for k, v in onto.DOMAIN.items()}
    rng = {fp(k): [fp(c) for c in v] for k, v in onto.RANGE.items()}
    raw = list(zip(s.tolist(), p.tolist(), o.tolist()))
    closed, frontier = set(raw), set(raw)
    while frontier:
        new = set()
        for a, b, c in frontier:
            if b == TYPE:
                if c in sub_c:
                    new.add((a, TYPE, sub_c[c]))
                continue
            if b in sub_p:
                new.add((a, sub_p[b], c))
            new.update((a, TYPE, d) for d in dom.get(b, ()))
            new.update((c, TYPE, r) for r in rng.get(b, ()))
        frontier = new - closed
        closed |= frontier
    return E, raw, closed, TYPE, sub_c


def _rows(t):
    return {tuple(r) for r in t.tolist()}


def test_full_store_is_the_fixpoint(lubm1):
    E, _, closed, _, _ = lubm1
    full = E.full_store()
    assert full.shape[0] == len(closed)
    assert _rows(full) == closed


def test_lite_store_keeps_raw_rows_and_most_specific_types(lubm1):
    E, raw, closed, TYPE, sub_c = lubm1
    types: dict = {}
    for a, b, c in closed:
        if b == TYPE:
            types.setdefault(a, set()).add(c)

    def above(c):
        out = set()
        while c in sub_c:
            c = sub_c[c]
            out.add(c)
        return out
    want = Counter((a, b, c) for a, b, c in raw if b != TYPE)
    for x, ts in types.items():
        strict = set().union(*(above(c) for c in ts))
        want.update((x, TYPE, c) for c in ts - strict)
    rows = torch.tensor(list(want.elements()), dtype=torch.int64)
    assert multiset_difference(E.lite_store(), rows) == 0


@pytest.mark.parametrize("cls,prop", [("Person", "memberOf"),
                                      ("Professor", "degreeFrom"),
                                      ("Chair", "worksFor"),
                                      ("Student", "takesCourse")])
def test_facets_are_the_fixpoint_answers(lubm1, cls, prop):
    E, _, closed, TYPE, _ = lubm1
    c, p = fingerprint_string(cls), fingerprint_string(prop)
    members = {a for a, b, o in closed if b == TYPE and o == c}
    subjects = {a for a, b, _ in closed if b == p}
    assert set(E.members(cls).tolist()) == members
    got = E.members(cls)
    got = got[torch.isin(got, E.join_subjects(prop))]
    assert set(got.tolist()) == members & subjects


def test_multiset_difference_counts_multiplicity():
    a = torch.tensor([[1, 2, 3], [1, 2, 3], [4, 5, 6]])
    b = torch.tensor([[1, 2, 3], [7, 8, 9]])
    assert multiset_difference(a, b) == 3
    assert multiset_difference(a, a.flip(0)) == 0
