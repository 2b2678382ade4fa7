"""A tiny rehearsal of each cell on the CPU, through the program's plain
versions: LUBM-1, a one-second window, both kinds of run."""
from __future__ import annotations

import time

import pytest

from litemat_bench.run import run_cell


@pytest.mark.parametrize("workload", ["lubm100.facets", "lubm800.load"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(tiny_cell, workload, trace):
    c = tiny_cell(workload)
    r = run_cell(c, 2**31 + 77, 1.0, trace, "cpu", t_start=time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    if trace:
        assert "breakdown" in r and r["device"]["window_s"] >= 1.0
        assert set(r["metrics"]) <= {m["name"] for m in c.per_layer}
        host = {"requests_per_s.facets", "request_p95_ms.facets",
                "queue_ms.facets",
                "execute_ms.facets", "server_batch_members.facets",
                "encode_ms.load", "materialize_ms.load"}
        assert host & {m["name"] for m in c.per_layer} <= set(r["metrics"])
    else:
        assert "setup_s" in r["metrics"]
        assert set(r["metrics"]) <= {m["name"] for m in c.end_to_end}
        if "load" in workload:
            assert r["metrics"]["load_triples_per_s"]["value"] > 0
