"""Each cell at LUBM-1 on the card, traced and not: the device paths of the
harness (peak memory, the profiler's device operations) end to end.

    python -m pytest -m cuda litemat_bench/tests/test_bench_cuda.py
"""
from __future__ import annotations

import time

import pytest
import torch

from litemat_bench.run import run_cell


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["lubm100.facets", "lubm800.load"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_card(tiny_cell, workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run_cell(tiny_cell(workload), 2**31 + 5, 2.0, trace, "cuda:0",
                 t_start=time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert r["breakdown"]["device_ops"]
        assert "device_idle_pct." + workload.split(".")[1] in r["metrics"]
    else:
        assert {m["name"] for m in tiny_cell(workload).end_to_end} == set(
            r["metrics"])
