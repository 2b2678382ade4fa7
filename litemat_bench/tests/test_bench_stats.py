"""The metric arithmetic: rates over the whole window, tails over every
request, idle time as a union of intervals, a load window that ends with
its last build."""
from __future__ import annotations

import pytest

from litemat_bench import devtrace, spec, stats
from litemat_bench.drive import Run


def test_percentile_matches_linear_order_statistics():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0


def test_union_counts_overlaps_once_and_clips():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (9.0, 12.0)]
    assert stats.union_length(iv, 0.0, 10.0) == pytest.approx(5.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert stats.union_length([], 0.0, 1.0) == 0.0


def test_idle_time_goes_to_the_innermost_span():
    spans = [("request", 0.0, 10.0, 0), ("execute", 2.0, 4.0, 2),
             ("queue", 3.0, 8.0, 1)]
    by = stats.attribute([(1.0, 5.0), (9.0, 11.0)], spans)
    assert by == pytest.approx({"request": 2.0, "execute": 2.0,
                                "queue": 1.0, "none": 1.0})


def _serve_run(lat_ok, late):
    run = Run(kind="serve_closed_loop", n_raw=1000,
              t_open=100.0, t_close=110.0)
    for i, lat in enumerate(lat_ok):
        t = 100.0 + 0.01 * i
        run.requests.append({"t_issue": t, "t_done": t + lat,
                             "status": "ok"})
    for _ in range(late):  # resolved after the window closed
        run.requests.append({"t_issue": 109.9, "t_done": 111.0,
                             "status": "ok"})
    return run


def test_rate_is_over_the_whole_window():
    run = _serve_run([0.5] * 200, late=16)
    assert spec.reader("metrics", "requests_per_s.facets")(run) == 20.0


def test_tail_is_over_every_request_in_the_window():
    lat = [0.1] * 90 + [1.0] * 10
    run = _serve_run(lat, late=5)
    p95 = spec.reader("metrics", "request_p95_ms.facets")(run)
    assert p95 == pytest.approx(1e3 * stats.percentile(lat, 95))
    run.requests[-6]["status"] = "error"  # failed requests stay in the tail
    assert spec.reader("metrics", "request_p95_ms.facets")(run) == p95


def test_load_window_ends_with_its_last_build():
    run = Run(kind="bulk_load", n_raw=1_000_000,
              t_open=0.0, t_close=12.0)
    run.builds = [{"t0": 4.0 * i, "t1": 4.0 * (i + 1)}
                  for i in range(3)]
    assert spec.reader("end_to_end", "load_triples_per_s")(run) == 250_000.0
    assert spec.reader("metrics", "requests_per_s.facets")(run) is None


def test_idle_share_and_sort_share_from_device_ops():
    run = Run(kind="bulk_load", n_raw=1, t_open=0.0,
              t_close=4.0, traced=True)
    run.ops = [("DeviceRadixSortOnesweepKernel", 0.0, 1.0),
               ("elementwise_kernel", 0.5, 2.0),
               ("at::native::searchsorted_cuda_kernel", 2.0, 2.5),
               ("Memcpy DtoH (Device -> Pageable)", 3.0, 3.5)]
    assert devtrace.idle_pct(run) == pytest.approx(100 * (1 - 3.0 / 4))
    assert devtrace.sort_pct(run) == pytest.approx(40.0)
    run.ops.append(("at::native::bitonicSortKVInPlace", 3.5, 4.0))
    assert devtrace.sort_pct(run) == pytest.approx(50.0)
    run.ops = []
    assert devtrace.idle_pct(run) is None and devtrace.sort_pct(run) is None
