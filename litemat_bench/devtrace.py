"""The traced run's view of the device: ``torch.profiler`` over the window.

Device operations (kernels, copies, sets) come from the profiler's CUDA
events; a ``record_function`` marker opened at the window's start puts them
on the harness's ``time.perf_counter`` clock, which the host spans use too.
Busy time is the union of the device operations' intervals, so operations
that overlap count once.
"""
from __future__ import annotations

import re
import time

import torch

from litemat_bench import stats

MARK = "litemat_bench.window"
# the sort kernels behind ``torch.sort`` and ``torch.unique``: cub's radix,
# segmented and merge sorts and ATen's in-place sorts of short rows.
# ``searchsorted`` is a binary search and is no sort.
SORT_KERNEL = re.compile(r"RadixSort|SegmentedSort|MergeSort|bitonicSort"
                         r"|SortKVInPlace|sort_postprocess", re.IGNORECASE)


class WindowProfile:
    """Profile the measured window when ``enabled``; otherwise do nothing."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self.ops: list = []  # (name, start, end) on the perf_counter clock
        self._prof = self._mark = None
        self._t0 = None

    def open(self) -> float:
        """Start profiling and return the window's opening time."""
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            try:
                self._prof = profile(activities=acts, acc_events=True)
            except TypeError:  # a release without acc_events
                self._prof = profile(activities=acts)
            self._prof.start()
            self._mark = torch.profiler.record_function(MARK)
            self._mark.__enter__()
        self._t0 = time.perf_counter()
        return self._t0

    def close(self) -> None:
        """Stop profiling (after the device is done with the window's work)."""
        if not self.enabled:
            return
        self._mark.__exit__(None, None, None)
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.stop()
        from torch.autograd import DeviceType
        events = self._prof.events()
        mark = next(e for e in events if e.name == MARK)
        offset = self._t0 - mark.time_range.start / 1e6
        # the marker shows on the device's timeline too, as an annotation
        # over the kernels the marking thread launched: it is no operation
        self.ops = [(e.name, e.time_range.start / 1e6 + offset,
                     e.time_range.end / 1e6 + offset)
                    for e in events if e.device_type == DeviceType.CUDA
                    and e.name != MARK
                    and not getattr(e, "is_user_annotation", False)]
        self._prof = None


def busy_s(ops, t0: float, t1: float) -> float:
    return stats.union_length([(a, b) for _, a, b in ops], t0, t1)


def top_ops(ops, t0: float, t1: float, n: int = 10) -> list:
    """The ``n`` device operations that took most time, by name."""
    by: dict = {}
    for name, a, b in ops:
        d = min(b, t1) - max(a, t0)
        if d > 0:
            key = name[:64]
            by[key] = by.get(key, 0.0) + d
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def idle_by_span(ops, spans, t0: float, t1: float, n: int = 10) -> list:
    """The device's idle time in [t0, t1], by the innermost host span open
    over it, the longest first."""
    g = stats.gaps([(a, b) for _, a, b in ops], t0, t1)
    by = stats.attribute(g, spans)
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def _kernels(ops) -> list:
    return [op for op in ops if not op[0].startswith(("Memcpy", "Memset"))]


def idle_pct(run):
    """100 x the share of the window in which no device operation ran."""
    if not run.traced or not run.ops:
        return None
    busy = busy_s(run.ops, run.t_open, run.t_close)
    return 100.0 * (1.0 - busy / (run.t_close - run.t_open))


def sort_pct(run):
    """100 x the share of the window's kernel time spent in sort kernels
    (named by ``SORT_KERNEL``)."""
    kernels = _kernels(run.ops)
    total = busy_s(kernels, run.t_open, run.t_close)
    if not total:
        return None
    sort = busy_s([op for op in kernels if SORT_KERNEL.search(op[0])],
                  run.t_open, run.t_close)
    return 100.0 * sort / total
