"""The arithmetic of the metrics: rates, tails and interval unions."""
from __future__ import annotations

import math

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile (linear between order statistics) of every
    value."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        raise ValueError("no values")
    rank = q / 100.0 * (v.size - 1)
    lo, hi = math.floor(rank), math.ceil(rank)
    return float(v[lo] + (v[hi] - v[lo]) * (rank - lo))


def merged(intervals, lo: float, hi: float) -> list:
    """The union of ``(start, end)`` intervals clipped to [lo, hi], as
    disjoint sorted intervals."""
    out: list = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def union_length(intervals, lo: float, hi: float) -> float:
    return sum(b - a for a, b in merged(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list:
    """The parts of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in merged(intervals, lo, hi):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def attribute(gap_list, spans) -> dict:
    """Seconds of each gap by the innermost host span open over it.

    ``spans`` are ``(name, start, end, depth)``; where several are open, the
    deepest one, and among those the latest opened, takes the time.  Time no
    span covers goes to ``"none"``.
    """
    spans = [s for s in spans if s[2] > s[1]]
    points = sorted({t for a, b in gap_list for t in (a, b)}
                    | {t for _, a, b, _ in spans for t in (a, b)})
    if not gap_list:
        return {}
    events = sorted([(a, 1, i) for i, (_, a, _, _) in enumerate(spans)]
                    + [(b, 0, i) for i, (_, _, b, _) in enumerate(spans)])
    out: dict = {}
    open_: set = set()
    gi, ei = 0, 0
    for t0, t1 in zip(points, points[1:]):
        while ei < len(events) and events[ei][0] <= t0:
            _, kind, i = events[ei]
            (open_.add if kind else open_.discard)(i)
            ei += 1
        while gi < len(gap_list) and gap_list[gi][1] <= t0:
            gi += 1
        if gi == len(gap_list):
            break
        a, b = gap_list[gi]
        if t0 < a or t1 > b:
            continue
        name = "none"
        if open_:
            i = max(open_, key=lambda j: (spans[j][3], spans[j][1]))
            name = spans[i][0]
        out[name] = out.get(name, 0.0) + (t1 - t0)
    return out


def span_mean_ms(run, names) -> float | None:
    """Mean summed duration, in ms, of the spans named ``names`` per group
    (a request's trace, or a build), over the groups that have them."""
    per: dict = {}
    for name, a, b, _, group in run.spans:
        if name in names:
            per[group] = per.get(group, 0.0) + (b - a)
    if not per:
        return None
    return 1e3 * sum(per.values()) / len(per)
