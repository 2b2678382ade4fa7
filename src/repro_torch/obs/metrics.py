"""Process-wide metrics registry: counters, gauges, histogram sketches.

Before this module the repo's operational signals were scattered one-off
dicts — ``ServingRuntime.stats``, ``SnapshotRegistry.stats``,
``DeviceStoreCache.stats``, ``ops.pass_counters`` — each with its own
locking story (or none) and no percentile support.  The registry gives
every layer the same three instruments:

  * :class:`Counter` — monotonic, lock-guarded increments (safe under the
    threaded serving workers; a GIL'd ``dict[k] += 1`` is NOT atomic across
    its read/add/store bytecodes).
  * :class:`Gauge` — last-write-wins point-in-time values (queue depth,
    live snapshot versions, observed selectivities).
  * :class:`Histogram` — a log-bucketed sketch: observations land in
    geometric buckets ``GROWTH**i`` (GROWTH = 2^(1/8), ~9% wide), so p50 /
    p99 / mean come from O(#buckets) memory at <= ~4.5% relative value
    error, never from an unbounded sample list.  Exact count / sum / min /
    max ride along.

Instruments are keyed by ``(name, sorted(labels))`` and created on first
use::

    REGISTRY.counter("serving/outcomes", status="ok").inc()
    REGISTRY.histogram("serving/latency_s", status="ok").observe(dt)
    REGISTRY.gauge("serving/queue_depth").set(q.qsize())

``MetricsRegistry`` instances are cheap; per-object scopes (one per
:class:`~repro.serving.runtime.ServingRuntime`, one per
:class:`~repro.core.snapshot.SnapshotRegistry`) keep test assertions
isolated, while the module-level :data:`REGISTRY` is the process-wide
default that engine flushes, device-transfer accounting, kernel pass
counts, and planner selectivities report into.  ``snapshot()`` renders
everything to one JSON-ready dict (obs/export.py writes it to disk; the
serving bench derives its BENCH rows from it).
"""
from __future__ import annotations

import math
import threading

# Geometric bucket growth: 2^(1/8) per bucket => any observation is
# reported within +-(GROWTH-1)/2 ~ 4.5% of its true value.
_GROWTH_LOG = math.log(2.0) / 8.0

#: Wire-format version of :meth:`MetricsRegistry.mergeable_snapshot`.
#: Bumped whenever the snapshot layout OR bucket geometry changes —
#: the aggregator refuses to merge across versions.
SNAPSHOT_SCHEMA_VERSION = "repro.metrics.snapshot/1"


def _bucket_of(v: float) -> int:
    return int(math.floor(math.log(v) / _GROWTH_LOG)) if v > 0 else -(1 << 30)


def _bucket_value(i: int) -> float:
    # geometric midpoint of [GROWTH**i, GROWTH**(i+1))
    return math.exp((i + 0.5) * _GROWTH_LOG)


class Counter:
    """Monotonic counter; ``inc`` is atomic under its own lock."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def add(self, dv: float) -> float:
        with self._lock:
            self._value += dv
            return self._value

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Log-bucketed duration/size sketch with exact count/sum/min/max."""

    __slots__ = ("_lock", "buckets", "count", "sum", "min", "max")

    def __init__(self):
        self._lock = threading.Lock()
        self.buckets: dict = {}  # bucket index -> count
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        b = _bucket_of(v)
        with self._lock:
            self.buckets[b] = self.buckets.get(b, 0) + 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]); 0.0 when empty."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = q / 100.0 * (self.count - 1)
            seen = 0
            for b in sorted(self.buckets):
                seen += self.buckets[b]
                if seen > rank:
                    # clamp the sketch to the exact observed envelope
                    return min(max(_bucket_value(b), self.min), self.max)
            return self.max

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def summary(self) -> dict:
        with self._lock:
            if self.count == 0:
                return dict(n=0)
            count, vmin, vmax, total = (self.count, self.min, self.max,
                                        self.sum)
        return dict(n=count, sum=total, mean=total / count, min=vmin,
                    max=vmax, p50=self.percentile(50),
                    p99=self.percentile(99))

    def state(self) -> dict:
        """Copy of the accumulator — pair with :func:`window_summary` to
        report only the observations that landed after this point (the
        serving bench excludes its warmup epoch this way).  The raw bucket
        map is also the MERGEABLE wire form: two states from different
        processes combine bucket-wise (same geometric bucket boundaries by
        construction) — see :mod:`repro.obs.aggregate`."""
        with self._lock:
            return dict(buckets=dict(self.buckets), count=self.count,
                        sum=self.sum, min=self.min, max=self.max)


def merge_states(*states: dict) -> dict:
    """Merge raw :meth:`Histogram.state` dicts bucket-wise.

    The log-bucket boundaries are fixed by ``_GROWTH_LOG`` (a process
    constant), so sketches from different processes share bucket indexes
    and merging is a per-index count sum — associative and commutative by
    construction.  Count / sum add exactly; the min/max envelope is the
    elementwise extreme.  Accepts states with or without min/max (older
    window states) — absent extremes fall back to the bucket envelope.
    """
    buckets: dict = {}
    count, total = 0, 0.0
    vmin, vmax = math.inf, -math.inf
    for s in states:
        for b, c in s.get("buckets", {}).items():
            b = int(b)  # JSON round-trips bucket indexes as strings
            buckets[b] = buckets.get(b, 0) + int(c)
        count += int(s.get("count", 0))
        total += float(s.get("sum", 0.0))
        if s.get("count", 0):
            vmin = min(vmin, float(s.get("min", math.inf)))
            vmax = max(vmax, float(s.get("max", -math.inf)))
    if count and not math.isfinite(vmin):  # no envelope in any input
        idx = sorted(buckets)
        vmin, vmax = _bucket_value(idx[0]), _bucket_value(idx[-1])
    return dict(buckets=buckets, count=count, sum=total, min=vmin, max=vmax)


def summarize_state(state: dict) -> dict:
    """Render a raw (possibly merged) histogram state like ``summary()``."""
    count = int(state.get("count", 0))
    if count == 0:
        return dict(n=0)
    buckets = {int(b): int(c) for b, c in state.get("buckets", {}).items()}
    idx = sorted(buckets)
    vmin = float(state.get("min", _bucket_value(idx[0])))
    vmax = float(state.get("max", _bucket_value(idx[-1])))

    def pct(q: float) -> float:
        rank = q / 100.0 * (count - 1)
        seen = 0
        for b in idx:
            seen += buckets[b]
            if seen > rank:
                return min(max(_bucket_value(b), vmin), vmax)
        return vmax

    total = float(state.get("sum", 0.0))
    return dict(n=count, sum=total, mean=total / count, min=vmin, max=vmax,
                p50=pct(50), p99=pct(99))


def window_summary(hist: Histogram, before: dict) -> dict:
    """Summary of the observations landed since ``before = hist.state()``.

    Count / sum / mean are exact differences; percentiles come from the
    bucket-count diff, and the min/max envelope is the sketch's own bucket
    resolution (~4.5%) because the windowed extremes are not tracked.
    """
    after = hist.state()
    count = after["count"] - before["count"]
    if count <= 0:
        return dict(n=0)
    total = after["sum"] - before["sum"]
    buckets = {b: after["buckets"].get(b, 0) - before["buckets"].get(b, 0)
               for b in after["buckets"]}
    buckets = {b: c for b, c in buckets.items() if c > 0}
    idx = sorted(buckets)

    def pct(q: float) -> float:
        rank = q / 100.0 * (count - 1)
        seen = 0
        for b in idx:
            seen += buckets[b]
            if seen > rank:
                return _bucket_value(b)
        return _bucket_value(idx[-1])

    return dict(n=count, sum=total, mean=total / count,
                min=_bucket_value(idx[0]), max=_bucket_value(idx[-1]),
                p50=pct(50), p99=pct(99))


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


def _label_str(key: tuple) -> str:
    name, labels = key
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class MetricsRegistry:
    """Create-on-first-use instrument store, thread-safe, JSON-exportable."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}

    def _get(self, store: dict, cls, name: str, labels: dict):
        key = _key(name, labels)
        inst = store.get(key)
        if inst is None:
            with self._lock:
                inst = store.setdefault(key, cls())
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    # -- reading back ---------------------------------------------------------
    def counter_value(self, name: str, **labels) -> int:
        """Current count, 0 if the counter was never touched (no create)."""
        inst = self._counters.get(_key(name, labels))
        return inst.value if inst is not None else 0

    def gauge_value(self, name: str, default: float = 0.0, **labels) -> float:
        inst = self._gauges.get(_key(name, labels))
        return inst.value if inst is not None else default

    def values(self, name: str) -> dict:
        """All label-variants of one counter name -> {labels tuple: value}."""
        with self._lock:
            keys = [k for k in self._counters if k[0] == name]
        return {k[1]: self._counters[k].value for k in keys}

    def gauges_with_prefix(self, prefix: str) -> dict:
        """Gauge readbacks by name prefix — e.g. observed selectivities."""
        with self._lock:
            keys = [k for k in self._gauges if k[0].startswith(prefix)]
        return {_label_str(k): self._gauges[k].value for k in keys}

    def snapshot(self) -> dict:
        """One JSON-ready dict of every instrument (the export surface)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {_label_str(k): c.value for k, c in
                         sorted(counters.items())},
            "gauges": {_label_str(k): g.value for k, g in
                       sorted(gauges.items())},
            "histograms": {_label_str(k): h.summary() for k, h in
                           sorted(histograms.items())},
        }

    def mergeable_snapshot(self, process: str = "0") -> dict:
        """One process's share of a FLEET snapshot, in mergeable form.

        Unlike :meth:`snapshot` (human-oriented: flattened label strings,
        lossy histogram summaries), this keeps labels structured and
        histograms as raw log-bucket states so :mod:`repro.obs.aggregate`
        can combine any number of processes losslessly: counters sum,
        gauges get a ``process`` label, histogram sketches merge
        bucket-wise.  ``growth_log`` stamps the bucket geometry — the
        aggregator refuses to merge snapshots whose sketches use different
        bucket boundaries (or a different schema version).
        """
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)

        def entry(key, **rest):
            name, labels = key
            return dict(name=name, labels={k: str(v) for k, v in labels},
                        **rest)

        hists = []
        for k, h in sorted(histograms.items()):
            st = h.state()
            hists.append(entry(
                k, buckets={str(b): c for b, c in sorted(st["buckets"].items())},
                count=st["count"], sum=st["sum"],
                min=st["min"] if st["count"] else None,
                max=st["max"] if st["count"] else None))
        return {
            "schema": SNAPSHOT_SCHEMA_VERSION,
            "growth_log": _GROWTH_LOG,
            "process": str(process),
            "counters": [entry(k, value=c.value)
                         for k, c in sorted(counters.items())],
            "gauges": [entry(k, value=g.value)
                       for k, g in sorted(gauges.items())],
            "histograms": hists,
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


#: Process-wide default registry: engine/shard flush timings, device
#: transfer accounting, kernel pass counts, planner selectivities.
REGISTRY = MetricsRegistry()

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "SNAPSHOT_SCHEMA_VERSION", "merge_states", "summarize_state",
           "window_summary"]
