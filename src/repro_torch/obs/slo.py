"""Windowed telemetry rollups + SLO burn-rate monitoring (control plane).

Raw counters and histogram sketches only say "what happened since the
process started"; operating a serving fleet needs *rates* ("how many
requests are we shedding per second, right now?") and *error budgets*
("at this miss rate, how fast are we burning the SLO?").  This module
closes that gap — and closes the loop:

:class:`TelemetryRollup`
    A sampler (optionally a daemon thread) that ticks a
    :class:`~repro_torch.obs.metrics.MetricsRegistry` into a bounded timeline of
    points.  Each tick diffs monitored counters into per-second rates
    (published back as ``rate/<name>`` gauges, so arrival / shed /
    deadline-miss rates are first-class series in every snapshot), windows
    monitored histograms through
    :func:`~repro_torch.obs.metrics.window_summary` (published as
    ``rollup/<name>/p50|p99|n`` gauges), samples the
    :class:`~repro_torch.obs.ledger.ResourceLedger` for device-byte gauges, and
    feeds the :class:`SLOMonitor`.

:class:`SLO` / :class:`SLOMonitor`
    An SLO declares an error budget: "at most ``objective`` of events may
    be bad".  Badness is either a counter ratio (deadline misses /
    submissions; stale serves / oks) or a latency-threshold exceedance
    read from the histogram sketch's bucket diff (fraction of requests
    slower than ``threshold_s``).  The monitor computes **burn rates** —
    observed bad fraction / objective — over a fast and a slow window of
    rollup ticks; sustained burn over both windows escalates
    ``ok -> warn -> page``, and the fast window's recovery de-escalates.
    State lives in ``slo/state{slo=}`` gauges and every overall transition
    invokes registered callbacks.

The serving runtime (:meth:`repro_torch.serving.runtime.ServingRuntime.
enable_slo_control`) registers a callback that tightens its admission
bound and widens its batch window on ``warn``/``page`` and restores them
on recovery — load shedding driven by the error budget itself rather than
by a static queue size.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from repro_torch.obs.metrics import REGISTRY, _bucket_value, window_summary

_STATES = ("ok", "warn", "page")
_RANK = {s: i for i, s in enumerate(_STATES)}


def _spec(name: str, **labels) -> tuple:
    """Hashable (name, ((k, v), ...)) instrument spec."""
    return (name, tuple(sorted(labels.items())))


#: Counters every rollup rates by default (the serving arrival/outcome set).
DEFAULT_RATE_COUNTERS = (
    _spec("serving/submitted"),
    _spec("serving/outcomes", status="ok"),
    _spec("serving/outcomes", status="shed"),
    _spec("serving/outcomes", status="deadline"),
    _spec("serving/retries"),
    _spec("serving/stale_served"),
)

#: Histograms every rollup windows by default.
DEFAULT_WINDOW_HISTS = (
    _spec("serving/latency_s", status="ok"),
)


@dataclass(frozen=True)
class SLO:
    """One service-level objective: "at most ``objective`` of events bad".

    ``kind="ratio"``: bad fraction = Δ``num`` / Δ``den`` counter diffs.
    ``kind="latency"``: bad fraction = share of Δ``hist`` observations
    whose bucket value exceeds ``threshold_s``.
    """

    name: str
    objective: float  # allowed bad fraction of events (error budget)
    kind: str = "ratio"  # "ratio" | "latency"
    num: tuple = ()  # counter spec (ratio kind)
    den: tuple = ()  # counter spec (ratio kind)
    hist: tuple = ()  # histogram spec (latency kind)
    threshold_s: float = 0.0  # latency threshold (latency kind)


def default_serving_slos(latency_threshold_s: float = 0.1,
                         latency_objective: float = 0.05,
                         miss_objective: float = 0.02,
                         stale_objective: float = 0.10) -> tuple:
    """The serving runtime's stock SLO set: p-latency, deadline-miss
    rate, staleness — the three the runtime's control loop acts on."""
    return (
        SLO(name="latency", kind="latency", objective=latency_objective,
            hist=_spec("serving/latency_s", status="ok"),
            threshold_s=latency_threshold_s),
        SLO(name="deadline_miss", objective=miss_objective,
            num=_spec("serving/outcomes", status="deadline"),
            den=_spec("serving/submitted")),
        SLO(name="staleness", objective=stale_objective,
            num=_spec("serving/stale_served"),
            den=_spec("serving/outcomes", status="ok")),
    )


class SLOMonitor:
    """Multi-window error-budget burn rates + ok/warn/page state machine.

    Reads points from a :class:`TelemetryRollup` timeline (it never
    touches the registry's instruments directly, so one collection pass
    serves both rates and burn rates).  Per SLO and per window::

        burn = (bad events / total events) / objective

    ``burn == 1.0`` means "bad at exactly the budgeted rate"; sustained
    ``burn >= page_burn`` over BOTH the fast and the slow window pages.
    Using ``min(fast, slow)`` makes escalation require a sustained burn
    (a single hiccup moves only the fast window) and de-escalation track
    the fast window (recovery is visible immediately).
    """

    def __init__(self, slos, fast_window: int = 3, slow_window: int = 12,
                 warn_burn: float = 1.0, page_burn: float = 2.0,
                 min_events: int = 8, registry=None):
        self.slos = tuple(slos)
        self.fast_window = int(fast_window)
        self.slow_window = int(slow_window)
        self.warn_burn = float(warn_burn)
        self.page_burn = float(page_burn)
        self.min_events = int(min_events)
        self.registry = registry if registry is not None else REGISTRY
        self.state = "ok"
        self.detail: dict = {}
        self._cbs: list = []

    def on_transition(self, cb) -> None:
        """``cb(new_state, detail)`` fires on every OVERALL state change."""
        self._cbs.append(cb)

    def counter_specs(self) -> tuple:
        return tuple(s for slo in self.slos for s in (slo.num, slo.den) if s)

    def hist_specs(self) -> tuple:
        return tuple(slo.hist for slo in self.slos if slo.hist)

    # -- burn math -----------------------------------------------------------
    def _bad_fraction(self, slo: SLO, a: dict, b: dict):
        """Bad fraction of events between timeline points a -> b, or None
        when the window holds too few events to mean anything."""
        if slo.kind == "ratio":
            den = b["counters"].get(slo.den, 0) - a["counters"].get(slo.den, 0)
            if den < self.min_events:
                return None
            num = b["counters"].get(slo.num, 0) - a["counters"].get(slo.num, 0)
            return num / den
        sa = a["hists"].get(slo.hist, {"buckets": {}, "count": 0})
        sb = b["hists"].get(slo.hist, {"buckets": {}, "count": 0})
        total = sb["count"] - sa["count"]
        if total < self.min_events:
            return None
        over = sum(
            c - sa["buckets"].get(bk, 0)
            for bk, c in sb["buckets"].items()
            if c > sa["buckets"].get(bk, 0)
            and _bucket_value(bk) > slo.threshold_s)
        return over / total

    def _window_burn(self, slo: SLO, timeline, n: int):
        if len(timeline) < 2:
            return None
        a = timeline[max(0, len(timeline) - 1 - n)]
        frac = self._bad_fraction(slo, a, timeline[-1])
        if frac is None:
            return None
        return frac / max(slo.objective, 1e-12)

    def observe(self, timeline) -> str:
        """One evaluation pass over the rollup timeline; returns state."""
        detail = {}
        worst = "ok"
        for slo in self.slos:
            fast = self._window_burn(slo, timeline, self.fast_window)
            slow = self._window_burn(slo, timeline, self.slow_window)
            sustained = min(fast or 0.0, slow or 0.0)
            if sustained >= self.page_burn:
                state = "page"
            elif sustained >= self.warn_burn:
                state = "warn"
            else:
                state = "ok"
            detail[slo.name] = {"fast": fast, "slow": slow, "state": state}
            self.registry.gauge("slo/burn_rate", slo=slo.name,
                                window="fast").set(fast or 0.0)
            self.registry.gauge("slo/burn_rate", slo=slo.name,
                                window="slow").set(slow or 0.0)
            self.registry.gauge("slo/state", slo=slo.name).set(_RANK[state])
            if _RANK[state] > _RANK[worst]:
                worst = state
        self.detail = detail
        self.registry.gauge("slo/state_overall").set(_RANK[worst])
        if worst != self.state:
            prev, self.state = self.state, worst
            self.registry.counter("slo/transitions", frm=prev,
                                  to=worst).inc()
            for cb in self._cbs:
                cb(worst, detail)
        return self.state


class TelemetryRollup:
    """Bounded-timeline sampler: counters -> rates, histograms -> windows.

    ``tick()`` is safe to call directly (tests and benches drive the loop
    synchronously); ``start()`` runs it on a daemon thread every
    ``interval_s``.  The timeline is a deque of points::

        {"t": monotonic, "counters": {spec: value},
         "hists": {spec: state}, "rates": {spec: per_second}}

    bounded at ``maxlen`` — long-running deployments hold O(maxlen)
    reporting state no matter the request volume.
    """

    def __init__(self, registry=None, interval_s: float = 0.25,
                 maxlen: int = 240, ledger=None, monitor: SLOMonitor = None,
                 rate_counters=DEFAULT_RATE_COUNTERS,
                 window_hists=DEFAULT_WINDOW_HISTS):
        self.registry = registry if registry is not None else REGISTRY
        self.interval_s = float(interval_s)
        self.ledger = ledger
        self.monitor = monitor
        rate_counters = tuple(rate_counters)
        window_hists = tuple(window_hists)
        if monitor is not None:  # one collection pass serves the monitor too
            rate_counters = tuple(dict.fromkeys(
                rate_counters + monitor.counter_specs()))
            window_hists = tuple(dict.fromkeys(
                window_hists + monitor.hist_specs()))
        self.rate_counters = rate_counters
        self.window_hists = window_hists
        self.timeline: deque = deque(maxlen=maxlen)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def tick(self) -> dict:
        """One sample: collect, publish rate/rollup gauges, feed monitor."""
        reg = self.registry
        point = {
            "t": time.monotonic(),
            "counters": {s: reg.counter_value(s[0], **dict(s[1]))
                         for s in self.rate_counters},
            "hists": {s: reg.histogram(s[0], **dict(s[1])).state()
                      for s in self.window_hists},
            "rates": {},
        }
        if self.timeline:
            prev = self.timeline[-1]
            dt = max(point["t"] - prev["t"], 1e-9)
            for s in self.rate_counters:
                rate = (point["counters"][s]
                        - prev["counters"].get(s, 0)) / dt
                point["rates"][s] = rate
                reg.gauge("rate/" + s[0], **dict(s[1])).set(rate)
            for s in self.window_hists:
                w = window_summary(reg.histogram(s[0], **dict(s[1])),
                                   prev["hists"].get(
                                       s, {"buckets": {}, "count": 0,
                                           "sum": 0.0}))
                labels = dict(s[1])
                reg.gauge(f"rollup/{s[0]}/n", **labels).set(w.get("n", 0))
                if w.get("n"):
                    reg.gauge(f"rollup/{s[0]}/p50",
                              **labels).set(w["p50"])
                    reg.gauge(f"rollup/{s[0]}/p99",
                              **labels).set(w["p99"])
        self.timeline.append(point)
        if self.ledger is not None:
            self.ledger.sample()
        if self.monitor is not None:
            self.monitor.observe(self.timeline)
        return point

    def rate_series(self, name: str, **labels) -> list:
        """First-class rate series: [(t, per_second), ...] for one counter."""
        s = _spec(name, **labels)
        return [(p["t"], p["rates"][s]) for p in self.timeline
                if s in p["rates"]]

    # -- thread --------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — telemetry must not crash
                self.registry.counter("rollup/tick_errors").inc()

    def start(self) -> "TelemetryRollup":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="telemetry-rollup", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None


__all__ = ["SLO", "SLOMonitor", "TelemetryRollup", "default_serving_slos",
           "DEFAULT_RATE_COUNTERS", "DEFAULT_WINDOW_HISTS"]
