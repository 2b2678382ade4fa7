"""Span-based request tracing with contextvar propagation.

One :class:`Trace` per served request, identified by a ``trace_id`` minted
at ``ServingRuntime.submit`` and carried on the request object into the
worker thread.  Inside the worker, :class:`activate` roots the trace in a
``contextvars.ContextVar`` so every layer below — snapshot pin, plan-cache
lookup, executable dispatch, shard_map fallback — can open child spans
with plain ``with span("pin"):`` blocks and land under the right parent
without plumbing ids through call signatures.

The design mirrors ``repro.testing.faults``: instrumentation is a
module-level context slot that is empty by default, and :func:`span` is a
shared no-op context manager when nothing is active.  Instrumented code
pays one contextvar read + one ``is None`` test per call site when
tracing is off — that is what keeps the <3% overhead gate honest.

Span shape (see obs/export.py for the JSON schema):

    name        e.g. "request", "queue", "attempt", "pin", "execute"
    span_id / parent_id   ids local to the trace; exactly one root (-1)
    t0 / t1     perf_counter seconds relative to the tracer epoch
    attrs       set at open or via set_attr() (e.g. stale=True, path=...)
    events      point-in-time markers appended with event()

Finished traces land in a bounded ring on the :class:`Tracer` (oldest
dropped, drop count kept) so long benches can't grow memory unbounded.
"""
from __future__ import annotations

import contextvars
import threading
import time
from dataclasses import dataclass, field

# Current span for this thread/context; None = tracing off here.
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_obs_span", default=None)


@dataclass
class Span:
    trace: "Trace"
    span_id: int
    parent_id: int  # -1 for the root
    name: str
    t0: float
    t1: float = -1.0
    attrs: dict = field(default_factory=dict)
    events: list = field(default_factory=list)

    def set_attr(self, **kv) -> None:
        self.attrs.update(kv)

    def add_event(self, name: str, **attrs) -> None:
        ev = {"name": name, "t": self.trace.tracer.now()}
        if attrs:
            ev["attrs"] = attrs
        self.events.append(ev)

    def finish(self) -> None:
        if self.t1 < 0:
            self.t1 = self.trace.tracer.now()

    @property
    def duration_s(self) -> float:
        return max((self.t1 if self.t1 >= 0 else self.t0) - self.t0, 0.0)

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t0": self.t0,
            "t1": self.t1 if self.t1 >= 0 else self.t0,
            "attrs": dict(self.attrs),
            "events": list(self.events),
        }


class Trace:
    """All spans of one request; the root span is spans[0]."""

    __slots__ = ("tracer", "trace_id", "spans", "_lock", "_next_id")

    def __init__(self, tracer: "Tracer", trace_id: str):
        self.tracer = tracer
        self.trace_id = trace_id
        self.spans: list = []
        self._lock = threading.Lock()
        self._next_id = 0

    def new_span(self, name: str, parent_id: int, attrs: dict) -> Span:
        t0 = self.tracer.now()
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            sp = Span(self, sid, parent_id, name, t0, attrs=dict(attrs))
            self.spans.append(sp)
        return sp

    @property
    def root(self) -> Span:
        return self.spans[0]

    def find(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def to_dict(self) -> dict:
        with self._lock:
            spans = [s.to_dict() for s in self.spans]
        return {"trace_id": self.trace_id, "spans": spans}


class Tracer:
    """Mints traces; collects finished ones in a bounded ring."""

    def __init__(self, max_traces: int = 4096):
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._seq = 0
        self.max_traces = max_traces
        self._finished: list = []
        self.dropped = 0

    def now(self) -> float:
        return time.perf_counter() - self._epoch

    def new_trace(self, kind: str = "req") -> Trace:
        with self._lock:
            self._seq += 1
            seq = self._seq
        return Trace(self, f"{kind}-{seq:06d}")

    def start_root(self, trace: Trace, name: str, **attrs) -> Span:
        return trace.new_span(name, -1, attrs)

    def finish_trace(self, trace: Trace) -> None:
        for sp in list(trace.spans):
            if sp.t1 < 0 and sp.parent_id != -1:
                # a non-root span nobody closed — a lifecycle leak in the
                # instrumented code.  Closing it here keeps the export
                # parseable, but the leak is MARKED so validate_trace can
                # reject the trace instead of silently papering over it.
                sp.set_attr(dangling=True)
            sp.finish()
        with self._lock:
            self._finished.append(trace)
            if len(self._finished) > self.max_traces:
                drop = len(self._finished) - self.max_traces
                del self._finished[:drop]
                self.dropped += drop

    def finished_traces(self) -> list:
        with self._lock:
            return list(self._finished)

    def to_dicts(self) -> list:
        return [t.to_dict() for t in self.finished_traces()]


class _ActiveSpan:
    """Opens a child span as the contextvar current; restores on exit."""

    __slots__ = ("span", "_token")

    def __init__(self, span: Span):
        self.span = span
        self._token = None

    def __enter__(self) -> Span:
        self._token = _CURRENT.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.span.set_attr(error=f"{exc_type.__name__}: {exc}")
        self.span.finish()
        _CURRENT.reset(self._token)


class _NoopSpan:
    """Shared do-nothing span: the off-path cost of instrumentation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set_attr(self, **kv):
        pass

    def add_event(self, name, **attrs):
        pass


_NOOP = _NoopSpan()


def span(name: str, **attrs):
    """Open a child span under the current one; no-op when tracing is off.

    Usage at every instrumented call site::

        with obs_trace.span("pin", version=v) as sp:
            ...
            sp.set_attr(stale=True)
    """
    cur = _CURRENT.get()
    if cur is None:
        return _NOOP
    return _ActiveSpan(cur.trace.new_span(name, cur.span_id, attrs))


def event(name: str, **attrs) -> None:
    """Append a point-in-time event to the current span (no-op when off)."""
    cur = _CURRENT.get()
    if cur is not None:
        cur.add_event(name, **attrs)


def current_span():
    """The active Span, or None when tracing is off in this context."""
    return _CURRENT.get()


class activate:
    """Root a span in this thread/context: ``with activate(root): ...``.

    The serving worker uses this to re-home the request's trace (minted
    on the submitting thread) into its own context so spans opened
    anywhere down-stack parent correctly.  Passing ``None`` is a no-op
    activation (tracing stays off inside the block).
    """

    __slots__ = ("_root", "_token")

    def __init__(self, root):
        self._root = root
        self._token = None

    def __enter__(self):
        if self._root is not None:
            self._token = _CURRENT.set(self._root)
        return self._root

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _CURRENT.reset(self._token)


__all__ = ["Span", "Trace", "Tracer", "span", "event", "current_span",
           "activate"]
