"""Request runtime: deadlines, admission control, retries, degradation,
micro-batching, pagination.

This is the layer between clients and the MVCC substrate
(core/snapshot.py).  Every read executes against a **pinned snapshot** —
writers (``insert`` / ``delete`` / ``compact`` on the runtime) mutate the
live store under its write lock and publish the new version when done — so
a burst of concurrent readers racing a background update stream each see
one consistent version end to end.

Request lifecycle (the degradation ladder, best outcome first):

  1. **ok** — admitted, pinned, answered before its deadline.  The outcome
     carries ``version`` (what the answer is consistent with) and
     ``stale=True`` when the pin was degraded (a writer held the flush
     lock past the pin timeout, so the *last published* version served).
  2. **retry** — a transient failure (:class:`~repro_torch.testing.faults.FaultError`
     — injected churn, a device hiccup) inside the attempt is retried with
     jittered exponential backoff while the deadline allows.
  3. **deadline** — admitted but out of time (before or during execution).
  4. **error** — a non-transient failure; reported, never raised into the
     worker loop.
  5. **shed** — the bounded admission queue is full; the request is
     rejected *at submit time* (backpressure), before consuming any
     execution resources.

Micro-batching: a worker that dequeues a request keeps draining the
admission queue — up to ``max_batch`` requests or for ``batch_window_s`` —
and executes same-kind requests as ONE batched dispatch: pattern queries
ride the engine's batched
:meth:`~repro_torch.core.query.QueryEngine.run_batch` (requests whose
patterns lower to the same signature tuple share one batched plan body —
one launch per compaction for all of them — capacities sized from
``observed_selectivity``), and ``class_members`` / ``class_prop_join``
requests concatenate into the
:class:`~repro_torch.serving.engine.QueryServer` batched plans.  The
default window is 0 (drain-only): sparse traffic pays zero added latency
and batches only form under concurrent load.  Every member of a batch
carries its OWN Outcome — deadline checks, fault injection
(``serving.execute``), version/stale tags and trace spans stay
per-request, and a member that faults is retried alone without poisoning
its batchmates (a whole-batch failure degrades every member to the solo
retry ladder).

Pagination: ``submit(..., page_size=N)`` answers with the first N rows of
a STABLE total order (sorted result tuples at the pinned version) plus an
opaque :class:`Cursor`; submitting with ``cursor=`` re-pins that exact
version so page K+1 continues where page K stopped.  When the version has
been retired between pages the runtime degrades to a fresh pin and tags
the outcome ``stale=True`` instead of erroring.  Paginated outcomes carry
``answers`` as an ORDERED list of rows plus ``total``.

Observability: every counter/histogram lands in a per-runtime
:class:`~repro_torch.obs.metrics.MetricsRegistry` (``rt.metrics``) — ``stats``
is a read-only dict view over it, and
``latency_stats`` is derived from the bounded ``serving/latency_s``
histogram sketch (nothing in the runtime grows per-request anymore).
Pass a :class:`~repro_torch.obs.trace.Tracer` to record one span tree per
request (queue wait, per-attempt pin / execute / backoff,
stale-degradation events; batched members get ``batched=True`` +
``batch_size`` attrs); ``Outcome.trace_id`` links the result back to its
trace.  ``Outcome.latency_s`` splits into ``queue_s`` (admission-queue
wait) + ``exec_s`` (service time); the two always sum to ``latency_s``.

SLO control plane: :meth:`ServingRuntime.enable_slo_control` closes the
loop — a :class:`~repro_torch.obs.slo.TelemetryRollup` thread turns the
runtime's counters into rates and windows, samples the device-memory
ledger, and feeds an :class:`~repro_torch.obs.slo.SLOMonitor` whose
burn-rate transitions lower ``admission_bound`` and widen
``batch_window_s`` under sustained budget burn, and restore both on
recovery.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.snapshot import SnapshotRegistry
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.ledger import LEDGER
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.slo import (SLOMonitor, TelemetryRollup,
                                 default_serving_slos)
from repro_torch.testing import faults
from repro_torch.testing.faults import FaultError

_STOP = object()  # worker-loop sentinel


@dataclass(frozen=True)
class Cursor:
    """Opaque continuation token for paginated reads.

    ``version`` names the pinned snapshot the total order was computed
    against; ``offset`` is where the next page starts in that order.  The
    token is immutable and printable — clients hold it between pages, the
    runtime re-pins ``version`` on continuation.
    """

    version: int
    offset: int
    page_size: int


@dataclass
class Outcome:
    """What the runtime resolves a request's Future to (never an exception)."""

    status: str  # "ok" | "shed" | "deadline" | "error"
    answers: object = None  # set of rows; ordered list when paginated;
    #                         (counts, members) arrays for server kinds
    version: int | None = None  # store version the answer is consistent with
    stale: bool = False  # True: degraded pin served the last published version
    retries: int = 0
    latency_s: float = 0.0  # == queue_s + exec_s
    queue_s: float = 0.0  # admission-queue wait (submit -> worker dequeue)
    exec_s: float = 0.0  # service time (dequeue -> resolution)
    error: str | None = None
    trace_id: str | None = None  # set when the runtime has a Tracer
    cursor: Cursor | None = None  # continuation for the NEXT page (paginated)
    total: int | None = None  # full result count at the pinned version

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclass
class _Request:
    patterns: list
    select: object
    mode: str | None
    deadline_t: float | None  # absolute monotonic deadline (None: unbounded)
    submitted_t: float
    kind: str = "query"  # "query" | "members" | "prop_join"
    args: tuple = ()  # server-kind request payload (name lists)
    page_size: int | None = None  # first-page request when set
    cursor: Cursor | None = None  # continuation request when set
    future: Future = field(default_factory=Future)
    dequeue_t: float | None = None
    trace: object = None  # obs_trace.Trace when the runtime traces
    root: object = None  # the "request" root span
    queue_span: object = None


class ServingRuntime:
    """Thread-pooled snapshot-isolated serving over one KnowledgeBase.

    >>> rt = ServingRuntime(K, modes=("litemat", "rewrite"))
    >>> with rt:
    ...     out = rt.serve(PAPER_QUERIES["Q3"])          # sync
    ...     fut = rt.submit(PAPER_QUERIES["Q1"])          # async
    ...     page = rt.serve(PAPER_QUERIES["Q1"], page_size=10)  # paginated
    ...     rest = rt.serve(PAPER_QUERIES["Q1"], cursor=page.cursor)
    ...     rt.insert(more_triples)                       # publishes new version
    ...     assert fut.result().ok
    """

    def __init__(self, kb, modes=("litemat",), use_index: bool = True,
                 n_workers: int = 2, max_queue: int = 64,
                 default_deadline_s: float | None = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.005,
                 retry_backoff_cap_s: float = 0.1,
                 pin_lock_timeout_s: float = 0.05, seed: int = 0,
                 batch_window_s: float = 0.0, max_batch: int = 16,
                 server_topk: int = 32,
                 tracer: obs_trace.Tracer | None = None,
                 metrics: MetricsRegistry | None = None):
        self.kb = kb
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer
        self.registry = SnapshotRegistry(
            kb, modes=modes, use_index=use_index,
            lock_timeout_s=pin_lock_timeout_s, metrics=self.metrics)
        self.n_workers = n_workers
        self.default_deadline_s = default_deadline_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_cap_s = retry_backoff_cap_s
        # micro-batching: a dequeuing worker drains up to max_batch peers,
        # waiting at most batch_window_s for stragglers (0 = drain-only:
        # coalesce what is already queued, never delay a lone request)
        self.batch_window_s = batch_window_s
        self.max_batch = max_batch
        self.server_topk = server_topk
        self.max_queue = max_queue
        # SLO-driven soft admission bound: the queue's hard capacity never
        # changes, but the burn-rate monitor can lower this to shed
        # earlier under sustained budget burn (enable_slo_control)
        self.admission_bound = max_queue
        self._batch_window_s0 = batch_window_s
        self._slo_state = "ok"
        self._slo_monitor = None
        self._slo_rollup = None
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._workers: list = []
        self._started = False
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        # QueryServer is NOT safe under concurrent callers (atomic view
        # resync); all server-kind execution serializes here
        self._server_lock = threading.Lock()
        self._server = None

    @property
    def stats(self) -> dict:
        """The counter dict, a read-only registry view."""
        m = self.metrics
        return {
            "submitted": m.counter_value("serving/submitted"),
            "ok": m.counter_value("serving/outcomes", status="ok"),
            "shed": m.counter_value("serving/outcomes", status="shed"),
            "deadline": m.counter_value("serving/outcomes",
                                        status="deadline"),
            "errors": m.counter_value("serving/outcomes", status="error"),
            "retries": m.counter_value("serving/retries"),
            "stale_served": m.counter_value("serving/stale_served"),
            "updates": m.counter_value("serving/updates"),
            "publish_failures": m.counter_value("serving/publish_failures"),
            "batched": m.counter_value("serving/batched"),
        }

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingRuntime":
        # check-and-set under the lock: two concurrent first submits used
        # to both see _started == False and each spawn a worker pool
        with self._lock:
            if self._started:
                return self
            self._started = True
            self.registry.publish()
            for i in range(self.n_workers):
                t = threading.Thread(target=self._worker_loop,
                                     name=f"serve-worker-{i}", daemon=True)
                t.start()
                self._workers.append(t)
        if self._slo_rollup is not None:
            self._slo_rollup.start()
        return self

    def stop(self) -> None:
        with self._lock:
            if not self._started:
                return
            workers, self._workers = self._workers, []
            self._started = False
        if self._slo_rollup is not None:
            self._slo_rollup.stop()
        for _ in workers:
            self._queue.put(_STOP)
        for t in workers:
            t.join()

    def __enter__(self) -> "ServingRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- SLO control plane ---------------------------------------------------
    def enable_slo_control(self, slos=None, interval_s: float = 0.25,
                           fast_window: int = 3, slow_window: int = 12,
                           warn_burn: float = 1.0, page_burn: float = 2.0,
                           min_events: int = 8, track_ledger: bool = True):
        """Close the telemetry loop: rollup thread + burn-rate monitor
        driving this runtime's admission bound and batch window.

        Builds a :class:`~repro_torch.obs.slo.TelemetryRollup` over
        ``self.metrics`` (sampling the process ledger each tick) and an
        :class:`~repro_torch.obs.slo.SLOMonitor` whose overall-state
        transitions call :meth:`_apply_slo_state`:

          * ``warn`` — admission bound halves, batch window >= 1 ms
            (bigger batches amortize dispatches under pressure);
          * ``page`` — admission bound quarters (floor 4): sustained
            budget burn sheds load at submit time, before execution cost;
          * ``ok`` — both knobs restore to their constructor values.

        The rollup thread starts/stops with the runtime; returns the
        monitor (``monitor.detail`` carries per-SLO burn rates).  Call
        ``self._slo_rollup.tick()`` to drive the loop synchronously
        (tests, benches).
        """
        if self._slo_monitor is not None:
            return self._slo_monitor
        ledger = None
        if track_ledger:
            self.kb.track_ledger()
            if getattr(self.registry, "_ledger_handle", None) is None:
                self.registry._ledger_handle = LEDGER.track(
                    "snapshots", self.registry)
            ledger = LEDGER
        monitor = SLOMonitor(
            slos if slos is not None else default_serving_slos(),
            fast_window=fast_window, slow_window=slow_window,
            warn_burn=warn_burn, page_burn=page_burn,
            min_events=min_events, registry=self.metrics)
        monitor.on_transition(self._apply_slo_state)
        self._slo_monitor = monitor
        self._slo_rollup = TelemetryRollup(
            self.metrics, interval_s=interval_s, ledger=ledger,
            monitor=monitor)
        if self._started:
            self._slo_rollup.start()
        return monitor

    def _apply_slo_state(self, state: str, detail=None) -> None:
        """Monitor-transition callback: retune admission + batching knobs.

        Runs on the rollup thread.  The ``slo.apply`` fault site lets the
        harness fail the CONTROL plane: a faulted apply keeps the previous
        knobs (the data plane keeps serving) and the next transition
        retries.  Every applied transition lands as a counter, gauge
        updates, and — when the runtime traces — a single-span
        ``slo_transition`` trace, so the timeline of the control loop is
        reconstructable from the trace export alone.
        """
        prev = self._slo_state
        try:
            faults.fire("slo.apply", state=state)
        except FaultError as e:
            self.metrics.counter("slo/apply_faults").inc()
            obs_trace.event("slo_apply_fault", state=state,
                            error=f"{type(e).__name__}: {e}")
            return
        if state == "page":
            self.admission_bound = max(4, self.max_queue // 4)
            self.batch_window_s = max(self._batch_window_s0, 0.002)
        elif state == "warn":
            self.admission_bound = max(8, self.max_queue // 2)
            self.batch_window_s = max(self._batch_window_s0, 0.001)
        else:
            self.admission_bound = self.max_queue
            self.batch_window_s = self._batch_window_s0
        self._slo_state = state
        self.metrics.counter("slo/applied", frm=prev, to=state).inc()
        self.metrics.gauge("serving/admission_bound").set(
            self.admission_bound)
        self.metrics.gauge("serving/batch_window_s").set(
            self.batch_window_s)
        if self.tracer is not None:
            tr = self.tracer.new_trace()
            root = self.tracer.start_root(
                tr, "slo_transition", frm=prev, to=state,
                admission_bound=self.admission_bound,
                batch_window_s=self.batch_window_s)
            root.finish()
            self.tracer.finish_trace(tr)

    # -- read path -----------------------------------------------------------
    def submit(self, patterns, select=None, mode: str | None = None,
               deadline_s: float | None = None,
               page_size: int | None = None,
               cursor: Cursor | None = None) -> Future:
        """Admit a query (or shed it) and return a Future[Outcome].

        The Future always resolves to an :class:`Outcome` — shed and
        failed requests report through ``status``, they never raise.
        ``page_size`` asks for the first page of a stable-order result
        (the outcome carries ``cursor`` for the next one); ``cursor``
        continues a previous page at its pinned version.
        """
        req = _Request(
            patterns=list(patterns), select=select, mode=mode,
            deadline_t=None, submitted_t=0.0,
            page_size=page_size if cursor is None else None, cursor=cursor)
        return self._admit(req, deadline_s)

    def serve(self, patterns, select=None, mode: str | None = None,
              deadline_s: float | None = None,
              page_size: int | None = None,
              cursor: Cursor | None = None) -> Outcome:
        """Synchronous submit: blocks for this request's Outcome."""
        return self.submit(patterns, select=select, mode=mode,
                           deadline_s=deadline_s, page_size=page_size,
                           cursor=cursor).result()

    def submit_class_members(self, class_names,
                             deadline_s: float | None = None) -> Future:
        """Admit a batched Q1-style server request: per-class distinct
        member counts + smallest-topk member ids.  The outcome's
        ``answers`` is ``(counts, members)`` aligned with ``class_names``.
        """
        req = _Request(patterns=[], select=None, mode=None, deadline_t=None,
                       submitted_t=0.0, kind="members",
                       args=(list(class_names),))
        return self._admit(req, deadline_s)

    def class_members(self, class_names,
                      deadline_s: float | None = None) -> Outcome:
        return self.submit_class_members(class_names,
                                         deadline_s=deadline_s).result()

    def submit_class_prop_join(self, class_names, prop_names,
                               deadline_s: float | None = None) -> Future:
        """Admit a batched Q3-style server request (x:C ⋈ (x p y))."""
        req = _Request(patterns=[], select=None, mode=None, deadline_t=None,
                       submitted_t=0.0, kind="prop_join",
                       args=(list(class_names), list(prop_names)))
        return self._admit(req, deadline_s)

    def class_prop_join(self, class_names, prop_names,
                        deadline_s: float | None = None) -> Outcome:
        return self.submit_class_prop_join(
            class_names, prop_names, deadline_s=deadline_s).result()

    def _admit(self, req: _Request, deadline_s: float | None) -> Future:
        if not self._started:
            self.start()
        now = time.monotonic()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req.submitted_t = now
        req.deadline_t = None if deadline_s is None else now + deadline_s
        self.metrics.counter("serving/submitted").inc()
        if self.tracer is not None:
            req.trace = self.tracer.new_trace()
            req.root = self.tracer.start_root(
                req.trace, "request", n_patterns=len(req.patterns),
                mode=req.mode or "default", kind=req.kind)
            req.queue_span = req.trace.new_span("queue", req.root.span_id, {})
        try:
            if self._queue.qsize() >= self.admission_bound:
                raise queue.Full  # SLO-tightened soft bound: shed early
            self._queue.put_nowait(req)
            self.metrics.gauge("serving/queue_depth").set(
                self._queue.qsize())
        except queue.Full:
            # backpressure: reject at admission, before any execution cost
            lat = time.monotonic() - now
            if req.queue_span is not None:
                # the request dies in the queue, but its queue span must
                # still close — an open span in a finished trace is a leak
                # the validator now rejects
                req.queue_span.finish()
            out = Outcome(status="shed", latency_s=lat, queue_s=lat)
            self._finish(req, out)
        return req.future

    # -- write path ----------------------------------------------------------
    def _write(self, op, *a, **kw) -> dict:
        with self.kb.write_lock:
            stats = op(*a, **kw)
            try:
                self.registry.publish()
            except Exception:  # noqa: BLE001 — degrade, don't fail the write
                # capture crashed (e.g. mid-flush): the mutation is
                # committed but unpublished — readers keep degrading to the
                # last published snapshot (stale tag) until a later pin or
                # publish captures this version successfully
                self.metrics.counter("serving/publish_failures").inc()
        self.metrics.counter("serving/updates").inc()
        return stats

    def insert(self, raw, **kw) -> dict:
        return self._write(self.kb.insert, raw, **kw)

    def delete(self, raw, **kw) -> dict:
        return self._write(self.kb.delete, raw, **kw)

    def compact(self, **kw) -> dict:
        return self._write(self.kb.compact, **kw)

    # -- worker internals ----------------------------------------------------
    def _finish(self, req: _Request, out: Outcome) -> None:
        m = self.metrics
        m.counter("serving/outcomes", status=out.status).inc()
        if out.stale and out.ok:
            m.counter("serving/stale_served").inc()
        m.histogram("serving/latency_s", status=out.status).observe(
            out.latency_s)
        if out.status != "shed":
            m.histogram("serving/queue_s").observe(out.queue_s)
            m.histogram("serving/exec_s").observe(out.exec_s)
        if req.trace is not None:
            out.trace_id = req.trace.trace_id
            req.root.set_attr(status=out.status, retries=out.retries,
                              stale=out.stale, version=out.version)
            req.root.finish()
            self.tracer.finish_trace(req.trace)
        req.future.set_result(out)

    def _jitter(self, attempt: int) -> float:
        base = min(self.retry_backoff_cap_s,
                   self.retry_backoff_s * (2 ** attempt))
        with self._lock:
            u = float(self._rng.random())
        return base * (0.5 + 0.5 * u)

    @staticmethod
    def _batchable(req: _Request) -> bool:
        """Paginated reads pin specific versions / slice their own pages —
        they take the solo path; everything else can coalesce."""
        if req.kind != "query":
            return True
        return req.cursor is None and req.page_size is None

    def _drain_batch(self, first: _Request):
        """Coalesce queued peers behind ``first``: up to ``max_batch``
        requests, waiting at most ``batch_window_s`` for stragglers.
        Returns (batch, saw_stop); a drained _STOP retires THIS worker
        after the batch resolves (stop() enqueues one sentinel per
        worker, and each worker consumes exactly one).
        """
        first.dequeue_t = time.monotonic()
        if first.queue_span is not None:
            first.queue_span.finish()
        batch = [first]
        if self.max_batch <= 1:
            return batch, False
        deadline = first.dequeue_t + self.batch_window_s
        while len(batch) < self.max_batch:
            wait = deadline - time.monotonic()
            try:
                nxt = (self._queue.get(timeout=wait) if wait > 0
                       else self._queue.get_nowait())
            except queue.Empty:
                break
            if nxt is _STOP:
                return batch, True
            nxt.dequeue_t = time.monotonic()
            if nxt.queue_span is not None:
                nxt.queue_span.finish()
            batch.append(nxt)
        return batch, False

    def _worker_loop(self) -> None:
        while True:
            req = self._queue.get()
            if req is _STOP:
                return
            batch, saw_stop = self._drain_batch(req)
            self.metrics.gauge("serving/queue_depth").set(
                self._queue.qsize())
            self._handle_batch(batch)
            if saw_stop:
                return

    def _handle_batch(self, batch) -> None:
        """Partition one drained batch into coalescable groups + solos."""
        groups: dict = {}
        for r in batch:
            if self._batchable(r):
                groups.setdefault((r.kind, r.mode), []).append(r)
            else:
                self._run_one(r)
        for (kind, mode), grp in groups.items():
            self.metrics.histogram("serving/batch_size",
                                   kind=kind).observe(len(grp))
            if len(grp) == 1:
                self._run_one(grp[0])
            elif kind == "query":
                self._execute_query_batch(grp, mode)
            else:
                self._execute_server_batch(grp, kind)

    def _run_one(self, req: _Request) -> None:
        """The solo path: full retry ladder, exact per-request spans."""
        with obs_trace.activate(req.root):
            try:
                out = self._execute(req)
            except Exception as e:  # noqa: BLE001 — workers must survive
                out = self._outcome(req, "error",
                                    error=f"{type(e).__name__}: {e}")
        self._finish(req, out)

    def _gate_members(self, reqs, batch_size: int):
        """Per-member admission to a shared dispatch: deadline check +
        fault-injection gate.  A member that faults here retries ALONE
        through the solo ladder — its batchmates proceed untouched."""
        ready = []
        for r in reqs:
            if self._time_left(r) <= 0:
                self._finish(r, self._outcome(r, "deadline"))
                continue
            try:
                faults.fire("serving.execute", attempt=0,
                            batch=batch_size)
            except FaultError:
                self.metrics.counter("serving/batch_fallback",
                                     reason="member_fault").inc()
                self._run_one(r)
                continue
            ready.append(r)
        return ready

    def _member_spans(self, reqs, batch_size: int, version, stale):
        """Open attempt/execute spans for every traced batch member."""
        spans = {}
        for r in reqs:
            if r.trace is None:
                continue
            att = r.trace.new_span(
                "attempt", r.root.span_id,
                {"attempt": 0, "batched": True, "batch_size": batch_size})
            ex = r.trace.new_span(
                "execute", att.span_id, {"version": version, "stale": stale})
            spans[id(r)] = (att, ex)
        return spans

    @staticmethod
    def _close_member_spans(spans, **attrs) -> None:
        for att, ex in spans.values():
            if attrs:
                ex.set_attr(**attrs)
            ex.finish()
            att.finish()

    def _execute_query_batch(self, reqs, mode) -> None:
        """ONE pin + ONE engine-batched dispatch for same-mode queries.

        Members keep individual outcomes: deadline misses resolve before
        and after the dispatch, fault injection fires per member, and a
        whole-batch failure degrades every member to the solo retry
        ladder (nobody inherits a batchmate's error).
        """
        ready = self._gate_members(reqs, len(reqs))
        if not ready:
            return
        if len(ready) == 1:
            self._run_one(ready[0])
            return
        try:
            pin = self.registry.pin()
        except Exception as e:  # noqa: BLE001
            err = f"{type(e).__name__}: {e}"
            for r in ready:
                self._finish(r, self._outcome(r, "error", error=err))
            return
        spans = self._member_spans(ready, len(ready), pin.version, pin.stale)
        try:
            try:
                results = pin.query_batch(
                    [(r.patterns, r.select) for r in ready], mode=mode)
            except Exception:  # noqa: BLE001 — degrade, don't poison
                self._close_member_spans(spans, fallback=True)
                self.metrics.counter("serving/batch_fallback",
                                     reason="batch_error").inc()
                for r in ready:
                    self._run_one(r)
                return
            self._close_member_spans(spans)
            self.metrics.counter("serving/batched").inc(len(ready))
            # the engine fans ONE rows array to structurally identical
            # requests — build each unique answer set once and share it
            # (duplicate-heavy bursts would otherwise pay the Python set
            # construction per member, which dwarfs the dispatch itself)
            memo: dict = {}
            for r, (rows, _) in zip(ready, results):
                if self._time_left(r) < 0:
                    self._finish(r, self._outcome(r, "deadline"))
                    continue
                answers = memo.get(id(rows))
                if answers is None:
                    answers = {tuple(t) for t in rows.tolist()}
                    memo[id(rows)] = answers
                self._finish(r, self._outcome(
                    r, "ok", answers=answers, version=pin.version,
                    stale=pin.stale))
        finally:
            pin.release()

    def _server_inst(self):
        """Lazily build the QueryServer facade (server_lock held)."""
        if self._server is None:
            from repro_torch.serving.engine import QueryServer

            self._server = QueryServer(self.kb, topk=self.server_topk)
        return self._server

    def _server_call(self, kind: str, args: tuple):
        """One serialized server dispatch; returns (counts, members, version).

        The server resyncs its views to the live store version on entry
        (its own atomic ``_sync``), so the answer's version tag is the
        version the views were rebuilt at.
        """
        with self._server_lock:
            server = self._server_inst()
            if kind == "members":
                counts, members = server.class_members(args[0])
            else:
                counts, members = server.class_prop_join(args[0], args[1])
            return counts, members, server.served_version

    def _execute_server_batch(self, reqs, kind: str) -> None:
        """Concatenate same-kind server requests into ONE fan-out dispatch.

        ``class_members([A]), class_members([B, C])`` queued together
        execute as ``class_members([A, B, C])`` — one index-range
        resolution, one batched plan — then the count /
        member planes split back per request.
        """
        ready = self._gate_members(reqs, len(reqs))
        if not ready:
            return
        if len(ready) == 1:
            self._run_one(ready[0])
            return
        offsets = np.cumsum([0] + [len(r.args[0]) for r in ready])
        cat = tuple([n for r in ready for n in r.args[i]]
                    for i in range(len(ready[0].args)))
        spans = self._member_spans(ready, len(ready), None, False)
        try:
            counts, members, version = self._server_call(kind, cat)
        except Exception:  # noqa: BLE001 — degrade, don't poison
            self._close_member_spans(spans, fallback=True)
            self.metrics.counter("serving/batch_fallback",
                                 reason="batch_error").inc()
            for r in ready:
                self._run_one(r)
            return
        self._close_member_spans(spans, version=version)
        self.metrics.counter("serving/batched").inc(len(ready))
        for i, r in enumerate(ready):
            if self._time_left(r) < 0:
                self._finish(r, self._outcome(r, "deadline"))
                continue
            lo, hi = int(offsets[i]), int(offsets[i + 1])
            self._finish(r, self._outcome(
                r, "ok", answers=(counts[lo:hi], members[lo:hi]),
                version=version))

    def _time_left(self, req: _Request) -> float:
        if req.deadline_t is None:
            return float("inf")
        return req.deadline_t - time.monotonic()

    def _outcome(self, req: _Request, status: str, **kw) -> Outcome:
        """Resolve timing fields so queue_s + exec_s == latency_s exactly."""
        lat = time.monotonic() - req.submitted_t
        q = ((req.dequeue_t - req.submitted_t)
             if req.dequeue_t is not None else lat)
        return Outcome(status=status, latency_s=lat, queue_s=q,
                       exec_s=lat - q, **kw)

    def _pin_for(self, req: _Request):
        """Pin for one attempt: cursor continuations re-pin their exact
        version, degrading to a fresh pin (stale tag) when it is gone."""
        if req.cursor is None:
            return self.registry.pin(), False
        pin = self.registry.pin_version(req.cursor.version)
        if pin is not None:
            return pin, False
        # the cursor's version was retired between pages — serve the
        # current one and tell the client their iteration order broke
        obs_trace.event("cursor_version_retired",
                        version=req.cursor.version)
        return self.registry.pin(), True

    def _page(self, req: _Request, pin):
        """One stable-order page at the pinned version.

        The total order is the sorted result-tuple order — a pure
        function of the pinned version's answer set, so any worker
        computing page K+1 at the same version sees the same order page
        K was cut from.
        """
        rows, _ = pin.query(req.patterns, select=req.select, mode=req.mode)
        ordered = sorted(map(tuple, rows.tolist()))
        ps = (req.page_size if req.page_size is not None
              else req.cursor.page_size)
        off = req.cursor.offset if req.cursor is not None else 0
        page = ordered[off:off + ps]
        nxt = (Cursor(version=pin.version, offset=off + ps, page_size=ps)
               if off + ps < len(ordered) else None)
        return page, nxt, len(ordered)

    def _execute(self, req: _Request) -> Outcome:
        if req.kind != "query":
            return self._execute_server(req)
        retries = 0
        last_err: Exception | None = None
        while True:
            if self._time_left(req) <= 0:
                obs_trace.event("deadline_preempt", attempt=retries)
                return self._outcome(
                    req, "deadline", retries=retries,
                    error=None if last_err is None else
                    f"{type(last_err).__name__}: {last_err}")
            with obs_trace.span("attempt", attempt=retries) as att:
                with obs_trace.span("pin") as pin_sp:
                    pin, cursor_stale = self._pin_for(req)
                    stale = pin.stale or cursor_stale
                    pin_sp.set_attr(version=pin.version, stale=stale)
                try:
                    faults.fire("serving.execute", attempt=retries)
                    if stale:
                        obs_trace.event("stale_degraded",
                                        version=pin.version)
                    paged = (req.page_size is not None
                             or req.cursor is not None)
                    with obs_trace.span("execute", paginated=paged):
                        nxt = total = None
                        if paged:
                            answers, nxt, total = self._page(req, pin)
                        else:
                            answers = pin.answers(req.patterns,
                                                  select=req.select,
                                                  mode=req.mode)
                    if self._time_left(req) < 0:
                        # finished late: the answer is
                        # useless to a deadlined caller — report the miss
                        obs_trace.event("deadline_after_execute")
                        return self._outcome(req, "deadline",
                                             retries=retries)
                    return self._outcome(
                        req, "ok", answers=answers, version=pin.version,
                        stale=stale, retries=retries, cursor=nxt,
                        total=total)
                except FaultError as e:
                    # transient churn: back off with jitter and retry while
                    # the deadline and the retry budget allow
                    last_err = e
                    att.set_attr(fault=f"{type(e).__name__}: {e}")
                    if retries >= self.max_retries:
                        return self._outcome(
                            req, "error", retries=retries,
                            error=f"{type(e).__name__}: {e}")
                    delay = self._jitter(retries)
                    retries += 1
                    self.metrics.counter("serving/retries").inc()
                    if self._time_left(req) <= delay:
                        return self._outcome(
                            req, "deadline", retries=retries,
                            error=f"{type(e).__name__}: {e}")
                    with obs_trace.span("backoff",
                                        delay_s=round(delay, 6)):
                        time.sleep(delay)
                finally:
                    pin.release()

    def _execute_server(self, req: _Request) -> Outcome:
        """Solo retry ladder for class_members / class_prop_join requests —
        the same degradation contract as the pattern-query path."""
        retries = 0
        last_err: Exception | None = None
        while True:
            if self._time_left(req) <= 0:
                obs_trace.event("deadline_preempt", attempt=retries)
                return self._outcome(
                    req, "deadline", retries=retries,
                    error=None if last_err is None else
                    f"{type(last_err).__name__}: {last_err}")
            with obs_trace.span("attempt", attempt=retries,
                                kind=req.kind) as att:
                try:
                    faults.fire("serving.execute", attempt=retries)
                    with obs_trace.span("execute", kind=req.kind) as ex:
                        counts, members, version = self._server_call(
                            req.kind, req.args)
                        ex.set_attr(version=version)
                    if self._time_left(req) < 0:
                        obs_trace.event("deadline_after_execute")
                        return self._outcome(req, "deadline",
                                             retries=retries)
                    return self._outcome(
                        req, "ok", answers=(counts, members),
                        version=version, retries=retries)
                except FaultError as e:
                    last_err = e
                    att.set_attr(fault=f"{type(e).__name__}: {e}")
                    if retries >= self.max_retries:
                        return self._outcome(
                            req, "error", retries=retries,
                            error=f"{type(e).__name__}: {e}")
                    delay = self._jitter(retries)
                    retries += 1
                    self.metrics.counter("serving/retries").inc()
                    if self._time_left(req) <= delay:
                        return self._outcome(
                            req, "deadline", retries=retries,
                            error=f"{type(e).__name__}: {e}")
                    with obs_trace.span("backoff",
                                        delay_s=round(delay, 6)):
                        time.sleep(delay)

    # -- reporting -----------------------------------------------------------
    def latency_stats(self, status: str = "ok") -> dict:
        """p50/p99/mean latency (ms) by status, derived from the bounded
        registry histogram — the runtime no longer keeps a per-request
        list, so long-running deployments hold O(1) reporting state.
        Percentiles are the log-bucket sketch's (~4.5% resolution)."""
        s = self.metrics.histogram("serving/latency_s",
                                   status=status).summary()
        if s.get("n", 0) == 0:
            return dict(n=0)
        return dict(
            n=s["n"],
            p50_ms=float(s["p50"] * 1e3),
            p99_ms=float(s["p99"] * 1e3),
            mean_ms=float(s["mean"] * 1e3),
        )


__all__ = ["ServingRuntime", "Outcome", "Cursor"]
