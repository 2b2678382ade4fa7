"""Snapshot-isolated MVCC reads over a live (Sharded)KnowledgeBase.

``KnowledgeBase.version`` is the MVCC hook — every mutation bumps it, and
:class:`~repro_torch.core.delta.StoreView` objects are immutable snapshots
of one version (liveness masks copied at build, delta arrays append-only).
This module adds the coordination: a reader that grabs views while a writer
is mid-mutation could see a half-applied delete, and the
:class:`~repro_torch.core.delta.DeviceStoreCache`'s in-place tombstone
scatters could change a device buffer a long-running reader still reads.

  * Writers serialize through ``kb.write_lock`` (insert / delete / compact
    hold it for their whole mutate-and-bump critical section).
  * Readers **pin** a :class:`Snapshot` from the :class:`SnapshotRegistry`:
    an immutable bundle of per-mode StoreViews captured at a quiescent
    point (under the write lock), refcounted so compaction/retirement can
    never pull a pinned version out from under a running query.
  * Pinned views are flagged ``pinned=True``; the DeviceStoreCache then
    *leases* any resident buffer it hands them and copies (instead of
    scattering into) the base-alive mask on the next kill — an O(base)
    copy paid at most once per (pin, delete) pair, nothing when nothing is
    pinned.
  * ``pin()`` degrades gracefully: when a writer holds the lock past
    ``lock_timeout_s`` (or the capture itself fails — e.g. an injected
    mid-flush crash), the reader is served the **last published** snapshot
    tagged ``stale=True`` instead of blocking or erroring.

Snapshots work for both the single :class:`KnowledgeBase` and the
:class:`~repro_torch.core.shard.ShardedKB` (per-shard views, each on its
shard's device; queries run through a
:class:`~repro_torch.core.shard.ShardedQueryEngine` over per-shard engines
bound to them, the live store's paths and combines).  Query
plans live in registry-level caches shared across snapshots, so pinning
is cheap: no new plan bodies, no buffer copies, just refcounts.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.query import QueryEngine
from repro_torch.core.shard import ShardedQueryEngine, is_sharded
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.testing import faults


@dataclass
class Snapshot:
    """Immutable per-mode views of ONE published version, refcounted.

    ``views[mode]`` is a StoreView (single store) or a per-shard list
    (ShardedKB).  Engines lazily attach to the pinned views and share the
    registry's plan caches, so repeated pins of the same version — and
    fresh pins after small mutations — reuse every plan body.
    """

    version: int
    kb: object
    modes: tuple
    views: dict
    use_index: bool = True
    refs: int = 0
    _plan_caches: dict = field(default_factory=dict, repr=False)
    # PatternSig -> observed selectivity, shared across snapshots via the
    # registry so planner feedback survives version churn
    _selectivity: dict = field(default_factory=dict, repr=False)
    _engines: dict = field(default_factory=dict, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @property
    def sharded(self) -> bool:
        return is_sharded(self.kb)

    def _check_mode(self, mode: str) -> str:
        mode = mode or self.modes[0]
        if mode not in self.views:
            raise KeyError(
                f"mode {mode!r} not captured by this snapshot (captured: "
                f"{tuple(self.views)}) — pass modes=(...) to the registry")
        return mode

    def _plan_cache(self, mode: str) -> dict:
        return self._plan_caches.setdefault((mode, self.use_index), {})

    def engine(self, mode: str = None) -> QueryEngine:
        """A QueryEngine bound to this snapshot's pinned view (single store)."""
        mode = self._check_mode(mode)
        if self.sharded:
            raise ValueError("sharded snapshots query per shard — use query()")
        with self._lock:
            eng = self._engines.get(mode)
            if eng is None:
                view = self.views[mode]
                eng = QueryEngine(
                    kb=self.kb.kb, spo=view.base_rows, mode=mode,
                    dtb=self.kb.dtb, use_index=self.use_index, view=view,
                    _exec_cache=self._plan_cache(mode),
                    observed_selectivity=self._selectivity)
                self._engines[mode] = eng
            return eng

    def _sharded_engine(self, mode: str) -> ShardedQueryEngine:
        """The live store's ShardedQueryEngine over per-shard engines bound
        to this snapshot's pinned views (sharded store)."""
        with self._lock:
            eng = self._engines.get(mode)
            if eng is None:
                cache = self._plan_cache(mode)
                eng = ShardedQueryEngine(
                    skb=self.kb, mode=mode, use_index=self.use_index,
                    pinned=[QueryEngine(
                        kb=K.kb, spo=v.base_rows, mode=mode, dtb=K.dtb,
                        use_index=self.use_index, view=v, _exec_cache=cache,
                        observed_selectivity=self._selectivity)
                        for K, v in zip(self.kb.shards, self.views[mode])])
                self._engines[mode] = eng
            return eng

    def query(self, patterns, select=None, mode: str = None):
        """Evaluate against the pinned version — never the live store."""
        mode = self._check_mode(mode)
        if self.sharded:
            return self._sharded_engine(mode).run(patterns, select=select)
        return self.engine(mode).run(patterns, select=select)

    def query_batch(self, requests, mode: str = None):
        """Evaluate a batch of (patterns, select) requests at the pinned
        version with shared plan bodies; returns per-request (rows, sel).

        Single store: the engine's
        :meth:`~repro_torch.core.query.QueryEngine.run_batch`.  Sharded:
        :meth:`~repro_torch.core.shard.ShardedQueryEngine.run_batch`, every
        member's groups riding one ``run_batch`` per shard.
        """
        mode = self._check_mode(mode)
        if self.sharded:
            return self._sharded_engine(mode).run_batch(requests)
        return self.engine(mode).run_batch(requests)

    def answers(self, patterns, select=None, mode: str = None) -> set:
        rows, _ = self.query(patterns, select=select, mode=mode)
        return {tuple(r) for r in rows.tolist()}

    def device_buffers(self) -> list:
        """Tensors this snapshot's pinned views keep alive, as ledger
        records under the ``snapshot`` component: after a compaction the
        live store swaps to fresh tensors, and whatever a pinned version
        still references (superseded bases, leased masks) is memory
        retained by MVCC.  Records are keyed by storage, so the ledger
        dedupes them against the live store's own when it registers
        first."""
        return [("snapshot", key, nbytes)
                for views in self.views.values()
                for v in (views if isinstance(views, list) else (views,))
                for _comp, key, nbytes in v.device_buffers()]

    def store_rows(self, mode: str = None) -> np.ndarray:
        """Live rows at the pinned version (host; shards concatenated)."""
        mode = self._check_mode(mode)
        if self.sharded:
            return np.concatenate(
                [np.asarray(v.live_rows()) for v in self.views[mode]])
        return np.asarray(self.views[mode].live_rows())


class Pin:
    """One reader's lease on a snapshot: context-managed refcount + tag.

    ``stale=True`` marks a degraded pin — the store had moved (or the
    writer held the lock) and the reader was served the last *published*
    version instead of the newest one.  Queries still answer exactly at
    ``version``; the tag just tells the client which version that is.
    """

    def __init__(self, registry: "SnapshotRegistry", snapshot: Snapshot,
                 stale: bool):
        self._registry = registry
        self.snapshot = snapshot
        self.stale = stale
        self._released = False

    @property
    def version(self) -> int:
        return self.snapshot.version

    def query(self, patterns, select=None, mode: str = None):
        return self.snapshot.query(patterns, select=select, mode=mode)

    def query_batch(self, requests, mode: str = None):
        return self.snapshot.query_batch(requests, mode=mode)

    def answers(self, patterns, select=None, mode: str = None) -> set:
        return self.snapshot.answers(patterns, select=select, mode=mode)

    def store_rows(self, mode: str = None):
        return self.snapshot.store_rows(mode)

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._registry._release(self.snapshot)

    def __enter__(self) -> "Pin":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class SnapshotRegistry:
    """Publish/pin/retire lifecycle for MVCC snapshots of one store.

    * ``publish()`` captures the current version under the write lock and
      makes it the registry's serving snapshot.
    * ``pin()`` hands a reader a refcounted :class:`Pin`.  Fast path: the
      published snapshot already matches ``kb.version``.  Slow path: grab
      the write lock (bounded by ``lock_timeout_s``) and capture a fresh
      one.  Degraded path: the lock is contended or the capture failed —
      serve the last published snapshot tagged stale (never block a
      reader on a writer).
    * ``retire()`` drops refcount-zero snapshots that are no longer
      published; pinned versions survive any number of writes and
      compactions (their views keep the superseded base arrays alive).
    """

    def __init__(self, kb, modes=("litemat",), use_index: bool = True,
                 lock_timeout_s: float = 0.2,
                 metrics: MetricsRegistry | None = None):
        self.kb = kb
        self.modes = tuple(modes)
        self.use_index = use_index
        self.lock_timeout_s = lock_timeout_s
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self._snaps: dict = {}  # version -> Snapshot
        self._published: Snapshot | None = None
        self._plan_caches: dict = {}  # shared across snapshots
        self._selectivity: dict = {}  # PatternSig -> observed, ditto
        self._bytes_versions: set = set()  # versions with a bytes gauge

    @property
    def stats(self) -> dict:
        """The counter dict, a read-only view over the registry."""
        m = self.metrics
        return {
            "publishes": m.counter_value("snapshot/publishes"),
            "pins": m.counter_value("snapshot/pins"),
            "stale_pins": m.counter_value("snapshot/stale_pins"),
            "fresh_captures": m.counter_value("snapshot/fresh_captures"),
            "retired": m.counter_value("snapshot/retired"),
            "capture_failures": m.counter_value("snapshot/capture_failures"),
        }

    def _refresh_gauges_locked(self) -> None:
        """Version/refcount gauges; caller holds self._lock."""
        m = self.metrics
        m.gauge("snapshot/live_versions").set(len(self._snaps))
        m.gauge("snapshot/pinned_versions").set(
            sum(1 for s in self._snaps.values() if s.refs > 0))
        m.gauge("snapshot/pinned_refs").set(
            sum(s.refs for s in self._snaps.values()))

    # -- capture / publish ---------------------------------------------------
    def _capture(self) -> dict:
        """Build per-mode views at the current version (write lock held)."""
        kb = self.kb
        views: dict = {}
        for mode in self.modes:
            if is_sharded(kb):
                if mode in ("litemat", "full"):
                    kb._flush(mode)
                vs = []
                for i, K in enumerate(kb.shards):  # on the shard's device
                    with kb._device_ctx(i):
                        vs.append(K.view(mode))
                for v in vs:
                    v.pinned = True
                views[mode] = vs
            else:
                v = kb.view(mode)
                v.pinned = True
                views[mode] = v
        return views

    def _publish_locked(self) -> Snapshot:
        """Capture-or-reuse the snapshot of kb.version (write lock held)."""
        v = self.kb.version
        with self._lock:
            snap = self._snaps.get(v)
        if snap is None:
            with obs_trace.span("capture", version=v):
                t0 = time.perf_counter()
                faults.fire("snapshot.publish", version=v)
                views = self._capture()
                self.metrics.histogram("snapshot/capture_s").observe(
                    time.perf_counter() - t0)
            snap = Snapshot(version=v, kb=self.kb, modes=self.modes,
                            views=views, use_index=self.use_index,
                            _plan_caches=self._plan_caches,
                            _selectivity=self._selectivity)
            with self._lock:
                # another thread may have captured v concurrently; keep the
                # first registered one so refcounts aggregate correctly
                snap = self._snaps.setdefault(v, snap)
        with self._lock:
            self._published = snap
            self._refresh_gauges_locked()
        self.metrics.counter("snapshot/publishes").inc()
        self.retire()
        return snap

    def publish(self) -> Snapshot:
        """Capture the current version as the serving snapshot."""
        with self.kb.write_lock:
            return self._publish_locked()

    @property
    def published(self) -> Snapshot | None:
        with self._lock:
            return self._published

    # -- pin / release -------------------------------------------------------
    def pin(self, lock_timeout_s: float | None = None) -> Pin:
        """Pin a snapshot for reading; degrade to the last published one
        (stale tag) rather than blocking on a busy writer."""
        t0 = time.perf_counter()
        try:
            return self._pin(lock_timeout_s)
        finally:
            self.metrics.histogram("snapshot/pin_wait_s").observe(
                time.perf_counter() - t0)

    def _pin(self, lock_timeout_s: float | None) -> Pin:
        m = self.metrics
        m.counter("snapshot/pins").inc()
        with self._lock:
            snap = self._published
            if snap is not None and snap.version == self.kb.version:
                snap.refs += 1
                self._refresh_gauges_locked()
                m.counter("snapshot/pin_path", path="fast").inc()
                return Pin(self, snap, stale=False)

        # the store moved past the published snapshot: try a fresh capture
        timeout = (self.lock_timeout_s if lock_timeout_s is None
                   else lock_timeout_s)
        got = self.kb.write_lock.acquire(timeout=timeout)
        if got:
            try:
                snap = self._publish_locked()
            except Exception:
                m.counter("snapshot/capture_failures").inc()
                obs_trace.event("capture_failed")
                snap = None
            finally:
                self.kb.write_lock.release()
            if snap is not None:
                m.counter("snapshot/fresh_captures").inc()
                m.counter("snapshot/pin_path", path="fresh").inc()
                with self._lock:
                    snap.refs += 1
                    self._refresh_gauges_locked()
                    return Pin(self, snap, stale=False)

        # degraded: writer holds the flush lock (or the capture crashed) —
        # serve the last published version with a staleness tag
        with self._lock:
            snap = self._published
            if snap is not None:
                m.counter("snapshot/stale_pins").inc()
                m.counter("snapshot/pin_path", path="stale").inc()
                obs_trace.event("stale_pin", version=snap.version)
                snap.refs += 1
                self._refresh_gauges_locked()
                return Pin(self, snap, stale=True)
        if got is False and snap is None:
            # nothing ever published: block once for the first capture
            with self.kb.write_lock:
                snap = self._publish_locked()
            m.counter("snapshot/pin_path", path="first").inc()
            with self._lock:
                snap.refs += 1
                self._refresh_gauges_locked()
                return Pin(self, snap, stale=False)
        raise RuntimeError("snapshot capture failed and nothing is published")

    def pin_version(self, version: int) -> Pin | None:
        """Re-pin a SPECIFIC live version — the cursor-continuation path.

        Pagination needs page K+1 to read the exact rows page K saw, so a
        cursor re-pins its version by number.  Returns None when that
        version has been retired (no reader kept it alive between pages);
        the caller degrades to a fresh pin + ``stale`` cursor rather than
        erroring.  The Pin is tagged stale when the store has moved past
        the cursor's version — answers are still exact at that version.
        """
        m = self.metrics
        with self._lock:
            snap = self._snaps.get(version)
            if snap is None:
                m.counter("snapshot/pin_path", path="cursor_miss").inc()
                return None
            m.counter("snapshot/pins").inc()
            m.counter("snapshot/pin_path", path="cursor").inc()
            snap.refs += 1
            self._refresh_gauges_locked()
            return Pin(self, snap, stale=snap.version != self.kb.version)

    def _release(self, snap: Snapshot) -> None:
        with self._lock:
            snap.refs -= 1
            self._refresh_gauges_locked()
        self.retire()

    # -- retirement ----------------------------------------------------------
    def retire(self) -> int:
        """Drop refcount-zero snapshots that are no longer published.

        Two-phase on purpose: victims picked under the lock, then the
        ``snapshot.retire`` fault site fires (the race window a concurrent
        pin could hit), then each victim is re-checked under the lock
        before removal — a pin that raced in keeps its snapshot.
        """
        t0 = time.perf_counter()
        with self._lock:
            victims = [v for v, s in self._snaps.items()
                       if s.refs == 0 and s is not self._published]
        if not victims:
            return 0
        faults.fire("snapshot.retire", versions=tuple(victims))
        dropped = 0
        with self._lock:
            for v in victims:
                s = self._snaps.get(v)
                if s is not None and s.refs == 0 and s is not self._published:
                    del self._snaps[v]
                    dropped += 1
            self._refresh_gauges_locked()
        if dropped:
            self.metrics.counter("snapshot/retired").inc(dropped)
            self.metrics.histogram("snapshot/retire_s").observe(
                time.perf_counter() - t0)
        return dropped

    def device_buffers(self) -> list:
        """Ledger feed: tensors retained by live snapshot versions.

        Deduped across versions here (two snapshots of nearby versions
        share almost every tensor); deduped against the live store by the
        ledger's global pass.  Also publishes per-version
        ``snapshot/retained_bytes{version=}`` gauges into this registry's
        metrics, zeroing versions retired since the last walk.
        Pull-based: runs only when the ledger samples, never on the pin
        fast path.
        """
        with self._lock:
            snaps = sorted(self._snaps.items())
        out = []
        seen: set = set()
        published: set = set()
        for version, snap in snaps:
            retained = 0
            for comp, key, nbytes in snap.device_buffers():
                if key in seen:
                    continue
                seen.add(key)
                out.append((comp, key, nbytes))
                retained += int(nbytes)
            self.metrics.gauge("snapshot/retained_bytes",
                               version=version).set(retained)
            published.add(version)
        for version in self._bytes_versions - published:
            self.metrics.gauge("snapshot/retained_bytes",
                               version=version).set(0)
        self._bytes_versions = published
        return out

    def live_versions(self) -> list:
        with self._lock:
            return sorted(self._snaps)

    def pinned_versions(self) -> list:
        with self._lock:
            return sorted(v for v, s in self._snaps.items() if s.refs > 0)

    def prewarm(self, queries=None, modes=None) -> None:
        """Run each query's plan body once, so serving pays no cold start
        (first-run index builds and device uploads)."""
        from repro_torch.core.engine import PAPER_QUERIES

        queries = (list(queries) if queries is not None
                   else list(PAPER_QUERIES.values()))
        with self.pin() as pin:
            for mode in (modes or self.modes):
                for q in queries:
                    pin.query(q, mode=mode)


__all__ = ["Snapshot", "SnapshotRegistry", "Pin"]
