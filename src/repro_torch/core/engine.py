"""KnowledgeBase facade: raw triples -> encoded -> materialized -> queryable.

One object wires the LiteMat pipeline on one device — TBox encode,
dictionary / ABox encode, lite and full materialization — and answers
conjunctive queries in the three modes of the paper's evaluation (lite /
full / no materialization), plus the paper's appendix queries Q1–Q4 as
canned pattern lists.

The KnowledgeBase is *live*: LiteMat's interval encoding reserves unused
id headroom so the dictionary and stores can grow without re-encoding, and
``insert`` / ``delete`` exploit that:

  * ``insert(raw)``  — new instance terms extend the dictionary in place
    (ids past ``n_instance_terms``; no existing id moves), and the encoded
    rows land in an append-only delta overlay (core/delta.py) that queries
    union with the base.  Lite/full materialization of the delta is LAZY
    per mode: each store derives its backlog the first time it is served.
  * ``delete(raw)``  — tombstones the raw rows, then repairs the
    materialized stores exactly by re-deriving the affected instances from
    their remaining live triples (core/update.py).
  * ``compact()``    — folds the overlay into the base stores with one
    sorted-merge pass per store; triggered automatically once the
    delta-to-base ratio passes ``compact_threshold``.

Every mutation bumps the monotonic ``version`` counter; query engines
re-sync their views off it.

Every tensor lives on the KnowledgeBase's device, which defaults to CUDA:
``build`` raises when no CUDA device exists rather than running on the
CPU, and callers that want the CPU (the tests) say so with
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import dictionary as dct
from repro_torch.core.abox import EncodedKB, encode_obe
from repro_torch.core.closure import full_materialize
from repro_torch.core.delta import (
    MODES, DeltaKB, DeltaLog, DeviceStoreCache, StoreView, compact_view,
)
from repro_torch.core.index import StoreIndex
from repro_torch.core.materialize import DeviceTBox, compact_rows, lite_materialize
from repro_torch.core.query import Pattern, QueryEngine
from repro_torch.core.tbox import Ontology, TBox, build_tbox
from repro_torch.core.update import (
    DynamicDictionary, RowLocator, absorb_new_terms, affected_instances,
    encode_delta, materialize_delta_mode, mention_rows, mentions_mask,
)
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.ledger import LEDGER, tensor_record
from repro_torch.obs.metrics import REGISTRY
from repro_torch.rdf.generator import RawDataset
from repro_torch.testing import faults

# The paper's appendix queries (over the LUBM vocabulary).
PAPER_QUERIES = {
    "Q1": [Pattern("?x", "rdf:type", "Professor")],
    "Q2": [Pattern("?x", "memberOf", "?y")],
    "Q3": [Pattern("?x", "rdf:type", "Professor"), Pattern("?x", "memberOf", "?y")],
    "Q4": [
        Pattern("?x", "rdf:type", "Chair"),
        Pattern("?y", "rdf:type", "Department"),
        Pattern("?x", "worksFor", "?y"),
    ],
}


def _raw_columns(raw):
    """RawDataset | (s, p, o) arrays -> (s_fp, p_fp, o_fp, term_strings)."""
    if isinstance(raw, RawDataset) or hasattr(raw, "s"):
        return (np.asarray(raw.s), np.asarray(raw.p), np.asarray(raw.o),
                getattr(raw, "term_strings", None))
    s, p, o = raw
    return np.asarray(s), np.asarray(p), np.asarray(o), None


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass "
                "device='cpu' explicitly to run its plain versions")
        return torch.device("cuda")
    return torch.device(device)


@dataclass
class KnowledgeBase:
    kb: EncodedKB
    dtb: DeviceTBox
    lite_spo: torch.Tensor  # compacted lite-materialized base store
    full_spo: torch.Tensor  # compacted fully-materialized base store
    lite_stats: dict
    full_stats: dict
    compact_threshold: float = 0.25  # auto-compact past this delta ratio
    version: int = 0  # bumps on every insert/delete/compact
    lazy_materialize: bool = True  # derive lite/full deltas per served mode
    mat_counts: dict = field(
        default_factory=lambda: {"litemat": 0, "full": 0})  # batches derived
    _engines: dict = field(default_factory=dict, repr=False)
    _delta: DeltaKB | None = field(default=None, repr=False)
    _dyn: DynamicDictionary | None = field(default=None, repr=False)
    _base_indexes: dict = field(default_factory=dict, repr=False)
    _views: dict = field(default_factory=dict, repr=False)
    _raw_loc: RowLocator | None = field(default=None, repr=False)
    _dev_caches: dict = field(default_factory=dict, repr=False)
    _pending_raw: list = field(default_factory=list, repr=False)
    _mat_cursor: dict = field(
        default_factory=lambda: {"litemat": 0, "full": 0}, repr=False)
    # writers (insert/delete/compact) serialize here
    write_lock: threading.RLock = field(
        default_factory=threading.RLock, repr=False, compare=False)

    @classmethod
    def build(cls, raw: RawDataset, tbox: TBox | None = None,
              parallel_tbox: bool = False, device=None) -> "KnowledgeBase":
        device = resolve_device(device)
        # one span per stage; each stage ends in a host read of its counts,
        # so a span's time covers its device work
        with obs_trace.span("tbox"):
            tbox = tbox or build_tbox(raw.onto, parallel=parallel_tbox)
            dtb = DeviceTBox.build(tbox, device=device)
        with obs_trace.span("encode", n_triples=raw.n_triples):
            kb = encode_obe(raw, tbox, device=device)
        with obs_trace.span("lite"):
            lite, lvalid, lstats = lite_materialize(kb, dtb)
            lite_spo = compact_rows(lite, lvalid)
            del lite, lvalid
        with obs_trace.span("full"):
            full, fvalid, fstats = full_materialize(kb, dtb)
            full_spo = compact_rows(full, fvalid)
        return cls(kb=kb, dtb=dtb, lite_spo=lite_spo, full_spo=full_spo,
                   lite_stats=lstats, full_stats=fstats)

    @classmethod
    def from_numpy(cls, state: dict, onto: Ontology, device=None,
                   parallel_tbox: bool = False) -> "KnowledgeBase":
        """A KnowledgeBase from another build's arrays, as numpy.

        ``state`` holds ``spo``, ``lite_spo``, ``full_spo`` (int32[N, 3]),
        ``tables`` (one dict of TermTable planes per dictionary part —
        ``fp_hi, fp_lo, ids, rev_ids, rev_hi, rev_lo, count``),
        ``n_instance_terms``, ``lite_stats`` and ``full_stats``.  The TBox
        is rebuilt from ``onto`` (deterministic), so queries can be held
        against another implementation's store independently of the build.

        An optional ``live`` entry carries a mutated store's overlay:
        ``logs`` (per mode: ``rows``, ``alive``, ``tombstone_mut``),
        ``base_alive`` (per mode: bool[N] or None), ``kills`` (per mode: a
        list of killed base-row index arrays), ``n_new_terms``,
        ``version``, and optionally ``pending_raw`` (insert batches not yet
        derived) with ``mat_cursor``/``mat_counts``.  The grown dictionary
        arrives as extra ``tables`` parts with the grown
        ``n_instance_terms``.
        """
        device = resolve_device(device)
        tbox = build_tbox(onto, parallel=parallel_tbox)

        def rows(a):
            return torch.as_tensor(np.array(a, dtype=np.int32), device=device)

        kb = EncodedKB(
            spo=rows(state["spo"]),
            tables=tuple(dct.TermTable.from_numpy(t, device)
                         for t in state["tables"]),
            tbox=tbox,
            n_instance_terms=int(state["n_instance_terms"]),
        )
        out = cls(kb=kb, dtb=DeviceTBox.build(tbox, device=device),
                  lite_spo=rows(state["lite_spo"]),
                  full_spo=rows(state["full_spo"]),
                  lite_stats=dict(state["lite_stats"]),
                  full_stats=dict(state["full_stats"]))
        live = state.get("live")
        if live is not None:
            d = DeltaKB(n_new_terms=int(live["n_new_terms"]))
            for m in MODES:
                lg = live["logs"][m]
                d.logs[m] = DeltaLog(
                    rows=np.array(lg["rows"], dtype=np.int32).reshape(-1, 3),
                    alive=np.array(lg["alive"], dtype=bool),
                    tombstone_mut=int(lg["tombstone_mut"]))
                ba = live["base_alive"][m]
                d.base_alive[m] = None if ba is None else np.array(ba, bool)
                d.kills[m] = [np.array(k, dtype=np.int64)
                              for k in live["kills"][m]]
            out._delta = d
            out.version = int(live["version"])
            out._pending_raw = [np.array(b, dtype=np.int32)
                                for b in live.get("pending_raw", ())]
            out._mat_cursor = dict(live.get("mat_cursor",
                                            {"litemat": 0, "full": 0}))
            out.mat_counts = dict(live.get("mat_counts",
                                           {"litemat": 0, "full": 0}))
        return out

    # -- store plumbing ------------------------------------------------------
    def _base_store(self, mode: str) -> torch.Tensor:
        return {
            "litemat": self.lite_spo,
            "full": self.full_spo,
            "rewrite": self.kb.spo,
        }[mode]

    def _base_index(self, mode: str) -> StoreIndex:
        if mode not in self._base_indexes:
            self._base_indexes[mode] = StoreIndex.build(self._base_store(mode))
        return self._base_indexes[mode]

    @property
    def device(self) -> torch.device:
        return self.kb.spo.device

    @property
    def delta(self) -> DeltaKB:
        if self._delta is None:
            self._delta = DeltaKB()
        return self._delta

    def dev_cache(self, mode: str) -> DeviceStoreCache:
        """The store's persistent device buffers (survive version bumps)."""
        if mode not in self._dev_caches:
            self._dev_caches[mode] = DeviceStoreCache()
        return self._dev_caches[mode]

    def _flush_mat(self, *modes: str) -> None:
        """Materialize pending insert batches for the given derived modes.

        Inserts only queue their encoded raw rows (``lazy_materialize``);
        the first time a mode is actually *served* — a view build, a
        delete's repair, a compaction — its share of the queue is derived
        here.  Crash-atomic per mode: every pending batch is derived BEFORE
        any of them is appended, so a failure mid-derivation (fault site
        ``engine.flush_mat``) leaves the log and cursor untouched and a
        later flush retries the whole backlog.
        """
        n = len(self._pending_raw)
        for mode in modes:
            cur = self._mat_cursor[mode]
            if cur >= n:
                continue
            with obs_trace.span("flush_mat", mode=mode, n_batches=n - cur):
                t0 = time.perf_counter()
                derived = []
                for spo in self._pending_raw[cur:]:
                    faults.fire("engine.flush_mat", mode=mode,
                                batch=cur + len(derived))
                    derived.append(
                        materialize_delta_mode(spo, self.dtb, mode))
                for rows in derived:
                    self.delta.log(mode).append(rows)
                    self.mat_counts[mode] += 1
                self._mat_cursor[mode] = n
                REGISTRY.histogram("engine/flush_s", mode=mode).observe(
                    time.perf_counter() - t0)
                REGISTRY.counter("engine/derived_rows", mode=mode).inc(
                    sum(int(r.shape[0]) for r in derived))
        if self._pending_raw and all(
                c >= n for c in self._mat_cursor.values()):
            self._pending_raw.clear()
            self._mat_cursor = {m: 0 for m in self._mat_cursor}

    def _pending_rows(self, mode: str) -> int:
        """Raw rows queued for ``mode`` whose derivation hasn't run yet."""
        if mode not in self._mat_cursor:
            return 0
        return sum(int(b.shape[0])
                   for b in self._pending_raw[self._mat_cursor[mode]:])

    def view(self, mode: str) -> StoreView:
        """The live base+delta StoreView of one store, cached per version."""
        key = (mode, self.version)
        if key not in self._views:
            if mode in ("litemat", "full"):
                self._flush_mat(mode)
            idx = self._base_index(mode)
            if self._delta is None or self._delta.empty:
                v = StoreView(base_rows=self._base_store(mode), base_h=idx._h,
                              base_index=idx, cache=self.dev_cache(mode))
            else:
                v = StoreView.overlay(self._base_store(mode), idx,
                                      self._delta.log(mode),
                                      self._delta.base_alive[mode],
                                      cache=self.dev_cache(mode),
                                      kills=tuple(self._delta.kills[mode]))
            self._views[key] = v
        return self._views[key]

    def store_rows(self, mode: str = "litemat") -> torch.Tensor:
        """Effective (live) rows of one store."""
        if self._delta is None or self._delta.empty:
            return self._base_store(mode)
        return torch.as_tensor(self.view(mode).live_rows(), device=self.device)

    def engine(self, mode: str = "litemat", use_index: bool = True) -> QueryEngine:
        """Cached QueryEngine per (mode, use_index), re-synced to ``version``.

        ``use_index=False`` forces the scan-only path — the oracle the
        indexed plans are validated against (tests, chip_smoke.py).
        """
        key = (mode, use_index)
        v = self.view(mode)
        eng = self._engines.get(key)
        if eng is None:
            eng = QueryEngine(kb=self.kb, spo=self._base_store(mode),
                              mode=mode, dtb=self.dtb, use_index=use_index,
                              view=v)
            self._engines[key] = eng
        elif eng.view is not v:
            eng.set_view(v)
        return eng

    def query(self, patterns, select=None, mode: str = "litemat",
              use_index: bool = True):
        rows, sel = self.engine(mode, use_index).run(patterns, select=select)
        return rows, sel

    def answers(self, patterns, select=None, mode: str = "litemat",
                use_index: bool = True) -> set:
        rows, _ = self.query(patterns, select=select, mode=mode,
                             use_index=use_index)
        return {tuple(r) for r in rows.tolist()}

    def prewarm(self, queries=None, modes=("litemat",), buckets=(),
                use_index: bool = True) -> int:
        """Run plan bodies for ``queries`` (default: Q1–Q4) once."""
        queries = (list(queries) if queries is not None
                   else list(PAPER_QUERIES.values()))
        return sum(
            self.engine(m, use_index).prewarm(queries, buckets=buckets)
            for m in modes
        )

    def warm_device(self, mode: str = "litemat", keys=("scan", "pos")):
        """Bring ``mode``'s device buffers up to the current version: the
        O(delta) bucket refresh and O(#killed) tombstone scatters a first
        query pays after a mutation (``dev_cache(mode).stats`` counts the
        transfers)."""
        return self.view(mode).warm_device(keys)

    # -- device resource accounting (obs/ledger.py feed) ---------------------
    def device_buffers(self) -> list:
        """Every tensor this store references, as ledger records.

        Base store tensors and sorted permutations under ``base``, delta
        buckets under ``delta``, liveness masks under ``alive``, the
        ``DeviceTBox`` tables under ``tbox``; each record keyed by its
        storage (``obs.ledger.tensor_record``), so the ledger dedupes a
        permutation that is the store tensor itself, or a base a pinned
        snapshot shares.  The rollup thread samples this while writers
        run: it walks ``list`` copies of the dicts a writer replaces, and
        never materializes a view, flushes a delta, or reads a tensor's
        values (no device sync).
        """
        out = [tensor_record("base", t)
               for t in (self.kb.spo, self.lite_spo, self.full_spo)]
        for idx in list(self._base_indexes.values()):
            for p in list(idx._perms.values()):
                out.append(tensor_record("base", p.rows))
        for cache in list(self._dev_caches.values()):
            out.extend(cache.device_buffers())
        for v in list(self._views.values()):
            out.extend(v.device_buffers())
        for f in dataclasses.fields(self.dtb):
            t = getattr(self.dtb, f.name)
            if isinstance(t, torch.Tensor):
                out.append(tensor_record("tbox", t))
        return out

    def track_ledger(self, shard="0") -> None:
        """Register with the process ledger (idempotent, weakly held)."""
        if getattr(self, "_ledger_handle", None) is None:
            self._ledger_handle = LEDGER.track(shard, self)

    def n_live_triples(self) -> int:
        """Live triples in the served (litemat) store, side-effect-free
        (not through ``view()``, which would flush materialization)."""
        d = self._delta
        if d is None:
            n = int(self.lite_spo.shape[0])
        else:
            alive = d.base_alive["litemat"]
            n = (int(self.lite_spo.shape[0]) if alive is None
                 else int(alive.sum()))
            n += d.logs["litemat"].n_live
        return n + self._pending_rows("litemat")

    def sizes(self) -> dict:
        out = dict(
            original=self.kb.n,
            lite=int(self.lite_spo.shape[0]),
            full=int(self.full_spo.shape[0]),
        )
        if self._delta is not None and not self._delta.empty:
            out["delta_rows"] = sum(
                self._delta.n_rows(m) for m in MODES)
            pending = sum(self._pending_rows(m) for m in ("litemat", "full"))
            if pending:
                out["delta_rows_pending_mat"] = pending
        return out

    # -- incremental updates -------------------------------------------------
    def _dynamic(self) -> DynamicDictionary:
        if self._dyn is None:
            self._dyn = DynamicDictionary.from_kb(self.kb)
        return self._dyn

    def _raw_locator(self) -> RowLocator:
        if self._raw_loc is None:
            self._raw_loc = RowLocator.build(self._base_index("rewrite")._h)
        return self._raw_loc

    def _bump(self) -> None:
        self.version += 1
        self._views.clear()

    @property
    def delta_ratio(self) -> float:
        if self._delta is None and not self._pending_raw:
            return 0.0
        # pending (not yet derived) insert batches count once per lazy mode,
        # so auto-compaction triggers on the same schedule whether or not
        # the modes have been served yet
        extra = sum(self._pending_rows(m) for m in ("litemat", "full"))
        return self.delta.ratio({
            "rewrite": self.kb.n,
            "litemat": int(self.lite_spo.shape[0]),
            "full": int(self.full_spo.shape[0]),
        }, extra_rows=extra)

    def insert(self, raw, auto_compact: bool = True) -> dict:
        """Append raw triples without rebuilding: encode + queue derivation.

        New instance/literal terms extend the dictionary in place (ids past
        ``n_instance_terms``); predicates must be TBox properties.  The
        encoded rows land in the raw delta log immediately; their lite/full
        materialization is derived the first time each mode is served.
        """
        s_fp, p_fp, o_fp, strings = _raw_columns(raw)
        if s_fp.shape[0] == 0:
            return dict(n_inserted=0, n_new_terms=0)
        with self.write_lock:
            dyn = self._dynamic()
            spo, n_new = encode_delta(dyn, s_fp, p_fp, o_fp)
            absorb_new_terms(self.kb, dyn, strings)
            d = self.delta
            d.log("rewrite").append(spo)
            self._pending_raw.append(spo)
            if not self.lazy_materialize:
                self._flush_mat("litemat", "full")
            d.n_new_terms += n_new
            self._bump()
            REGISTRY.counter("engine/inserted_rows").inc(int(spo.shape[0]))
            stats = dict(
                n_inserted=int(spo.shape[0]),
                n_new_terms=n_new,
                n_pending_mat=sum(
                    self._pending_rows(m) for m in ("litemat", "full")),
                delta_ratio=round(self.delta_ratio, 4),
                version=self.version,
            )
            if auto_compact and self.delta_ratio > self.compact_threshold:
                stats["compacted"] = self.compact()
            return stats

    # -- delete primitives (the sharded store composes the same steps) -------
    def append_raw(self, rows: np.ndarray) -> None:
        """Append pre-encoded raw rows to the rewrite delta log (no bump)."""
        self.delta.log("rewrite").append(rows)

    def append_derived(self, mode: str, rows: np.ndarray) -> None:
        """Append pre-derived rows to one materialized store's delta log."""
        if rows.shape[0]:
            self.delta.log(mode).append(rows)

    def kill_raw_rows(self, q: np.ndarray) -> np.ndarray:
        """Tombstone exact encoded triples in the raw store (base + delta).

        Returns the rows actually killed (live copies only); does NOT
        repair the derived stores.
        """
        d = self.delta
        deleted = []
        base_h = self._base_index("rewrite")._h
        hits = self._raw_locator().find(q)
        if hits.size:
            alive = d.base_alive["rewrite"]
            if alive is not None:
                hits = hits[alive[hits]]
            if hits.size:
                deleted.append(base_h[hits])
                d.kill_base("rewrite", base_h.shape[0], hits)
        rlog = d.log("rewrite")
        if rlog.n:
            dhits = RowLocator.build(rlog.rows).find(q)
            if dhits.size:
                dhits = dhits[rlog.alive[dhits]]
                if dhits.size:
                    deleted.append(rlog.rows[dhits])
                    rlog.tombstone(dhits)
        if not deleted:
            return np.zeros((0, 3), dtype=np.int32)
        return np.concatenate(deleted)

    def kill_derived_mentions(self, inst: np.ndarray) -> None:
        """Tombstone every derived row mentioning an affected instance
        (O(k log N + hits) in the base size, through SPO/OSP runs)."""
        d = self.delta
        for mode in ("litemat", "full"):
            idx = self._base_index(mode)
            d.kill_base(mode, idx.n, mention_rows(idx, inst))
            log = d.log(mode)
            if log.n:
                log.tombstone(mentions_mask(log.rows, inst))

    def live_raw_mentions(self, inst: np.ndarray) -> np.ndarray:
        """Live raw triples mentioning any affected instance (s or o): the
        re-derivation frontier of a delete."""
        d = self.delta
        base_h = self._base_index("rewrite")._h
        raw_alive = d.base_alive["rewrite"]
        raw_rows = mention_rows(self._base_index("rewrite"), inst)
        if raw_alive is not None:
            raw_rows = raw_rows[raw_alive[raw_rows]]
        parts = [base_h[raw_rows]]
        rlog = d.log("rewrite")
        if rlog.n:
            parts.append(rlog.rows[mentions_mask(rlog.rows, inst) & rlog.alive])
        return np.concatenate(parts)

    def delete(self, raw, auto_compact: bool = True) -> dict:
        """Remove raw triples (all copies) and repair the derived stores.

        Tombstones the raw rows, then re-derives every *affected instance*
        (endpoints of the deleted triples) from its remaining live triples:
        derived rows only ever mention their source triple's instances, so
        the repair is exact without support counting.
        """
        s_fp, p_fp, o_fp, _ = _raw_columns(raw)
        if s_fp.shape[0] == 0:
            return dict(n_deleted=0)
        with self.write_lock:
            # the repair below tombstones + re-appends derived delta rows,
            # so any lazily queued materialization must land first
            self._flush_mat("litemat", "full")
            dyn = self._dynamic()
            ids = np.stack([dyn.lookup(s_fp), dyn.lookup(p_fp),
                            dyn.lookup(o_fp)], axis=1)
            q = ids[(ids >= 0).all(axis=1)]  # unknown-term triples: absent

            deleted = self.kill_raw_rows(q)
            if deleted.shape[0] == 0:
                return dict(n_deleted=0)
            inst = affected_instances(deleted, self.kb.tbox.instance_base)
            self.kill_derived_mentions(inst)

            # re-derive the affected instances from their live raw triples
            frontier = self.live_raw_mentions(inst)
            for mode in ("litemat", "full"):
                derived = materialize_delta_mode(frontier, self.dtb, mode)
                self.append_derived(
                    mode, derived[mentions_mask(derived, inst)])
            self._bump()
            REGISTRY.counter("engine/deleted_rows").inc(
                int(deleted.shape[0]))
            stats = dict(
                n_deleted=int(deleted.shape[0]),
                n_affected_instances=int(inst.shape[0]),
                delta_ratio=round(self.delta_ratio, 4),
                version=self.version,
            )
            if auto_compact and self.delta_ratio > self.compact_threshold:
                stats["compacted"] = self.compact()
            return stats

    def compact(self, device: bool | None = None) -> dict:
        """Fold the delta overlay into fresh base stores (sorted merges).

        Each store's base POS run interleaves with its delta POS run in one
        merge pass (tombstones dropped on the way); the merged run doubles
        as the new base array, so the rebuilt StoreIndex starts with its POS
        permutation.  Dictionary growth needs no work: new terms were
        absorbed into ``kb.tables`` at insert time.

        ``device`` selects the merge: the merge-path kernel over the
        resident device buffers (bit-identical to the host merge; the
        default when the store lives on a CUDA device) or the host
        searchsorted interleave (the default elsewhere).
        """
        with self.write_lock:
            if ((self._delta is None or self._delta.empty)
                    and not self._pending_raw):
                return dict(compacted=False)
            with obs_trace.span("compact"):
                t0 = time.perf_counter()
                self._flush_mat("litemat", "full")
                if device is None:
                    device = self.device.type == "cuda"
                sizes = {}
                for mode in MODES:
                    dev, idx = compact_view(self.view(mode), device=device)
                    if mode == "rewrite":
                        self.kb.spo = dev
                    elif mode == "litemat":
                        self.lite_spo = dev
                    else:
                        self.full_spo = dev
                    self._base_indexes[mode] = idx
                    sizes[mode] = int(dev.shape[0])
                self._delta = DeltaKB()
                self._raw_loc = None
                self._bump()
                REGISTRY.counter("engine/compactions").inc()
                REGISTRY.histogram("engine/compact_s").observe(
                    time.perf_counter() - t0)
            return dict(compacted=True, version=self.version, **sizes)
