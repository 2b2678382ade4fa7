"""Sharded stores on one device: the ABox subject-hash partitioned.

A :class:`ShardedKB` splits every ABox store across ``n_shards`` shards
while replicating what makes RDFS inference shard-local:

Partitioning invariants
-----------------------
  * Every ABox row lives on ``shard_of(subject id)``: raw triples by their
    subject, *derived* rows by THEIR subject — range-derived type rows
    ``(o rdf:type C)`` migrate to ``shard(o)`` in the post-materialization
    exchange, so the subject-hash invariant holds for all three stores
    (rewrite / litemat / full).
  * The TBox (``DeviceTBox``) and the term dictionary are REPLICATED: every
    interval containment test, MSC selection and closure gather is
    shard-local; the dictionary grows through ONE shared
    :class:`DynamicDictionary` whose new-term chunks every shard's
    ``EncodedKB`` absorbs.
  * Each shard is a full :class:`KnowledgeBase` — its own sorted indexes,
    device caches and delta logs — so insert / delete / compact, version
    bumps and the O(delta) warmup run per shard, unchanged.

Join locality rules
-------------------
Two patterns' matching rows are co-resident iff they bind a shared
variable from their SUBJECT position on both sides, so the group planner
buckets patterns by subject variable: each group runs shard-local through
the ordinary per-shard ``QueryEngine`` plans.  Cross-group joins (Q4's
object-keyed ``?y``) combine globally: the host fold gathers the
per-shard relations, folds them key-sorted through the merge-path kernel
(``ops.merge_gather``) and finishes with the presorted merge join and one
distinct; the repartition combine bins both sides by a hash of the join
key, swaps the bins on the shard axis and joins every shard's bins
locally.  Rewrite-mode type patterns bind ``?x`` from BOTH endpoints
(the range branch binds the object), so they are never co-hashed.

All shards live on the one device the store was built on, and groups run
through a per-shard dispatch loop: the reference's path whenever it has
fewer devices than shards.  Its ``shard_map`` path (a device per shard,
stacked buffers, collectives) and the device-parallel dictionary encode
are not ported (port slice 6b): inserts always take the host encode.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.abox import EncodedKB, encode_obe, tbox_term_map
from repro_torch.core.closure import full_materialize
from repro_torch.core.delta import MODES
from repro_torch.core.dictionary import table_from_host
from repro_torch.core.engine import (
    PAPER_QUERIES, KnowledgeBase, _raw_columns, resolve_device,
)
from repro_torch.core.index import pow2_bucket as _pow2
from repro_torch.core.materialize import DeviceTBox, compact_rows, lite_materialize
from repro_torch.core.query import (
    INVALID, Pattern, Relation, distinct, is_var, join, sig_label,
)
from repro_torch.core.tbox import TBox, build_tbox
from repro_torch.core.update import (
    DynamicDictionary, affected_instances, encode_delta,
    materialize_delta_mode, mentions_mask,
)
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.ledger import LEDGER
from repro_torch.obs.metrics import REGISTRY
from repro_torch.testing import faults
from repro_torch.testing.faults import FaultCrash, FaultError

_EMPTY = np.zeros((0, 3), dtype=np.int32)
_HASH_MULT = np.uint64(0x9E3779B1)  # Fibonacci multiplicative hash
_NO_SHARD_MAP = ("the shard_map path (a device per shard) is not ported "
                 "yet: it comes with port slice 6b")


def shard_of(ids, n_shards: int) -> np.ndarray:
    """Subject id -> shard id (deterministic multiplicative hash).

    Instance ids are dense ranks, so a plain modulo would couple shard
    choice to allocation order; the golden-ratio multiply decorrelates it.
    """
    h = (np.asarray(ids).astype(np.uint64) * _HASH_MULT) >> np.uint64(16)
    return (h % np.uint64(max(n_shards, 1))).astype(np.int64)


def partition_rows(rows: np.ndarray, n_shards: int) -> list:
    """Split (N, 3) encoded rows into per-shard arrays by subject hash."""
    rows = np.asarray(rows, dtype=np.int32).reshape(-1, 3)
    if rows.shape[0] == 0:
        return [_EMPTY] * n_shards
    sh = shard_of(rows[:, 0], n_shards)
    order = np.argsort(sh, kind="stable")
    rows_s, sh_s = rows[order], sh[order]
    bounds = np.searchsorted(sh_s, np.arange(n_shards + 1))
    return [rows_s[bounds[i]:bounds[i + 1]] for i in range(n_shards)]


def _exchange(parts_by_src: list, n_shards: int) -> list:
    """All-to-all: re-partition per-source derived rows by subject hash."""
    outs = [[] for _ in range(n_shards)]
    for rows in parts_by_src:
        for j, pr in enumerate(partition_rows(rows, n_shards)):
            if pr.shape[0]:
                outs[j].append(pr)
    return [np.concatenate(o) if o else _EMPTY for o in outs]


def _default_shards(device: torch.device) -> int:
    """One shard per visible CUDA device; one on the CPU."""
    return max(torch.cuda.device_count(), 1) if device.type == "cuda" else 1


# ---------------------------------------------------------------------------
# ShardedKB: the partitioned KnowledgeBase facade
# ---------------------------------------------------------------------------


@dataclass
class IngestReport:
    """Structured per-part outcome of a streaming ingest.

    One entry per input part: ``dict(part=, ok=, attempts=, n_inserted=,
    version=)`` on success, ``dict(part=, ok=False, attempts=, error=)``
    after the retry budget is spent.  A failed part is *skipped* — the
    store stays at the consistent version the last successful part
    published — so callers inspect ``ok`` / ``failed`` instead of fishing
    a half-ingested store out of an exception.
    """

    parts: list = field(default_factory=list)
    n_retries: int = 0

    @property
    def failed(self) -> list:
        return [p for p in self.parts if not p["ok"]]

    @property
    def ok(self) -> bool:
        return not self.failed

    @property
    def n_rows(self) -> int:
        return sum(p.get("n_inserted", 0) for p in self.parts if p["ok"])


@dataclass
class ShardedKB:
    """Subject-hash partitioned KnowledgeBase with replicated TBox/dictionary.

    Mirrors the :class:`KnowledgeBase` surface (query / answers / insert /
    delete / compact / prewarm / warm_device / sizes) so servers and tests
    swap between the two; with the same ``select``, every answer equals
    the single store's row for row.
    """

    shards: list  # per-shard KnowledgeBase, all on ``device``
    dtb: DeviceTBox
    n_shards: int
    device: torch.device
    compact_threshold: float = 0.25
    version: int = 0
    n_new_terms: int = 0
    mat_counts: dict = field(
        default_factory=lambda: {"litemat": 0, "full": 0})
    _dyn: DynamicDictionary | None = field(default=None, repr=False)
    _engines: dict = field(default_factory=dict, repr=False)
    _pending: list = field(default_factory=list, repr=False)  # per-shard parts
    _mat_cursor: dict = field(
        default_factory=lambda: {"litemat": 0, "full": 0}, repr=False)
    _ledger_handles: list = field(default_factory=list, repr=False)
    # writers serialize here (same contract as KnowledgeBase.write_lock);
    # snapshot captures take it briefly to see a quiescent global version
    write_lock: threading.RLock = field(
        default_factory=threading.RLock, repr=False, compare=False)
    ingest_report: "IngestReport | None" = field(default=None, repr=False)

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, raw, tbox: TBox | None = None, n_shards: int | None = None,
              parallel_tbox: bool = False, device=None) -> "ShardedKB":
        """Encode + partition + per-shard materialize (with exchange).

        The encode runs once for the whole dataset (ids equal the single
        store's); the lite/full materializers then run per shard over that
        shard's raw partition, and the derived rows are exchanged to THEIR
        subject's shard.  Per-shard MSC may keep a concept alongside a
        descendant another shard holds — answer-equivalent under interval
        evaluation, the invariant the incremental insert relies on too.
        """
        device = resolve_device(device)
        tbox = tbox or build_tbox(raw.onto, parallel=parallel_tbox)
        n_shards = n_shards or _default_shards(device)
        kbg = encode_obe(raw, tbox, device=device)
        dtb = DeviceTBox.build(tbox, device=device)
        parts = partition_rows(kbg.spo.cpu().numpy(), n_shards)

        lite_src, full_src, built = [], [], []
        for part in parts:
            kb_i = EncodedKB(
                spo=torch.as_tensor(part, device=device), tables=kbg.tables,
                tbox=tbox, n_instance_terms=kbg.n_instance_terms,
                term_strings=kbg.term_strings)
            if part.shape[0]:
                lite, lv, lstats = lite_materialize(kb_i, dtb)
                lite_src.append(compact_rows(lite, lv).cpu().numpy())
                del lite, lv
                full, fv, fstats = full_materialize(kb_i, dtb)
                full_src.append(compact_rows(full, fv).cpu().numpy())
                del full, fv
            else:
                lstats = fstats = {}
                lite_src.append(_EMPTY)
                full_src.append(_EMPTY)
            built.append((kb_i, lstats, fstats))
        lite_parts = _exchange(lite_src, n_shards)
        full_parts = _exchange(full_src, n_shards)
        shards = [
            KnowledgeBase(
                kb=kb_i, dtb=dtb,
                lite_spo=torch.as_tensor(lite_parts[i], device=device),
                full_spo=torch.as_tensor(full_parts[i], device=device),
                lite_stats=lstats, full_stats=fstats)
            for i, (kb_i, lstats, fstats) in enumerate(built)]
        skb = cls(shards=shards, dtb=dtb, n_shards=n_shards, device=device)
        skb._share_dictionary(DynamicDictionary.from_kb(kbg))
        return skb

    @classmethod
    def empty(cls, tbox: TBox, n_shards: int | None = None,
              device=None) -> "ShardedKB":
        """Shards over an empty ABox — the bulk-ingest starting point."""
        device = resolve_device(device)
        n_shards = n_shards or _default_shards(device)
        fps, ids = tbox_term_map(tbox)
        ttable = table_from_host(fps, ids, device=device)
        dtb = DeviceTBox.build(tbox, device=device)
        shards = []
        for _ in range(n_shards):
            kb_i = EncodedKB(spo=torch.as_tensor(_EMPTY, device=device),
                             tables=(ttable,), tbox=tbox, n_instance_terms=0)
            shards.append(KnowledgeBase(
                kb=kb_i, dtb=dtb,
                lite_spo=torch.as_tensor(_EMPTY, device=device),
                full_spo=torch.as_tensor(_EMPTY, device=device),
                lite_stats={}, full_stats={}))
        skb = cls(shards=shards, dtb=dtb, n_shards=n_shards, device=device)
        skb._share_dictionary(DynamicDictionary.from_kb(shards[0].kb))
        return skb

    def _share_dictionary(self, dyn: DynamicDictionary) -> None:
        """One replicated growable dictionary behind every shard."""
        self._dyn = dyn
        for K in self.shards:
            K._dyn = dyn

    @classmethod
    def ingest(cls, parts, tbox: TBox | None = None, onto=None,
               n_shards: int | None = None, max_part_retries: int = 3,
               backoff_s: float = 0.01, backoff_cap_s: float = 0.5,
               seed: int = 0, device=None) -> "ShardedKB":
        """Bulk-load an iterable of raw parts, never materializing globally.

        Each part (RawDataset or (s, p, o) fingerprint columns) is encoded
        against the growing replicated dictionary, hash-partitioned by
        subject, and appended to the per-shard raw logs; lite/full
        derivation is lazy per mode AND per shard (``_flush``).

        The loop is fault-tolerant: a part whose encode/partition fails
        transiently is retried up to ``max_part_retries`` times with
        jittered exponential backoff; a part that exhausts its budget (or
        hard-crashes with :class:`FaultCrash`) is recorded in the store's
        ``ingest_report`` and *skipped* — ``insert`` commits atomically, so
        a failed part leaves the store at the version the previous part
        published.
        """
        parts = iter(parts)
        if tbox is None:
            first = next(parts)
            tbox = build_tbox(onto or first.onto)
            parts = iter([first, *parts])
        skb = cls.empty(tbox, n_shards=n_shards, device=device)
        report = IngestReport()
        rng = np.random.default_rng(seed)
        for k, part in enumerate(parts):
            attempt = 0
            while True:
                v0 = skb.version
                try:
                    stats = skb.insert(part, auto_compact=False)
                    report.parts.append(dict(
                        part=k, ok=True, attempts=attempt + 1,
                        n_inserted=stats["n_inserted"],
                        version=skb.version))
                    break
                except Exception as e:  # noqa: BLE001 — classified below
                    retryable = (not isinstance(e, FaultCrash)
                                 and skb.version == v0  # nothing committed
                                 and attempt < max_part_retries)
                    if not retryable:
                        report.parts.append(dict(
                            part=k, ok=False, attempts=attempt + 1,
                            error=f"{type(e).__name__}: {e}"))
                        REGISTRY.counter("shard/ingest_failed_parts").inc()
                        break
                    report.n_retries += 1
                    REGISTRY.counter("shard/ingest_retries").inc()
                    delay = min(backoff_cap_s, backoff_s * (2 ** attempt))
                    time.sleep(delay * (0.5 + 0.5 * rng.random()))
                    attempt += 1
        skb.ingest_report = report
        return skb

    # -- shard plumbing ------------------------------------------------------
    @property
    def kb(self) -> EncodedKB:
        """Replicated dictionary/TBox handle (shard 0's EncodedKB)."""
        return self.shards[0].kb

    @property
    def tbox(self) -> TBox:
        return self.kb.tbox

    def _absorb(self, strings=None) -> int:
        """Fold freshly allocated dictionary terms into EVERY shard."""
        chunk = self._dyn.take_new_terms()
        if chunk is None:
            return 0
        fps, ids = chunk
        tbl = table_from_host(fps, ids, device=self.device)
        for K in self.shards:
            K.kb.tables = (*K.kb.tables, tbl)
            K.kb._merged = None
            K.kb.n_instance_terms += int(ids.shape[0])
        if strings:
            if self.kb.term_strings is None:
                shared = {}  # ONE dict, replicated by reference — every
                for K in self.shards:  # shard's extract sees every IRI
                    K.kb.term_strings = shared
            self.kb.term_strings.update(strings)
        return int(ids.shape[0])

    # -- lazy per-mode, per-shard derivation ---------------------------------
    def _flush(self, *modes: str) -> None:
        """Derive pending insert batches per shard, exchange, append.

        Each shard's share of the backlog is materialized on its own
        (row-local derivation), then the derived rows are exchanged to
        their own subject's shard — range-derived type rows migrate,
        keeping the partition invariant.  Lazy per mode: a lite-only
        deployment never runs the full closure of its ingest.

        Crash-atomic per mode (same contract as KnowledgeBase._flush_mat):
        every batch is derived AND exchanged before any shard's log is
        appended, so a failure mid-derivation (fault site
        ``shard.flush_mat``) leaves every shard's published store
        consistent and a later flush retries the whole backlog.
        """
        n = len(self._pending)
        for mode in modes:
            if mode not in self._mat_cursor:
                continue
            cur = self._mat_cursor[mode]
            if cur >= n:
                continue
            t0 = time.perf_counter()
            with obs_trace.span("flush_mat", mode=mode, n_batches=n - cur,
                                sharded=True):
                staged = []
                for b, parts in enumerate(self._pending[cur:]):
                    derived_src = []
                    for i, part in enumerate(parts):
                        if part.shape[0] == 0:
                            derived_src.append(_EMPTY)
                            continue
                        faults.fire("shard.flush_mat", mode=mode, shard=i,
                                    batch=cur + b)
                        derived_src.append(
                            materialize_delta_mode(part, self.dtb, mode))
                    staged.append(_exchange(derived_src, self.n_shards))
                derived_rows = 0
                for exchanged in staged:
                    for j, rows in enumerate(exchanged):
                        self.shards[j].append_derived(mode, rows)
                        derived_rows += int(rows.shape[0])
                    self.mat_counts[mode] += 1
                self._mat_cursor[mode] = n
                for K in self.shards:
                    K._bump()
            REGISTRY.histogram("shard/flush_s", mode=mode).observe(
                time.perf_counter() - t0)
            REGISTRY.counter("shard/derived_rows", mode=mode).inc(
                derived_rows)
        if self._pending and all(
                c >= n for c in self._mat_cursor.values()):
            self._pending.clear()
            self._mat_cursor = {m: 0 for m in self._mat_cursor}

    def _pending_rows(self, mode: str) -> int:
        if mode not in self._mat_cursor:
            return 0
        return sum(sum(int(p.shape[0]) for p in parts)
                   for parts in self._pending[self._mat_cursor[mode]:])

    # -- mutations -----------------------------------------------------------
    @property
    def delta_ratio(self) -> float:
        num = sum(self._pending_rows(m) for m in ("litemat", "full"))
        den = 0
        for K in self.shards:
            sizes = {"rewrite": K.kb.n,
                     "litemat": int(K.lite_spo.shape[0]),
                     "full": int(K.full_spo.shape[0])}
            den += sum(sizes.values())
            if K._delta is not None:
                for m in MODES:
                    num += K._delta.logs[m].n
                    if K._delta.base_alive[m] is not None:
                        num += sizes[m] - int(K._delta.base_alive[m].sum())
        return num / max(den, 1)

    def insert(self, raw, auto_compact: bool = True) -> dict:
        """Encode once (replicated dictionary), partition, append per shard.

        Commit-atomic: everything that can fail — the ``shard.ingest_encode``
        fault site, the host encode, the partition — runs BEFORE any shard
        log is touched; the per-shard appends are plain array concats.  The
        ingest retry loop relies on this: an exception here means nothing
        was committed and the published version is unchanged.
        """
        s_fp, p_fp, o_fp, strings = _raw_columns(raw)
        if s_fp.shape[0] == 0:
            return dict(n_inserted=0, n_new_terms=0)
        with self.write_lock:
            faults.fire("shard.ingest_encode", n=int(s_fp.shape[0]))
            spo, n_new = encode_delta(self._dyn, s_fp, p_fp, o_fp)
            parts = partition_rows(spo, self.n_shards)
            # -- commit point: nothing below raises -------------------------
            self._absorb(strings)
            for i, part in enumerate(parts):
                if part.shape[0]:
                    self.shards[i].append_raw(part)
                self.shards[i]._bump()
            self._pending.append(parts)
            self.n_new_terms += n_new
            self.version += 1
            stats = dict(
                n_inserted=int(spo.shape[0]), n_new_terms=n_new,
                n_pending_mat=sum(
                    self._pending_rows(m) for m in ("litemat", "full")),
                delta_ratio=round(self.delta_ratio, 4), version=self.version,
            )
            if auto_compact and self.delta_ratio > self.compact_threshold:
                stats["compacted"] = self.compact()
            return stats

    def delete(self, raw, auto_compact: bool = True) -> dict:
        """Coordinated delete: local tombstones, global repair frontier.

        Raw kills are shard-local (the triples live on their subject's
        shard); the affected-instance set is global, so every shard
        tombstones its derived mentions and contributes its live raw
        mentions to the frontier; the re-derived rows are exchanged back
        to their subjects' shards — the single-store delete's exact repair,
        distributed.
        """
        s_fp, p_fp, o_fp, _ = _raw_columns(raw)
        if s_fp.shape[0] == 0:
            return dict(n_deleted=0)
        with self.write_lock:
            self._flush("litemat", "full")
            ids = np.stack([self._dyn.lookup(s_fp), self._dyn.lookup(p_fp),
                            self._dyn.lookup(o_fp)], axis=1)
            q = ids[(ids >= 0).all(axis=1)]
            deleted = []
            for i, part in enumerate(partition_rows(q, self.n_shards)):
                if part.shape[0]:
                    d = self.shards[i].kill_raw_rows(part)
                    if d.shape[0]:
                        deleted.append(d)
            if not deleted:
                return dict(n_deleted=0)
            deleted = np.concatenate(deleted)
            inst = affected_instances(deleted, self.tbox.instance_base)

            frontier_src = []
            for K in self.shards:
                K.kill_derived_mentions(inst)
                frontier_src.append(K.live_raw_mentions(inst))
            for mode in ("litemat", "full"):
                derived_src = []
                for rows in frontier_src:
                    if rows.shape[0] == 0:
                        derived_src.append(_EMPTY)
                        continue
                    derived = materialize_delta_mode(rows, self.dtb, mode)
                    derived_src.append(derived[mentions_mask(derived, inst)])
                for j, rows in enumerate(
                        _exchange(derived_src, self.n_shards)):
                    self.shards[j].append_derived(mode, rows)
            for K in self.shards:
                K._bump()
            self.version += 1
            stats = dict(
                n_deleted=int(deleted.shape[0]),
                n_affected_instances=int(inst.shape[0]),
                delta_ratio=round(self.delta_ratio, 4), version=self.version,
            )
            if auto_compact and self.delta_ratio > self.compact_threshold:
                stats["compacted"] = self.compact()
            return stats

    def compact(self, device: bool | None = None) -> dict:
        """Fold every shard's overlay into fresh per-shard bases."""
        with self.write_lock:
            if (all(K._delta is None or K._delta.empty for K in self.shards)
                    and not self._pending):
                return dict(compacted=False)
            t0 = time.perf_counter()
            with obs_trace.span("compact", sharded=True,
                                n_shards=self.n_shards):
                self._flush("litemat", "full")
                sizes = {m: 0 for m in MODES}
                for K in self.shards:
                    out = K.compact(device=device)
                    for m in MODES:
                        sizes[m] += int(out.get(m, 0))
                self.version += 1
            REGISTRY.counter("shard/compactions").inc()
            REGISTRY.histogram("shard/compact_s").observe(
                time.perf_counter() - t0)
            return dict(compacted=True, version=self.version, **sizes)

    # -- query surface -------------------------------------------------------
    def engine(self, mode: str = "litemat",
               use_index: bool = True) -> "ShardedQueryEngine":
        key = (mode, use_index)
        if key not in self._engines:
            self._engines[key] = ShardedQueryEngine(
                skb=self, mode=mode, use_index=use_index)
        return self._engines[key]

    def query(self, patterns, select=None, mode: str = "litemat",
              use_index: bool = True):
        return self.engine(mode, use_index).run(patterns, select=select)

    def answers(self, patterns, select=None, mode: str = "litemat",
                use_index: bool = True) -> set:
        rows, _ = self.query(patterns, select=select, mode=mode,
                             use_index=use_index)
        return {tuple(r) for r in rows.tolist()}

    def prewarm(self, queries=None, modes=("litemat",), buckets=(),
                use_index: bool = True) -> int:
        queries = (list(queries) if queries is not None
                   else list(PAPER_QUERIES.values()))
        return sum(self.engine(m, use_index).prewarm(queries, buckets=buckets)
                   for m in modes)

    def warm_device(self, mode: str = "litemat", keys=("scan", "pos")):
        """Per-shard device warmup (the O(delta)-per-shard unit)."""
        if mode in ("litemat", "full"):
            self._flush(mode)
        return [K.warm_device(mode, keys=keys) for K in self.shards]

    def store_rows(self, mode: str = "litemat") -> torch.Tensor:
        """Live rows of one store, all shards concatenated (shard order)."""
        if mode in ("litemat", "full"):
            self._flush(mode)
        return torch.cat([K.store_rows(mode) for K in self.shards])

    # -- device resource accounting (obs/ledger.py feed) ---------------------
    def device_buffers(self) -> list:
        """The sharded engines' own device footprint beyond the per-shard
        stores (which each shard's KnowledgeBase reports): the stacked
        ``shard_map`` slabs, which the one-device dispatch loop never
        builds, so the list is empty."""
        return []

    def track_ledger(self) -> None:
        """Register with the process ledger: each shard's KnowledgeBase
        under its shard index (per-shard ``hbm_bytes{shard=i}`` and live
        triples), plus this store under ``shard="stack"``.  Idempotent;
        the ledger holds only weakrefs."""
        if self._ledger_handles:
            return
        self._ledger_handles = [
            LEDGER.track(str(i), K) for i, K in enumerate(self.shards)]
        self._ledger_handles.append(LEDGER.track("stack", self))

    def sizes(self) -> dict:
        out = {"original": 0, "lite": 0, "full": 0}
        for K in self.shards:
            s = K.sizes()
            out["original"] += s["original"]
            out["lite"] += s["lite"]
            out["full"] += s["full"]
        pending = sum(self._pending_rows(m) for m in ("litemat", "full"))
        delta = sum(K._delta.logs[m].n for K in self.shards
                    for m in MODES if K._delta is not None)
        if delta:
            out["delta_rows"] = delta
        if pending:
            out["delta_rows_pending_mat"] = pending
        return out


# ---------------------------------------------------------------------------
# Group planning and the host fold
# ---------------------------------------------------------------------------


def _is_type_pattern(pat: Pattern, tbox) -> bool:
    return (not is_var(pat.p)) and (
        pat.p in ("rdf:type", "a") or pat.p == tbox.rdf_type_id)


def plan_groups(patterns, mode: str, tbox) -> list:
    """Bucket pattern indices by co-hashed subject variable.

    A pattern binds its subject variable from the co-hashed subject column
    — EXCEPT rewrite-mode type patterns, whose range branch binds the
    object — so patterns sharing a subject variable evaluate and join
    entirely shard-local; everything else is a singleton group combined
    globally.
    """
    groups: dict = {}
    for idx, pat in enumerate(patterns):
        local = is_var(pat.s) and not (
            mode == "rewrite" and _is_type_pattern(pat, tbox)
            and not is_var(pat.o))
        key = ("var", pat.s) if local else ("solo", idx)
        groups.setdefault(key, []).append(idx)
    return list(groups.values())


def _merge_tree(runs: list, key_col: int) -> torch.Tensor:
    """Balanced pairwise fold of key-sorted [n, V] runs into ONE sorted run.

    log2(k) merge levels instead of a left-deep fold, so each row moves
    O(log k) times rather than O(k).  Each level pairs neighbours through
    ``ops.merge_gather`` (the merge-path kernel) over the key column as
    the ``hi`` plane with a zero ``lo`` plane, then one row gather;
    INVALID keys sort last, so padded rows sink to the fold's tail.
    Shared by the host fold and the repartition combine's shard-local fold
    of its received bins.
    """
    runs = list(runs)
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            a, b = runs[i], runs[i + 1]
            ka = a[:, key_col].contiguous()  # the kernel takes dense planes
            kb = b[:, key_col].contiguous()
            g = ops.merge_gather(ka, torch.zeros_like(ka), kb,
                                 torch.zeros_like(kb))
            nxt.append(ops.two_source_gather(a, b, g))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def _merge_shard_parts(parts: list, key_col: int, device) -> np.ndarray:
    """Fold per-shard result rows into one key-sorted host array.

    Each shard's rows sort locally (small — post-distinct relations), then
    fold on the device through the balanced ``_merge_tree`` — so the
    combined relation arrives presorted for the join's build side without
    a global re-sort, and the single pad to the join capacity happens once
    downstream in ``_host_relation``.
    """
    live = [p for p in parts if p.shape[0]]
    if not live:
        return np.zeros((0, parts[0].shape[1]), np.int32)
    runs = [torch.as_tensor(p[np.argsort(p[:, key_col], kind="stable")],
                            device=device)
            for p in live]
    return _merge_tree(runs, key_col).cpu().numpy()


def _host_relation(gvars: tuple, rows: np.ndarray, cap: int,
                   device) -> Relation:
    """(N, k) host rows -> INVALID-padded device Relation of capacity cap.

    The host fold's re-upload point: every merged relation crosses
    host->device here.  The repartition combine never calls it mid-join,
    which the ``device/transfer_bytes{src=combine_upload}`` counter shows.
    """
    n = rows.shape[0]
    cols = np.full((len(gvars), cap), INVALID, np.int32)
    cols[:, :n] = rows.T
    REGISTRY.counter("device/transfer_bytes",
                     src="combine_upload").inc(int(cols.nbytes))
    return Relation(
        vars=gvars, cols=torch.as_tensor(cols, device=device),
        valid=torch.arange(cap, device=device) < n,
        overflow=torch.tensor(max(n - cap, 0), dtype=torch.int32,
                              device=device))


def combine_groups(evaluated, patterns, select=None, max_retries: int = 6,
                   device="cpu"):
    """Fold per-group, per-shard result parts into the final distinct rows.

    ``evaluated`` is ``[(group_vars, [int32[k_i, |vars|] per shard]), ...]``
    in plan-group order.  Groups fold through presorted merge joins on
    ``device``, then one global distinct (cross-shard duplicates of
    object-keyed bindings collapse here) — shared by the live
    ShardedQueryEngine and the pinned snapshot reads (core/snapshot.py),
    so both produce the same rows from the same parts.
    """
    all_vars = tuple(dict.fromkeys(
        v for pat in patterns for v in (pat.s, pat.p, pat.o)
        if is_var(v)))
    sel = tuple(select) if select else all_vars

    order = sorted(range(len(evaluated)),
                   key=lambda i: sum(p.shape[0] for p in evaluated[i][1]))
    acc = None
    done = set()
    while len(done) < len(order):
        pick = None
        for i in order:
            if i in done:
                continue
            gvars = evaluated[i][0]
            if acc is None or set(gvars) & set(acc.vars):
                pick = i
                break
        if pick is None:
            raise ValueError(
                "cartesian products not supported — reorder the plan")
        done.add(pick)
        gvars, parts = evaluated[pick]
        total = sum(p.shape[0] for p in parts)
        if acc is None:
            cap = _pow2(total, floor=256)
            rows = (np.concatenate(parts) if parts
                    else np.zeros((0, len(gvars)), np.int32))
            acc = _host_relation(gvars, rows, cap, device)
            continue
        key = next(v for v in gvars if v in acc.vars)
        merged = _merge_shard_parts(
            parts, gvars.index(key), device) if parts else np.zeros(
            (0, len(gvars)), np.int32)
        rel = _host_relation(gvars, merged, _pow2(total, floor=256), device)
        jcap = _pow2(max(total, _acc_rows(acc), 1) * 2, floor=256)
        plabel = sig_label(tuple((p.s, p.p, p.o) for p in patterns))
        for attempt in range(max_retries):
            out = join(rel, acc, jcap, a_sorted=True)
            if int(out.overflow) == 0:
                if attempt:
                    REGISTRY.histogram("join/capacity_depth",
                                       site="host_fold", sig=plabel,
                                       key=key).observe(attempt)
                break
            # the host fold sees already-merged parts: no per-shard
            # overflow attribution exists, so the retry lands on "global"
            REGISTRY.counter("join/capacity_retry", site="host_fold",
                             sig=plabel, shard="global").inc()
            jcap *= 2
        else:
            raise RuntimeError("sharded join kept overflowing")
        acc = out
    out = distinct(acc, sel, _pow2(_acc_rows(acc), floor=256))
    n = int(out.valid.sum())
    return out.cols[:, :n].T.cpu().numpy(), sel


def _acc_rows(rel: Relation) -> int:
    return int(rel.valid.sum())


def _group_vars(gpats) -> tuple:
    return tuple(dict.fromkeys(
        v for pat in gpats for v in (pat.s, pat.p, pat.o) if is_var(v)))


# ---------------------------------------------------------------------------
# The repartition combine, single-device form
# ---------------------------------------------------------------------------


def _hash32(key: torch.Tensor) -> torch.Tensor:
    """``uint32(key) * 0x9E3779B1 >> 16`` with the product wrapped to 32
    bits, as int64 (the multiply split at 16 bits so nothing overflows)."""
    k = key.to(torch.int64) & 0xFFFFFFFF
    lo = (k & 0xFFFF) * 0x9E3779B1
    hi = ((k >> 16) * 0x9E3779B1) & 0xFFFF
    return ((lo + (hi << 16)) & 0xFFFFFFFF) >> 16


def _bin_by_key(cols: torch.Tensor, valid: torch.Tensor, key_idx: int,
                n_shards: int) -> torch.Tensor:
    """Route one shard's relation rows to hash(join key) partitions.

    ``cols`` int32[V, cap] / ``valid`` bool[cap] -> int32[S, cap, V] send
    bins: bin t holds this shard's rows whose key hashes to t, ascending
    by key, INVALID-padded.  A bin never overflows its ``cap`` slots — the
    source shard holds at most ``cap`` rows in total — and invalid rows
    route nowhere.
    """
    n_vars, cap = cols.shape
    key = torch.where(valid, cols[key_idx], INVALID)
    tgt = torch.where(valid & (key != INVALID),
                      _hash32(key) % n_shards, n_shards)
    order = torch.sort(key, stable=True).indices  # (tgt, key) lex order
    order = order[torch.sort(tgt[order], stable=True).indices]
    tgt_s = tgt[order]
    rows_s = cols.T[order]
    first = torch.searchsorted(
        tgt_s, torch.arange(n_shards, dtype=torch.int64, device=cols.device))
    slot = (torch.arange(cap, dtype=torch.int64, device=cols.device)
            - first[tgt_s.clamp(0, n_shards - 1)])
    idx = torch.where(tgt_s < n_shards, tgt_s * cap + slot, n_shards * cap)
    flat = torch.full((n_shards * cap + 1, n_vars), INVALID,
                      dtype=torch.int32, device=cols.device)
    flat[idx] = rows_s  # slot S * cap catches the invalid rows
    return flat[:-1].reshape(n_shards, cap, n_vars)


def _stack_parts(parts: list, n_vars: int, n_shards: int, device):
    """Host result parts -> stacked [S, V, cap] device relation.

    The repartition fold doesn't care how rows were distributed before the
    exchange (bins are computed from the rows themselves), so parts slot
    round-robin: the dispatch loop's entry into the device combine.
    """
    cap = _pow2(max((p.shape[0] for p in parts), default=1), floor=256)
    cols = np.full((n_shards, n_vars, cap), INVALID, np.int32)
    valid = np.zeros((n_shards, cap), bool)
    for i, p in enumerate(parts):
        j = i % n_shards
        cols[j, :, :p.shape[0]] = p.T
        valid[j, :p.shape[0]] = True
    return (torch.as_tensor(cols, device=device),
            torch.as_tensor(valid, device=device))


def _repartition_join(acc, rel, key, jcap: int):
    """One hash-repartition join step over stacked relations.

    ``acc`` and ``rel`` are ``(vars, cols int32[S, V, cap], valid
    bool[S, cap])``.  Both sides bin by hash(join key); the bins swap on
    the shard axis (the all-to-all of a device per shard, done in place on
    one device); then each shard folds its received key-sorted runs with
    the balanced merge tree and runs the presorted merge join locally.
    Matching rows co-hash, so the per-shard join outputs union to exactly
    the global join.  Returns the stacked ``(vars, cols, valid)`` and the
    per-shard overflow int32[S].
    """
    (avars, ac, av), (rvars, rc, rv) = acc, rel
    S = ac.shape[0]
    ai, ri = avars.index(key), rvars.index(key)
    arecv = torch.stack([_bin_by_key(ac[i], av[i], ai, S)
                         for i in range(S)]).transpose(0, 1)  # [dst, src]
    rrecv = torch.stack([_bin_by_key(rc[i], rv[i], ri, S)
                         for i in range(S)]).transpose(0, 1)
    zero = torch.zeros((), dtype=torch.int32, device=ac.device)
    outs = []
    for i in range(S):
        m = _merge_tree(list(rrecv[i]), ri)
        af = arecv[i].reshape(-1, len(avars))
        outs.append(join(
            Relation(vars=rvars, cols=m.T, valid=m[:, ri] != INVALID,
                     overflow=zero),
            Relation(vars=avars, cols=af.T, valid=af[:, ai] != INVALID,
                     overflow=zero),
            jcap, a_sorted=True))
    return ((outs[0].vars, torch.stack([o.cols for o in outs]),
             torch.stack([o.valid for o in outs])),
            torch.stack([o.overflow for o in outs]))


def _distinct_per_shard(rel, sel, cap: int):
    """DISTINCT projection of each shard's slice of a stacked relation."""
    rvars, cols, valid = rel
    zero = torch.zeros((), dtype=torch.int32, device=cols.device)
    outs = [distinct(Relation(vars=rvars, cols=c, valid=v, overflow=zero),
                     sel, cap)
            for c, v in zip(cols, valid)]
    return (torch.stack([o.cols for o in outs]),
            torch.stack([o.valid for o in outs]))


# ---------------------------------------------------------------------------
# ShardedQueryEngine: group-local plans, global combine
# ---------------------------------------------------------------------------


@dataclass
class ShardedQueryEngine:
    """Executes conjunctive plans across a ShardedKB's shards.

    Subject-co-hashed groups run the full per-shard QueryEngine plans
    through a per-shard dispatch loop, over the live shards' own engines
    or, for a snapshot (core/snapshot.py), over ``pinned`` per-shard
    engines bound to its views: live and pinned reads share one loop.
    Cross-group joins combine either by the host fold (gather the
    per-shard relations, fold them key-sorted with the merge-path kernel,
    presorted merge join + distinct) or, with ``use_repartition_join``,
    by the repartition combine (bin both sides by a hash of the join key,
    swap the bins on the shard axis, join per shard) — both equal to the
    single store.
    """

    skb: ShardedKB
    mode: str = "litemat"
    use_index: bool = True
    pinned: list | None = None  # per-shard engines over pinned views
    use_shard_map: bool = False  # True raises: port slice 6b
    use_repartition_join: bool = False
    cache_stats: dict = field(
        default_factory=lambda: {"loop_runs": 0, "repartition_runs": 0,
                                 "exchange_faults": 0},
        repr=False)

    def _engines(self) -> list:
        if self.pinned is not None:
            return self.pinned
        return [K.engine(self.mode, self.use_index) for K in self.skb.shards]

    def _sync(self) -> None:
        """Derive the live store's backlog: plans must see the stores they
        run against.  A pinned read sees the views its snapshot captured."""
        if self.pinned is None and self.mode in ("litemat", "full"):
            self.skb._flush(self.mode)

    def prewarm(self, queries, buckets=(), select=None) -> int:
        self._sync()
        n = 0
        for pats in queries:
            for g in plan_groups(pats, self.mode, self.skb.tbox):
                gpats = [pats[i] for i in g]
                gvars = _group_vars(gpats)
                for eng in self._engines():
                    if eng.view.n:
                        n += eng.prewarm([gpats], buckets=buckets,
                                         select=gvars)
        return n

    # -- group evaluation ----------------------------------------------------
    def _route_shards(self, gpats, engines=None) -> list:
        """Constant-subject singleton groups touch only their owner shard."""
        if len(gpats) == 1 and not is_var(gpats[0].s):
            engines = engines or self._engines()
            try:
                t = engines[0]._resolve(
                    gpats[0].s, "s",
                    _is_type_pattern(gpats[0], self.skb.tbox))
            except KeyError:
                return list(range(self.skb.n_shards))
            if t.hi == t.lo + 1 and not t.spills and t.members is None:
                return [int(shard_of(np.asarray([t.lo]),
                                     self.skb.n_shards)[0])]
        return list(range(self.skb.n_shards))

    def _run_group(self, gpats, gvars) -> list:
        """Per-shard dispatch: each routed shard's engine runs the group
        plan (the ``shard.query_shard`` fault site); a shard whose view is
        empty is skipped.  Returns the non-empty per-shard parts."""
        if self.use_shard_map:
            raise NotImplementedError(_NO_SHARD_MAP)
        self.cache_stats["loop_runs"] += 1
        REGISTRY.counter("shard/group_runs", path="loop").inc()
        engines = self._engines()
        parts = []
        with obs_trace.span("shard_dispatch", path="loop",
                            n_shards=self.skb.n_shards):
            for i in self._route_shards(gpats, engines):
                if engines[i].view.n == 0:
                    continue
                faults.fire("shard.query_shard", shard=i)
                rows, _ = engines[i].run(gpats, select=gvars)
                if rows.shape[0]:
                    parts.append(np.asarray(rows, dtype=np.int32))
        return parts

    # -- the repartition combine ---------------------------------------------
    def _run_repartition(self, patterns, groups, select, max_retries):
        """Evaluate groups, fold them with the repartition combine."""
        evaluated = []
        with obs_trace.span("shard_combine", path="repartition",
                            n_groups=len(groups)):
            for g in groups:
                gpats = [patterns[i] for i in g]
                gvars = _group_vars(gpats)
                cols, valid = _stack_parts(self._run_group(gpats, gvars),
                                           len(gvars), self.skb.n_shards,
                                           self.skb.device)
                evaluated.append((gvars, cols, valid))
            return self._combine_groups_device(evaluated, patterns, select,
                                               max_retries)

    def _combine_groups_device(self, evaluated, patterns, select,
                               max_retries):
        """Fold stacked per-shard group results on the device.

        Mirrors ``combine_groups``' order (fewest rows first, greedy
        connected) and capacities, but every cross-group join runs as a
        hash-repartition join: intermediate relations stay stacked on the
        device between steps.  Only the final per-shard DISTINCT rows come
        back, and one host sorted-unique pass reproduces the global
        distinct's lexicographic order.
        """
        all_vars = tuple(dict.fromkeys(
            v for pat in patterns for v in (pat.s, pat.p, pat.o)
            if is_var(v)))
        sel = tuple(select) if select else all_vars
        totals = [int(valid.sum()) for _, _, valid in evaluated]
        order = sorted(range(len(evaluated)), key=lambda i: totals[i])
        acc = None  # (vars, cols [S, V, cap], valid [S, cap])
        done = set()
        while len(done) < len(order):
            pick = None
            for i in order:
                if i in done:
                    continue
                if acc is None or set(evaluated[i][0]) & set(acc[0]):
                    pick = i
                    break
            if pick is None:
                raise ValueError(
                    "cartesian products not supported — reorder the plan")
            done.add(pick)
            if acc is None:
                acc = evaluated[pick]
                continue
            rel = evaluated[pick]
            key = next(v for v in rel[0] if v in acc[0])
            faults.fire("shard.exchange")
            jcap = _pow2(max(totals[pick], int(acc[2].sum()), 1) * 2,
                         floor=256)
            plabel = sig_label(tuple((p.s, p.p, p.o) for p in patterns))
            for attempt in range(max_retries):
                out, ovf = _repartition_join(acc, rel, key, jcap)
                ovf = ovf.cpu().numpy().reshape(-1)
                if int(ovf.max()) == 0:
                    if attempt:
                        REGISTRY.histogram(
                            "join/capacity_depth", site="repartition",
                            sig=plabel, key=key).observe(attempt)
                    break
                for i in np.nonzero(ovf)[0]:
                    REGISTRY.counter("join/capacity_retry",
                                     site="repartition", sig=plabel,
                                     shard=str(int(i))).inc()
                jcap *= 2
            else:
                raise RuntimeError("sharded join kept overflowing")
            acc = out
        self.cache_stats["repartition_runs"] += 1
        REGISTRY.counter("shard/combine_runs", path="repartition").inc()
        # per-shard distinct shrinks the readback; identical sel-tuples can
        # still straddle shards when sel drops the last join key, so one
        # host sorted-unique pass finishes the global dedup in the same
        # ascending-lexicographic order `distinct` emits
        dcols, dvalid = _distinct_per_shard(acc, sel, int(acc[1].shape[2]))
        counts = dvalid.sum(1).tolist()
        dcols = dcols.cpu().numpy()
        parts = [dcols[i][:, :n].T for i, n in enumerate(counts) if n]
        if not parts:
            return np.zeros((0, len(sel)), np.int32), sel
        return np.unique(np.concatenate(parts), axis=0), sel

    # -- the full query ------------------------------------------------------
    def run(self, patterns, select=None, max_retries: int = 6):
        """Execute; returns (rows int32[k, n_select], select var names).

        Same contract as QueryEngine.run: rows are DISTINCT bindings of the
        selected variables, in the global lexicographic order the distinct
        pass produces — equal to the single store's given the same
        ``select``.  Multi-group plans fold through the repartition
        combine when it is on, degrading to the host fold on an exchange
        fault (``FaultError`` only: a kernel that fails raises).
        """
        patterns = list(patterns)
        self._sync()
        groups = plan_groups(patterns, self.mode, self.skb.tbox)
        if len(groups) > 1 and self.use_repartition_join:
            try:
                return self._run_repartition(patterns, groups, select,
                                             max_retries)
            except FaultError:
                self.cache_stats["exchange_faults"] += 1
                REGISTRY.counter("shard/exchange_faults").inc()
                obs_trace.event("repartition_fallback")
            REGISTRY.counter("shard/combine_runs", path="host_fallback").inc()
        else:
            REGISTRY.counter("shard/combine_runs", path="host").inc()
        evaluated = []
        for g in groups:
            gpats = [patterns[i] for i in g]
            gvars = _group_vars(gpats)
            evaluated.append((gvars, self._run_group(gpats, gvars)))
        return combine_groups(evaluated, patterns, select,
                              max_retries=max_retries,
                              device=self.skb.device)

    def run_batch(self, requests, max_retries: int = 6) -> list:
        """Evaluate (patterns, select) requests together; returns each
        request's (rows, select).

        Every member is decomposed into its pattern groups, and ALL
        members' groups routed to a shard ride one ``run_batch`` there —
        same-signature groups from different requests coalesce inside
        that shard's engine — before each member combines its own groups
        through the host fold.
        """
        self._sync()
        members, flat = [], []  # (patterns, select, [flat idx]); groups
        for pats, select in requests:
            pats = list(pats)
            idxs = []
            for g in plan_groups(pats, self.mode, self.skb.tbox):
                gpats = [pats[i] for i in g]
                idxs.append(len(flat))
                flat.append((gpats, _group_vars(gpats)))
            members.append((pats, select, idxs))
        engines = self._engines()
        routes = [self._route_shards(gpats, engines) for gpats, _ in flat]
        parts = [[] for _ in flat]
        with obs_trace.span("shard_dispatch", path="batch",
                            n_groups=len(flat), n_shards=len(engines)):
            for i, eng in enumerate(engines):
                mine = [f for f, r in enumerate(routes) if i in r]
                if not mine or eng.view.n == 0:
                    continue
                faults.fire("shard.query_shard", shard=i)
                res = eng.run_batch([flat[f] for f in mine],
                                    max_retries=max_retries)
                for f, (rows, _) in zip(mine, res):
                    if rows.shape[0]:
                        parts[f].append(np.asarray(rows, dtype=np.int32))
        return [combine_groups([(flat[f][1], parts[f]) for f in idxs],
                               pats, select, max_retries=max_retries,
                               device=self.skb.device)
                for pats, select, idxs in members]


def is_sharded(kb) -> bool:
    """Whether a store is a :class:`ShardedKB`: the one test that picks
    the sharded arm of the snapshots, the runtime and the servers."""
    return isinstance(kb, ShardedKB)


def assert_partitioned(skb: ShardedKB) -> None:
    """Test hook: every live row of every store sits on its subject's shard."""
    for mode in MODES:
        if mode in ("litemat", "full"):
            skb._flush(mode)
        for i, K in enumerate(skb.shards):
            rows = K.store_rows(mode).cpu().numpy()
            if rows.shape[0] == 0:
                continue
            sh = shard_of(rows[:, 0], skb.n_shards)
            assert (sh == i).all(), (mode, i, rows[sh != i][:5])


__all__ = ["ShardedKB", "ShardedQueryEngine", "IngestReport", "shard_of",
           "partition_rows", "plan_groups", "combine_groups",
           "assert_partitioned", "is_sharded"]
