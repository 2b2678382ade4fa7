"""Sharded stores: the ABox subject-hash partitioned over devices.

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
key, exchanges the bins between the shards' devices and joins every
shard's bins locally.  Rewrite-mode type patterns bind ``?x`` from BOTH
endpoints (the range branch binds the object), so they are never
co-hashed.

Placement
---------
Shard i lives on ``devices[i % n]`` (``shard_devices()``): by default
every visible card, ``cuda:0`` .. ``cuda:{n-1}``, or in a process of the
multi-process runtime (distributed/runtime.py) that process's own cards;
on the CPU the one ``cpu``.  Each device in use holds a replica of the
DeviceTBox and the term dictionary; ``devices[0]``, the home device, also
holds the global encode and the host fold's merges.  Every build, write
and query step of a shard runs with its device current (``_device_ctx``).

A group runs on every routed shard at once: each shard's plan is made on
the host, then every plan body is enqueued on its shard's device with no
host sync between shards, and only then are the outcomes read.  Results
stay on the devices for the repartition combine, whose bins cross
devices through the all-to-all of core/exchange.py (copying nothing
between shards that share a device).  Inserts take the sharded
dictionary encode (core/dictionary.py) when it is on.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.abox import EncodedKB, encode_obe, tbox_term_map
from repro_torch.core.closure import full_materialize
from repro_torch.core.delta import MODES
from repro_torch.core.dictionary import (
    SENTINEL, sharded_dictionary_fn, table_from_host,
)
from repro_torch.core.exchange import all_to_all, device_ctx
from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase, _raw_columns
from repro_torch.core.index import pow2_bucket as _pow2
from repro_torch.core.materialize import DeviceTBox, compact_rows, lite_materialize
from repro_torch.core.query import (
    INVALID, Pattern, Relation, distinct, is_var, join, sig_label,
)
from repro_torch.core.tbox import TBox, build_tbox
from repro_torch.device import resolve_device
from repro_torch.core.update import (
    DynamicDictionary, affected_instances, encode_delta,
    materialize_delta_mode, mentions_mask,
)
from repro_torch.distributed import runtime
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.ledger import LEDGER
from repro_torch.obs.metrics import REGISTRY
from repro_torch.testing import faults
from repro_torch.testing.faults import FaultCrash, FaultError
from repro_torch.utils import pair64

_EMPTY = np.zeros((0, 3), dtype=np.int32)
_HASH_MULT = np.uint64(0x9E3779B1)  # Fibonacci multiplicative hash


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


def _resolve_devices(devices=None, device=None) -> list:
    """The store's distinct devices, CUDA ones with their index.

    ``devices`` names them; else ``device`` names the one device every
    shard shares; else, in a process of the multi-process runtime, the
    process's own devices (``runtime.local_devices()``, the reference's
    ``_local_mesh``); else every visible card, which must exist (as
    ``device.resolve_device``: CPU callers say so).
    """
    if devices is None and device is None and runtime.is_initialized():
        devices = runtime.local_devices()
    elif devices is None:
        home = resolve_device(device)  # None: CUDA, which must exist
        devices = (range(torch.cuda.device_count())
                   if device is None and home.type == "cuda" else [home])
    out = []
    for d in devices:
        d = torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d not in out:
            out.append(d)
    if not out:
        raise ValueError("a sharded store needs at least one device")
    return out


def _replica(obj, device: torch.device):
    """A dataclass of tensors (DeviceTBox, TermTable) with every tensor on
    ``device``; itself when it is already there."""
    moved = {f.name: v.to(device) for f in dataclasses.fields(obj)
             if isinstance(v := getattr(obj, f.name), torch.Tensor)
             and v.device != device}
    return dataclasses.replace(obj, **moved) if moved else obj


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

    shards: list  # per-shard KnowledgeBase, shard i on shard_devices()[i]
    dtb: DeviceTBox  # the home device's replica
    n_shards: int
    device: torch.device  # the home device, devices[0]
    devices: list = field(default_factory=list)  # distinct, in shard order
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
    # the sharded dictionary encode (paper §III.B) for inserts: None is
    # auto (a device per shard), True forces it, False keeps the host
    # encode.  Ids then assign in hash-partitioned owner order, not global
    # fp-rank order, so a built store keeps the host encode (its id-space
    # parity with a single KnowledgeBase) and ``ingest`` takes auto
    use_sharded_encode: bool | None = False

    # -- construction --------------------------------------------------------
    @classmethod
    def _placed(cls, tbox: TBox, n_shards, devices: list, tables: tuple):
        """A store without shards yet, placed on ``devices`` (resolved),
        with one (DeviceTBox, dictionary tables) replica per device in use:
        -> (store, per shard its device's replica)."""
        n_shards = n_shards or len(devices)
        dtb = DeviceTBox.build(tbox, device=devices[0])
        skb = cls(shards=[], dtb=dtb, n_shards=n_shards, device=devices[0],
                  devices=devices[:n_shards])
        reps = {d: (_replica(dtb, d), tuple(_replica(t, d) for t in tables))
                for d in skb.devices}
        return skb, [reps[d] for d in skb.shard_devices()]

    @classmethod
    def build(cls, raw, tbox: TBox | None = None, n_shards: int | None = None,
              parallel_tbox: bool = False, device=None,
              devices=None) -> "ShardedKB":
        """Encode + partition + per-shard materialize (with exchange).

        The encode runs once for the whole dataset on the home device (ids
        equal the single store's); the lite/full materializers then run per
        shard over that shard's raw partition on its device, and the
        derived rows are exchanged to THEIR subject's shard.  Per-shard MSC
        may keep a concept alongside a descendant another shard holds —
        answer-equivalent under interval evaluation, the invariant the
        incremental insert relies on too.
        """
        devices = _resolve_devices(devices, device)
        tbox = tbox or build_tbox(raw.onto, parallel=parallel_tbox)
        kbg = encode_obe(raw, tbox, device=devices[0])
        skb, reps = cls._placed(tbox, n_shards, devices, kbg.tables)
        parts = partition_rows(kbg.spo.cpu().numpy(), skb.n_shards)

        lite_src, full_src, built = [], [], []
        for i, part in enumerate(parts):
            dtb_i, tables_i = reps[i]
            with skb._device_ctx(i):
                kb_i = EncodedKB(
                    spo=torch.as_tensor(part, device=skb.shard_device(i)),
                    tables=tables_i, tbox=tbox,
                    n_instance_terms=kbg.n_instance_terms,
                    term_strings=kbg.term_strings)
                if part.shape[0]:
                    lite, lv, lstats = lite_materialize(kb_i, dtb_i)
                    lite_src.append(compact_rows(lite, lv).cpu().numpy())
                    del lite, lv
                    full, fv, fstats = full_materialize(kb_i, dtb_i)
                    full_src.append(compact_rows(full, fv).cpu().numpy())
                    del full, fv
                else:
                    lstats = fstats = {}
                    lite_src.append(_EMPTY)
                    full_src.append(_EMPTY)
            built.append((kb_i, lstats, fstats))
        lite_parts = _exchange(lite_src, skb.n_shards)
        full_parts = _exchange(full_src, skb.n_shards)
        for i, (kb_i, lstats, fstats) in enumerate(built):
            d = skb.shard_device(i)
            with skb._device_ctx(i):
                skb.shards.append(KnowledgeBase(
                    kb=kb_i, dtb=reps[i][0],
                    lite_spo=torch.as_tensor(lite_parts[i], device=d),
                    full_spo=torch.as_tensor(full_parts[i], device=d),
                    lite_stats=lstats, full_stats=fstats))
        skb._share_dictionary(DynamicDictionary.from_kb(kbg))
        return skb

    @classmethod
    def empty(cls, tbox: TBox, n_shards: int | None = None, device=None,
              devices=None) -> "ShardedKB":
        """Shards over an empty ABox — the bulk-ingest starting point."""
        devices = _resolve_devices(devices, device)
        fps, ids = tbox_term_map(tbox)
        skb, reps = cls._placed(
            tbox, n_shards, devices,
            (table_from_host(fps, ids, device=devices[0]),))
        for i, (dtb_i, tables_i) in enumerate(reps):
            d = skb.shard_device(i)
            with skb._device_ctx(i):
                kb_i = EncodedKB(spo=torch.as_tensor(_EMPTY, device=d),
                                 tables=tables_i, tbox=tbox,
                                 n_instance_terms=0)
                skb.shards.append(KnowledgeBase(
                    kb=kb_i, dtb=dtb_i,
                    lite_spo=torch.as_tensor(_EMPTY, device=d),
                    full_spo=torch.as_tensor(_EMPTY, device=d),
                    lite_stats={}, full_stats={}))
        skb._share_dictionary(DynamicDictionary.from_kb(skb.shards[0].kb))
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
               seed: int = 0, device=None, devices=None,
               use_sharded_encode: bool | None = None) -> "ShardedKB":
        """Bulk-load an iterable of raw parts, never materializing globally.

        Each part (RawDataset or (s, p, o) fingerprint columns) is encoded
        against the growing replicated dictionary — through the sharded
        dictionary encode when it is on (``use_sharded_encode``: None is
        auto, a device per shard) — hash-partitioned by subject, and
        appended to the per-shard raw logs; lite/full derivation is lazy
        per mode AND per shard (``_flush``).

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
        skb = cls.empty(tbox, n_shards=n_shards, device=device,
                        devices=devices)
        skb.use_sharded_encode = use_sharded_encode
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

    def shard_device(self, i: int) -> torch.device:
        return self.devices[i % len(self.devices)]

    def shard_devices(self) -> list:
        """Shard i's device, for every shard: ``devices[i % n]``."""
        return [self.shard_device(i) for i in range(self.n_shards)]

    def _device_ctx(self, i: int):
        """Shard i's device current on this thread for a block."""
        return device_ctx(self.shard_device(i))

    def device_per_shard(self) -> bool:
        """Whether every shard has a device of its own (and there are
        several): the automatic rule of the device path, the repartition
        combine and the sharded encode."""
        return len(self.devices) >= self.n_shards > 1

    def _sharded_encode_on(self) -> bool:
        if self.use_sharded_encode is not None:
            return self.use_sharded_encode
        return self.device_per_shard()

    def _encode_sharded(self, s_fp, p_fp, o_fp):
        """The sharded dictionary encode (the paper's §III.B) of a part.

        Predicates validate against the host mirror (the TBox-fixed OBE
        invariant ``encode_delta`` enforces); known s/o terms resolve by
        one host lookup; the UNKNOWN tail goes through one
        ``sharded_dictionary_fn`` pass over the shards' devices — hash-
        partition to owner shards, per-owner unique + all-gathered prefix
        sums of the counts as id ranges, reverse all-to-all — and the
        assigned (fp, id) pairs splice back into the host mirror through
        :meth:`DynamicDictionary.register`, so absorb, lookup and later
        host encodes see exactly the same dictionary.
        """
        p_ids = self._dyn.lookup(p_fp)
        bad = (p_ids < 0) | (p_ids >= self._dyn.instance_base)
        if bad.any():
            raise ValueError(
                "delta contains predicates outside the TBox property map — "
                "schema growth needs a re-encode (KnowledgeBase.build), the "
                "incremental path only grows the ABox")
        so_fp = np.concatenate([s_fp, o_fp])
        so_ids = self._dyn.lookup(so_fp)
        missing = so_ids < 0
        n_new = 0
        if missing.any():
            hi, lo = pair64.split_np(so_fp[missing])
            S, n = self.n_shards, hi.shape[0]
            cap = _pow2(-(-n // S), floor=256)
            hi_p = np.full(S * cap, SENTINEL, np.int32)
            lo_p = np.full(S * cap, SENTINEL, np.int32)
            valid = np.zeros(S * cap, bool)
            hi_p[:n], lo_p[:n], valid[:n] = hi, lo, True
            devs = self.shard_devices()

            def cut(a):  # shard i's cap slots, on its device
                return [torch.as_tensor(a[i * cap:(i + 1) * cap], device=d)
                        for i, d in enumerate(devs)]

            occ, tables, overflow, _ = sharded_dictionary_fn(
                cut(hi_p), cut(lo_p), cut(valid), devs, cap, base=0)
            if int(sum(int(o) for o in overflow)):
                # a source shard holds at most cap occurrences and every
                # bin holds cap slots, so this is unreachable; guard the
                # invariant rather than silently dropping terms
                raise RuntimeError("sharded encode owner bins overflowed")
            base = self._dyn.next_id
            occ = torch.cat([o.cpu() for o in occ]).numpy()[:n] + base
            thi, tlo, tids = (torch.cat([t[k].cpu() for t in tables]).numpy()
                              for k in range(3))
            real = tids >= 0
            fps_r = pair64.combine_np(thi[real], tlo[real])
            ufp, uidx = np.unique(fps_r, return_index=True)
            n_new = self._dyn.register(ufp, tids[real][uidx] + base)
            so_ids = so_ids.copy()
            so_ids[missing] = occ.astype(np.int32)
        s_ids, o_ids = np.split(so_ids, 2)
        spo = np.stack([s_ids, p_ids, o_ids], axis=1).astype(np.int32)
        return spo, n_new

    def _absorb(self, strings=None) -> int:
        """Fold freshly allocated dictionary terms into EVERY shard: one
        table chunk per device in use, shared by its shards."""
        chunk = self._dyn.take_new_terms()
        if chunk is None:
            return 0
        fps, ids = chunk
        tbls = {d: table_from_host(fps, ids, device=d) for d in self.devices}
        for i, K in enumerate(self.shards):
            K.kb.tables = (*K.kb.tables, tbls[self.shard_device(i)])
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

        Each shard's share of the backlog is materialized on that shard's
        device (row-local derivation), then the derived rows are exchanged to
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
                        with self._device_ctx(i):
                            derived_src.append(materialize_delta_mode(
                                part, self.shards[i].dtb, mode))
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
            if self._sharded_encode_on():
                spo, n_new = self._encode_sharded(s_fp, p_fp, o_fp)
                REGISTRY.counter("shard/encode_runs", path="sharded").inc()
            else:
                spo, n_new = encode_delta(self._dyn, s_fp, p_fp, o_fp)
                REGISTRY.counter("shard/encode_runs", path="host").inc()
            parts = partition_rows(spo, self.n_shards)
            # -- commit point: nothing below raises -------------------------
            self._absorb(strings)
            for i, part in enumerate(parts):
                if part.shape[0]:
                    with self._device_ctx(i):
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
                    with self._device_ctx(i):
                        d = self.shards[i].kill_raw_rows(part)
                    if d.shape[0]:
                        deleted.append(d)
            if not deleted:
                return dict(n_deleted=0)
            deleted = np.concatenate(deleted)
            inst = affected_instances(deleted, self.tbox.instance_base)

            frontier_src = []
            for i, K in enumerate(self.shards):
                with self._device_ctx(i):
                    K.kill_derived_mentions(inst)
                    frontier_src.append(K.live_raw_mentions(inst))
            for mode in ("litemat", "full"):
                derived_src = []
                for i, rows in enumerate(frontier_src):
                    if rows.shape[0] == 0:
                        derived_src.append(_EMPTY)
                        continue
                    with self._device_ctx(i):
                        derived = materialize_delta_mode(
                            rows, self.shards[i].dtb, mode)
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
                for i, K in enumerate(self.shards):
                    with self._device_ctx(i):
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
        out = []
        for i, K in enumerate(self.shards):
            with self._device_ctx(i):
                out.append(K.warm_device(mode, keys=keys))
        return out

    def store_rows(self, mode: str = "litemat") -> torch.Tensor:
        """Live rows of one store, all shards concatenated (shard order),
        on the home device."""
        if mode in ("litemat", "full"):
            self._flush(mode)
        return torch.cat([K.store_rows(mode).to(self.device)
                          for K in self.shards])

    # -- device resource accounting (obs/ledger.py feed) ---------------------
    def device_buffers(self) -> list:
        """The sharded engines' own device footprint beyond the per-shard
        stores (which each shard's KnowledgeBase reports, on its own
        device): the reference's stacked ``shard_map`` slabs, which the
        port never builds (each shard's own views and device caches are
        the device path's inputs), so the list is empty."""
        return []

    def track_ledger(self) -> None:
        """Register with the process ledger: each shard's KnowledgeBase
        under its shard index (per-shard ``hbm_bytes{shard=i}`` and live
        triples; its records keyed by its own device's storages), plus
        this store under ``shard="stack"``.  Idempotent; the ledger holds
        only weakrefs."""
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
# The repartition combine
# ---------------------------------------------------------------------------


def _hash32(key: torch.Tensor) -> torch.Tensor:
    """``uint32(key) * 0x9E3779B1 >> 16`` with the product wrapped to 32
    bits, as int64 (the multiply split at 16 bits so nothing overflows)."""
    k = key.to(torch.int64) & 0xFFFFFFFF
    lo = (k & 0xFFFF) * 0x9E3779B1
    hi = ((k >> 16) * 0x9E3779B1) & 0xFFFF
    return ((lo + (hi << 16)) & 0xFFFFFFFF) >> 16


def _bin_by_key(cols: torch.Tensor, valid: torch.Tensor, key_idx: int,
                n_shards: int):
    """Route one shard's relation rows to hash(join key) partitions.

    ``cols`` int32[V, cap] / ``valid`` bool[cap] -> (rows int32[cap, V],
    counts int64[S]): the rows ordered by (target partition, key), so
    partition t's rows are the ``counts[t]`` rows after those of the
    partitions before it, ascending by key; invalid rows route nowhere
    and sort last.
    """
    key = torch.where(valid, cols[key_idx], INVALID)
    tgt = torch.where(valid & (key != INVALID),
                      _hash32(key) % n_shards, n_shards)
    order = torch.sort(key, stable=True).indices  # (tgt, key) lex order
    order = order[torch.sort(tgt[order], stable=True).indices]
    counts = torch.bincount(tgt, minlength=n_shards + 1)[:n_shards]
    return cols.T[order], counts


def _split_bins(binned: list, home: torch.device) -> list:
    """Per source shard its ``_bin_by_key`` output -> per source the list
    of its bins, bin t holding exactly the rows bound for shard t: the
    sources' counts come to the host in one read, so a bin carries no
    padding across the exchange."""
    counts = torch.stack([c.to(home, non_blocking=True)
                          for _, c in binned]).tolist()
    out = []
    for (rows, _), cnt in zip(binned, counts):
        ends = np.cumsum(cnt)
        out.append([rows[e - c:e] for c, e in zip(cnt, ends.tolist())])
    return out


def _empty_relation(n_vars: int, device):
    """A shard's relation that holds no row: one INVALID slot."""
    return (torch.full((n_vars, 1), INVALID, dtype=torch.int32,
                       device=device),
            torch.zeros(1, dtype=torch.bool, device=device))


def _padded(rows: torch.Tensor) -> torch.Tensor:
    """A received relation's rows, one INVALID row where there are none:
    a relation holds at least one slot."""
    if rows.shape[0]:
        return rows
    return torch.full((1, rows.shape[1]), INVALID, dtype=torch.int32,
                      device=rows.device)


def _repartition_join(acc, rel, key, jcap: int, devices: list):
    """One hash-repartition join step over per-shard relations.

    ``acc`` and ``rel`` are ``(vars, [cols int32[V, cap_i]], [valid
    bool[cap_i]])``, shard i's on ``devices[i]``.  Each shard bins both
    sides by hash(join key) on its device; one host read of every bin's
    row count sizes the bins; the bins cross to their destination shards
    (core/exchange.py's all-to-all: peer copies between devices, none
    between shards that share one); then each shard folds its received
    key-sorted runs with the balanced merge tree and runs the presorted
    merge join on its device.  Matching rows co-hash, so the per-shard
    join outputs union to exactly the global join.  Returns the per-shard
    ``(vars, [cols], [valid])`` and the per-shard overflow (int32 0-d
    each, on its device).
    """
    (avars, ac, av), (rvars, rc, rv) = acc, rel
    S = len(devices)
    ai, ri = avars.index(key), rvars.index(key)
    binned = []
    for i, d in enumerate(devices):
        with device_ctx(d):
            binned.append(_bin_by_key(ac[i], av[i], ai, S))
            binned.append(_bin_by_key(rc[i], rv[i], ri, S))
    bins = _split_bins(binned, devices[0])
    arecv = all_to_all(bins[0::2], devices)
    rrecv = all_to_all(bins[1::2], devices)
    outs = []
    for j, d in enumerate(devices):
        with device_ctx(d):
            zero = torch.zeros((), dtype=torch.int32, device=d)
            runs = [r for r in rrecv[j] if r.shape[0]]
            m = _padded(_merge_tree(runs, ri) if runs else rrecv[j][0])
            af = _padded(torch.cat(arecv[j]))
            outs.append(join(
                Relation(vars=rvars, cols=m.T, valid=m[:, ri] != INVALID,
                         overflow=zero),
                Relation(vars=avars, cols=af.T, valid=af[:, ai] != INVALID,
                         overflow=zero),
                jcap, a_sorted=True))
    return ((outs[0].vars, [o.cols for o in outs], [o.valid for o in outs]),
            [o.overflow for o in outs])


def _distinct_per_shard(rel, sel, cap: int, devices: list):
    """DISTINCT projection of each shard's relation, on its device."""
    rvars, cols, valid = rel
    outs = []
    for c, v, d in zip(cols, valid, devices):
        with device_ctx(d):
            zero = torch.zeros((), dtype=torch.int32, device=d)
            outs.append(distinct(Relation(vars=rvars, cols=c, valid=v,
                                          overflow=zero), sel, cap))
    return [o.cols for o in outs], [o.valid for o in outs]


# ---------------------------------------------------------------------------
# ShardedQueryEngine: group-local plans, global combine
# ---------------------------------------------------------------------------


@dataclass
class ShardedQueryEngine:
    """Executes conjunctive plans across a ShardedKB's shards.

    Subject-co-hashed groups run the full per-shard QueryEngine plans, over
    the live shards' own engines or, for a snapshot (core/snapshot.py),
    over ``pinned`` per-shard engines bound to its views: live and pinned
    reads share one engine.  A group's routed shards are all planned on
    the host, then each plan body is enqueued on its shard's device with
    no host sync between shards, and only then read.  Cross-group joins
    combine either by the host fold (gather the per-shard relations, fold
    them key-sorted with the merge-path kernel, presorted merge join +
    distinct) or, with ``use_repartition_join``, by the repartition
    combine (bin both sides by a hash of the join key, exchange the bins
    between the shards' devices, join per shard) — both equal to the
    single store.
    """

    skb: ShardedKB
    mode: str = "litemat"
    use_index: bool = True
    pinned: list | None = None  # per-shard engines over pinned views
    use_repartition_join: bool = False
    cache_stats: dict = field(
        default_factory=lambda: {"group_runs": 0, "repartition_runs": 0,
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
                for i, eng in enumerate(self._engines()):
                    if eng.view.n:
                        with self.skb._device_ctx(i):
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

    def _run_shards(self, gpats, gvars, max_retries: int = 6) -> list:
        """-> ``[(i, cols int32[V, cap], valid bool[cap], rows)]`` per
        routed shard with a non-empty view, ``cols``/``valid`` on shard i's
        device (its distinct rows first), ``rows`` their count.

        Every routed shard is planned on the host first (each engine's
        ``_plan``: its counting passes read the device); then each plan
        body is enqueued on its shard's device (the ``shard.query_shard``
        fault site), with no host sync between shards; only then is each
        shard's outcome read, and a shard that overflowed runs again with
        its capacities doubled (``join/capacity_retry{shard=i}``).  Each
        shard keeps its own plan and capacities: no executable is shared,
        so the reference's signature check and unified caps have no
        counterpart.
        """
        engines = self._engines()
        routed = [i for i in self._route_shards(gpats, engines)
                  if engines[i].view.n]
        planned = {}
        with obs_trace.span("shard_dispatch", n_shards=self.skb.n_shards):
            for i in routed:
                with self.skb._device_ctx(i), obs_trace.span(
                        "plan", mode=self.mode, n_patterns=len(gpats)):
                    planned[i] = list(engines[i]._plan(gpats, gvars))
            pending, done = list(routed), {}
            for attempt in range(max_retries):
                launched = {}
                for i in pending:
                    faults.fire("shard.query_shard", shard=i)
                    with self.skb._device_ctx(i):
                        launched[i] = engines[i]._launch(planned[i])
                retry = []
                for i in pending:
                    with self.skb._device_ctx(i):
                        out = engines[i]._settle(planned[i], launched[i],
                                                 attempt, shard=str(i))
                    if out is None:
                        retry.append(i)
                    else:
                        done[i] = out
                pending = retry
                if not pending:
                    break
            else:
                raise RuntimeError("sharded query kept overflowing its "
                                   "buckets")
        self.cache_stats["group_runs"] += 1
        REGISTRY.counter("shard/group_runs").inc()
        return [(i, *done[i]) for i in routed]

    def _run_group(self, gpats, gvars) -> list:
        """A group's non-empty per-shard parts, pulled to the host for the
        host fold.  The repartition combine keeps them on the devices."""
        return [cols[:, :n].T.cpu().numpy()
                for _, cols, _, n in self._run_shards(gpats, gvars) if n]

    # -- the repartition combine ---------------------------------------------
    def _run_repartition(self, patterns, groups, select, max_retries):
        """Evaluate groups, fold them with the repartition combine: each
        group's results stay on the shards' devices."""
        devs = self.skb.shard_devices()
        evaluated = []
        with obs_trace.span("shard_combine", path="repartition",
                            n_groups=len(groups)):
            for g in groups:
                gpats = [patterns[i] for i in g]
                gvars = _group_vars(gpats)
                rels = [_empty_relation(len(gvars), d) for d in devs]
                total = 0
                for i, cols, valid, n in self._run_shards(gpats, gvars):
                    rels[i] = (cols, valid)
                    total += n
                cols, valid = (list(x) for x in zip(*rels))
                evaluated.append((gvars, cols, valid, total))
            return self._combine_groups_device(evaluated, patterns, select,
                                               max_retries)

    def _combine_groups_device(self, evaluated, patterns, select,
                               max_retries):
        """Fold per-shard group results on the shards' devices.

        Mirrors ``combine_groups``' order (fewest rows first, greedy
        connected) and capacities, but every cross-group join runs as a
        hash-repartition join: intermediate relations stay on the devices
        between steps.  Only the final per-shard DISTINCT rows come back,
        and one host sorted-unique pass reproduces the global distinct's
        lexicographic order.
        """
        devs = self.skb.shard_devices()
        all_vars = tuple(dict.fromkeys(
            v for pat in patterns for v in (pat.s, pat.p, pat.o)
            if is_var(v)))
        sel = tuple(select) if select else all_vars
        totals = [e[3] for e in evaluated]
        order = sorted(range(len(evaluated)), key=lambda i: totals[i])
        acc = None  # (vars, [cols [V, cap]], [valid [cap]], rows)
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
            jcap = _pow2(max(totals[pick], acc[3], 1) * 2, floor=256)
            plabel = sig_label(tuple((p.s, p.p, p.o) for p in patterns))
            for attempt in range(max_retries):
                out, ovf = _repartition_join(acc[:3], rel[:3], key, jcap,
                                             devs)
                ovf = [int(o) for o in ovf]  # every shard enqueued first
                if max(ovf) == 0:
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
            acc = (*out, sum(int(v.sum()) for v in out[2]))
        self.cache_stats["repartition_runs"] += 1
        REGISTRY.counter("shard/combine_runs", path="repartition").inc()
        # per-shard distinct shrinks the readback; identical sel-tuples can
        # still straddle shards when sel drops the last join key, so one
        # host sorted-unique pass finishes the global dedup in the same
        # ascending-lexicographic order `distinct` emits
        dcols, dvalid = _distinct_per_shard(
            acc[:3], sel, max(c.shape[1] for c in acc[1]), devs)
        counts = [int(v.sum()) for v in dvalid]
        parts = [c[:, :n].T.cpu().numpy()
                 for c, n in zip(dcols, counts) if n]
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
        or device fault (``FaultError`` only: a kernel that fails raises).
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
        members' groups routed to a shard ride one ``run_batch`` there, on
        the shard's device — same-signature groups from different requests
        coalesce inside that shard's engine — before each member combines
        its own groups through the host fold.
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
                with self.skb._device_ctx(i):
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
