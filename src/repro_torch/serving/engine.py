"""Batched query serving — LiteMat as an online inference service.

A serving deployment sees *streams* of parameterized queries ("all members
of class C", "all x with x:C and (x p y)") that share a plan and differ
only in constants.  Because LiteMat turns inference into interval
compares, a parameterized plan is a pure tensor function of (lo, hi)
pairs, and a whole batch of B requests runs as one set of torch ops with a
leading request axis over the store (the reference runs the same plan
through ``jax.vmap``).

Request resolution rides the (object, subject)-sorted type index
(core/index.py's ``TypeIndex``): a class interval [lo, hi) is two host
binary searches plus one contiguous device slice, so per-request work is
bounded by the *largest class in the batch* (bucketed to a power of two),
not the type view.  Answer semantics are DISTINCT subjects (SPARQL set
semantics, matching the QueryEngine): an instance can carry several MSC
types inside the queried interval (e.g. Chair + FullProfessor under
Professor), so each request deduplicates its own slice — a sort along the
request's row, never over the view.

View freshness is automatic: every serving call compares the monotonic
``KnowledgeBase.version`` counter against the version its views were built
at and rebuilds them when the store has changed.  ``invalidate()`` remains
for the one case the counter cannot see: direct (out-of-API) mutation of a
store field.

:class:`ShardedQueryServer` serves the same plans over a
:class:`~repro_torch.core.shard.ShardedKB`: every shard keeps its own type
index and property view on its device (class-membership subjects are
co-hashed — derived ``(x rdf:type C)`` rows live on ``shard(x)`` — so
per-shard distinct sets are DISJOINT), a batch runs once per shard on
that shard's device, and the per-shard answers merge by summing distinct
counts and merge-sorting the per-shard member lists.

No kernel of the reference runs here: the batched plans are sorts,
gathers and binary searches, so they are plain torch.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.engine import KnowledgeBase
from repro_torch.core.index import TypeIndex, pow2_bucket
from repro_torch.kernels import ops
from repro_torch.obs.metrics import REGISTRY
from repro_torch.utils.pair64 import pair_key

INVALID = int(np.iinfo(np.int32).max)


def _distinct_count_topk(hits, topk: int):
    """Per request row of INVALID-padded hits [B, cap] -> (distinct count
    int32[B], the first ``topk`` distinct values ascending, -1 behind)."""
    h = torch.sort(hits, dim=1).values
    first = torch.ones_like(h, dtype=torch.bool)
    first[:, 1:] = h[:, 1:] != h[:, :-1]
    uniq = first & (h != INVALID)
    count = uniq.sum(1, dtype=torch.int32)
    vals = torch.where(uniq, h, INVALID)
    top = torch.sort(vals, dim=1).values[:, :topk]
    return count, torch.where(top == INVALID, -1, top)


def _slice_hits(subj_os, starts, lens, cap: int):
    """Gather each request's type-index segments (primary + spill
    intervals): starts/lens [B, k] -> subjects [B, cap], INVALID behind."""
    src, ok, _, _ = ops.segment_positions_batched(starts, lens, cap)
    return torch.where(
        ok, subj_os[src.long().clamp(0, subj_os.shape[0] - 1)], INVALID)


def _serve_class_members(subj_os, starts, lens, cap: int, topk: int):
    """The batched Q1 plan over index slices: (B, k) ranges -> counts +
    members."""
    return _distinct_count_topk(_slice_hits(subj_os, starts, lens, cap), topk)


def _serve_class_prop_join(subj_os, ps_sorted, p_sorted, ps_key, starts,
                           lens, plo, phi, cap: int, topk: int):
    """The batched Q3 plan: x:C ⋈ (x p y) semi-join per request.

    The type side is an index slice; ``ps_sorted``/``p_sorted`` are the
    property triples' subjects and predicates sorted by (s, p) once per
    store (``ps_key`` their int64 composite), so each sliced subject
    semi-joins with one binary search per property interval (primary +
    spills, usually 1): the first row >= (s, plo) matches iff its subject
    is s and its predicate is still < phi.  A search past the last row
    matches nothing (the reference clamps it onto the last row, which
    answers a subject whose last property sorts below ``plo``).
    """
    hits = _slice_hits(subj_os, starts, lens, cap)
    hit = torch.zeros(hits.shape, dtype=torch.bool, device=hits.device)
    n = ps_sorted.shape[0]
    for i in range(plo.shape[1] if n else 0):
        x = torch.searchsorted(
            ps_key, pair_key(hits, plo[:, i:i + 1].expand_as(hits)))
        xc = x.clamp(0, n - 1)
        hit = hit | ((x < n) & (ps_sorted[xc] == hits)
                     & (p_sorted[xc] < phi[:, i:i + 1]))
    return _distinct_count_topk(torch.where(hit, hits, INVALID), topk)


@dataclass
class QueryServer:
    """Serve-batches facade over a KnowledgeBase."""

    K: KnowledgeBase
    topk: int = 32
    _views: dict = field(default_factory=dict)
    _seen_version: int | None = field(default=None)

    @property
    def served_version(self) -> int | None:
        """Store version the current views were (re)built at — what an
        answer returned right now is consistent with."""
        return self._seen_version

    def invalidate(self):
        """Drop derived views/indexes after an out-of-API store mutation.

        ``insert`` / ``delete`` / ``compact`` bump ``K.version`` and are
        picked up automatically; this only matters when a store field was
        swapped directly (tests, manual surgery).
        """
        self._views.clear()
        self._seen_version = self.K.version

    def _sync(self):
        """Rebuild every derived view atomically against ONE store version.

        A detected change rebuilds ALL views eagerly under the store's write
        lock (writers are excluded, so the version cannot move between the
        capture and the builds), so one batch never mixes two stores; the
        version-equality fast path takes no lock.
        """
        if self._seen_version == self.K.version:
            return
        with self.K.write_lock:
            v = self.K.version
            self._views.clear()
            self._build_views()
            self._seen_version = v

    def _build_views(self):
        """Eagerly materialize every derived view (write lock held)."""
        self._type_index()
        self._prop_view()

    def _store(self) -> torch.Tensor:
        """The live lite store (base ∪ delta, tombstones dropped)."""
        return self.K.store_rows("litemat")

    def _type_index(self) -> TypeIndex:
        if "type_os" not in self._views:
            self._views["type_os"] = TypeIndex.build(
                self._store(), int(self.K.dtb.rdf_type_id))
        return self._views["type_os"]

    def _prop_view(self):
        """Property triples sorted by (subject, predicate), on the device."""
        if "prop" not in self._views:
            self._views["prop"] = _prop_view(self._store(),
                                             int(self.K.dtb.rdf_type_id))
        return self._views["prop"]

    def _intervals(self, names, enc):
        """Per name: primary + spill [lo, hi) intervals, 0-padded to (B, k).

        Spill intervals carry the secondary-edge subsumees under multiple
        inheritance; dropping them would undercount (the QueryEngine honors
        them, so the server must too).
        """
        per = []
        for n in names:
            (lo, hi), spills = enc.interval_of(n)
            per.append([(int(lo), int(hi))] + [(int(a), int(b))
                                               for a, b in spills])
        k = max(len(p) for p in per) if per else 1
        lo = np.zeros((len(names), k), np.int32)
        hi = np.zeros((len(names), k), np.int32)
        for i, p in enumerate(per):
            for j, (a, b) in enumerate(p):
                lo[i, j], hi[i, j] = a, b
        return lo, hi

    def _ranges(self, class_names):
        """Host-side index lookups: (starts, lens (B, k), capacity bucket)."""
        ti = self._type_index()
        clo, chi = self._intervals(class_names, self.K.kb.tbox.concepts)
        return (ti, *_index_ranges(ti, clo, chi, self.topk))

    def class_members(self, class_names):
        """Batch of Q1-style requests -> (distinct counts, member ids)."""
        self._sync()
        REGISTRY.histogram("server/batch_size",
                           kind="members").observe(len(class_names))
        ti, starts, lens, cap = self._ranges(class_names)
        counts, members = _serve_class_members(ti.subj, starts, lens, cap,
                                               self.topk)
        return counts.cpu().numpy(), members.cpu().numpy()

    def class_prop_join(self, class_names, prop_names):
        """Batch of Q3-style requests -> (distinct-x counts, x bindings)."""
        self._sync()
        REGISTRY.histogram("server/batch_size",
                           kind="prop_join").observe(len(class_names))
        ti, starts, lens, cap = self._ranges(class_names)
        plo, phi = self._intervals(prop_names, self.K.kb.tbox.properties)
        counts, subs = _serve_class_prop_join(
            ti.subj, *self._prop_view(), starts, lens,
            *_planes(ti, plo, phi), cap, self.topk)
        return counts.cpu().numpy(), subs.cpu().numpy()


def _prop_view(spo: torch.Tensor, type_id: int):
    """A store's property triples sorted by (subject, predicate):
    (subjects, predicates, their int64 composite keys)."""
    m = spo[:, 1] != type_id
    s, p = spo[m, 0], spo[m, 1]
    key = pair_key(s, p)
    order = torch.sort(key, stable=True).indices
    return s[order], p[order], key[order]


def _index_ranges(ti: TypeIndex, clo, chi, topk: int):
    """Host binary searches of (B, k) class intervals in one type index:
    (starts, lens (B, k) on its device, capacity bucket)."""
    starts = np.zeros(clo.shape, np.int64)
    lens = np.zeros(clo.shape, np.int64)
    for i in range(clo.shape[0]):
        for j in range(clo.shape[1]):
            starts[i, j], lens[i, j] = ti.range_of(int(clo[i, j]),
                                                   int(chi[i, j]))
    longest = max(int(lens.sum(axis=1).max()) if lens.size else 1, topk, 1)
    dev = ti.subj.device
    return (torch.as_tensor(starts, device=dev),
            torch.as_tensor(lens, device=dev), pow2_bucket(longest, floor=1))


def _planes(ti: TypeIndex, *arrs):
    """Host arrays onto the type index's device."""
    return tuple(torch.as_tensor(a, device=ti.subj.device) for a in arrs)


# ---------------------------------------------------------------------------
# Sharded serving: per-shard plans + distinct-count merge
# ---------------------------------------------------------------------------


def _merge_members(members: torch.Tensor, topk: int) -> torch.Tensor:
    """Merge per-shard ascending member lists [S, B, topk] into the global
    smallest-topk [B, topk].

    Subjects are co-hashed, so the per-shard distinct sets are disjoint and
    a merge-sort of the per-shard topk lists IS the global topk.  ``-1``
    padding maps through INVALID so it sorts last.
    """
    S, B, _ = members.shape
    m = torch.where(members < 0, INVALID, members)
    m = m.permute(1, 0, 2).reshape(B, -1)
    m = torch.sort(m, dim=1).values[:, :topk]
    return torch.where(m == INVALID, -1, m)


@dataclass
class ShardedQueryServer:
    """Serve-batches facade over a ShardedKB.

    The request/answer contract of :class:`QueryServer` — counts and
    member lists equal the single store's — with the device work run per
    shard: the batch's index ranges resolve against every shard's own type
    index on the host, then the batched plan is enqueued once per shard on
    its device (each shard's planes stay unpadded) with no host sync
    between shards, and the per-shard answers merge on the home device by
    summing counts (disjoint distinct sets) and merge-sorting member
    lists.
    """

    K: object  # ShardedKB
    topk: int = 32
    _views: dict = field(default_factory=dict)
    _seen_version: int | None = field(default=None)

    @property
    def served_version(self) -> int | None:
        """Store version the current views were (re)built at."""
        return self._seen_version

    def invalidate(self):
        self._views.clear()
        self._seen_version = self.K.version

    def _sync(self):
        """Atomic resync — same contract as :meth:`QueryServer._sync`."""
        if self._seen_version == self.K.version:
            return
        with self.K.write_lock:
            v = self.K.version
            self._views.clear()
            self._build_views()
            self._seen_version = v

    def _build_views(self):
        """Every shard's (type index, property view) (write lock held)."""
        self._shard_views()

    def _shard_views(self) -> list:
        if "shards" not in self._views:
            self.K._flush("litemat")
            tid = int(self.K.dtb.rdf_type_id)
            views = []
            for i, K in enumerate(self.K.shards):
                with self.K._device_ctx(i):
                    spo = K.store_rows("litemat")
                    views.append((TypeIndex.build(spo, tid),
                                  _prop_view(spo, tid)))
            self._views["shards"] = views
        return self._views["shards"]

    _intervals = QueryServer._intervals  # same host-side interval resolution

    def _fan(self, plan, class_names):
        """Run ``plan`` on every shard; -> (summed counts, merged members)."""
        clo, chi = self._intervals(class_names, self.K.kb.tbox.concepts)
        views = self._shard_views()
        ranges = [_index_ranges(ti, clo, chi, self.topk) for ti, _ in views]
        outs = []
        for i, ((ti, prop), r) in enumerate(zip(views, ranges)):
            with self.K._device_ctx(i):
                outs.append(plan(ti, prop, *r))
        home = self.K.device
        counts = torch.stack([c.to(home, non_blocking=True) for c, _ in outs])
        members = torch.stack([m.to(home, non_blocking=True)
                               for _, m in outs])
        return (counts.sum(0, dtype=torch.int32).cpu().numpy(),
                _merge_members(members, self.topk).cpu().numpy())

    def class_members(self, class_names):
        """Batched Q1: run per shard, sum counts, merge member lists."""
        self._sync()
        REGISTRY.histogram("server/batch_size",
                           kind="members").observe(len(class_names))
        return self._fan(
            lambda ti, _prop, starts, lens, cap: _serve_class_members(
                ti.subj, starts, lens, cap, self.topk), class_names)

    def class_prop_join(self, class_names, prop_names):
        """Batched Q3: the semi-join is fully shard-local (co-hashed x)."""
        self._sync()
        REGISTRY.histogram("server/batch_size",
                           kind="prop_join").observe(len(class_names))
        plo, phi = self._intervals(prop_names, self.K.kb.tbox.properties)
        return self._fan(
            lambda ti, prop, starts, lens, cap: _serve_class_prop_join(
                ti.subj, *prop, starts, lens, *_planes(ti, plo, phi), cap,
                self.topk), class_names)


__all__ = ["QueryServer", "ShardedQueryServer"]
