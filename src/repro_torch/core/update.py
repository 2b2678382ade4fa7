"""Incremental update machinery: dictionary growth + delta (re)derivation.

The LiteMat encoding makes the ABox *appendable*: concept/property ids are
fixed by the TBox, and instance ids live in their own namespace above
``tbox.instance_base``, assigned densely in dictionary-rank order.  A new
instance term therefore just takes the next free id — no existing id moves,
no store is re-encoded.  This module supplies the host-side pieces that
``KnowledgeBase.insert`` / ``.delete`` (core/engine.py) orchestrate:

  * :class:`DynamicDictionary` — a growable host mirror of the device
    dictionary.  Lookups are numpy binary searches; new terms are allocated
    ids past ``n_instance_terms`` and handed back as TermTable chunks so the
    device dictionary (``EncodedKB.tables``) absorbs them without a rebuild.
  * :func:`materialize_delta_mode` — materialization of *only* the delta
    rows against the existing DeviceTBox, one store mode at a time (the
    unit of the KnowledgeBase's lazy per-mode derivation).
  * :class:`RowLocator` — exact (s, p, o) row lookup over a store (all
    duplicate copies), for tombstoning deletes.
  * :func:`affected_instances` / :func:`mention_rows` — the delete
    re-derivation frontier: affected instances resolve to base rows through
    the SPO/OSP permutations (contiguous runs per instance), so a delete's
    base-store work is O(k log N + hits), sublinear in the store size
    (``mentions_mask`` remains the O(N) scan for the small delta arrays).

Correctness model (why delta-only materialization is enough):

  * *full* closure is per-triple local — every derived triple is a gather
    from precomputed ancestor/domain/range tables of one source triple — so
    closure(base ∪ delta) = closure(base) ∪ closure(delta), exactly.
  * *lite* (MSC) output is per-instance, and a union of per-batch MSC sets
    may retain a concept alongside one of its descendants; that is
    answer-equivalent under interval evaluation (the ancestor is entailed,
    and every query interval containing the descendant contains it).
  * *deletes* re-derive exactly: every derived row mentions only instances
    of its source triple, so tombstoning all rows that mention an affected
    instance and re-materializing all live raw triples that mention one is
    a closed repair.

Assumed data model (the paper's): properties connect instances/literals;
concept ids appear only as rdf:type objects.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import dictionary as dct
from repro_torch.core.abox import EncodedKB
from repro_torch.core.closure import full_materialize_rows
from repro_torch.core.materialize import DeviceTBox, lite_materialize_rows
from repro_torch.utils import pair64


# ---------------------------------------------------------------------------
# Growable dictionary
# ---------------------------------------------------------------------------


@dataclass
class DynamicDictionary:
    """Host mirror of an EncodedKB's dictionary that can allocate new ids.

    ``fps``/``ids`` are the sorted fingerprint -> id map of every known term
    (TBox + instances).  New terms get ``next_id``, ``next_id + 1``, ... —
    strictly past every existing instance id, so the base store's encoding
    is untouched (the unused id headroom the paper's encoding reserves).
    """

    fps: np.ndarray  # int64, sorted
    ids: np.ndarray  # int32, aligned with fps
    next_id: int
    instance_base: int
    n_new_terms: int = 0
    _pending_fps: list = field(default_factory=list)
    _pending_ids: list = field(default_factory=list)

    @classmethod
    def from_kb(cls, kb: EncodedKB) -> "DynamicDictionary":
        t = kb.table  # merged TermTable (device); one host pull at build
        hi = t.fp_hi.cpu().numpy()
        lo = t.fp_lo.cpu().numpy()
        ids = t.ids.cpu().numpy()
        real = ids >= 0  # padding rows carry -1
        fps = pair64.combine_np(hi[real], lo[real])
        order = np.argsort(fps)
        base = kb.tbox.instance_base if kb.tbox is not None else 0
        return cls(
            fps=fps[order],
            ids=ids[real][order].astype(np.int32),
            next_id=base + kb.n_instance_terms,
            instance_base=base,
        )

    def lookup(self, fps: np.ndarray) -> np.ndarray:
        """fps -> ids; -1 where unknown."""
        fps = np.asarray(fps, dtype=np.int64)
        if self.fps.shape[0] == 0:
            return np.full(fps.shape[0], -1, dtype=np.int32)
        pos = np.searchsorted(self.fps, fps)
        pos_c = np.clip(pos, 0, self.fps.shape[0] - 1)
        hit = self.fps[pos_c] == fps
        return np.where(hit, self.ids[pos_c], np.int32(-1)).astype(np.int32)

    def encode(self, fps: np.ndarray) -> tuple[np.ndarray, int]:
        """fps -> ids, allocating fresh ids for unknown terms.

        Returns (ids, n_new).  Duplicate unknown fps within one batch share
        one new id (same dedup the batch dictionary build performs).
        """
        out = self.lookup(fps)
        missing = out < 0
        if not missing.any():
            return out, 0
        new_fps = np.unique(np.asarray(fps, dtype=np.int64)[missing])
        new_ids = (self.next_id
                   + np.arange(new_fps.shape[0], dtype=np.int64)).astype(np.int32)
        self.next_id += int(new_fps.shape[0])
        self.n_new_terms += int(new_fps.shape[0])
        self._pending_fps.append(new_fps)
        self._pending_ids.append(new_ids)
        # splice into the sorted map
        ins = np.searchsorted(self.fps, new_fps)
        self.fps = np.insert(self.fps, ins, new_fps)
        self.ids = np.insert(self.ids, ins, new_ids)
        out = self.lookup(fps)
        return out, int(new_fps.shape[0])

    def register(self, fps: np.ndarray, ids: np.ndarray) -> int:
        """Adopt externally assigned (fps, ids) — the sharded encode's terms.

        The sharded dictionary build (``dictionary.py::
        sharded_dictionary_fn``) assigns ids to a batch's unknown terms in
        its own hash-partitioned order; this splices them into the host
        mirror and queues them as a pending TermTable chunk, exactly like
        ``encode`` does for its own allocations.  ``fps`` must be distinct
        unknown terms and ``ids`` must sit at/above ``next_id``.
        """
        fps = np.asarray(fps, dtype=np.int64)
        ids = np.asarray(ids, dtype=np.int32)
        if fps.shape[0] == 0:
            return 0
        order = np.argsort(fps)
        fps, ids = fps[order], ids[order]
        self.next_id = max(self.next_id, int(ids.max()) + 1)
        self.n_new_terms += int(fps.shape[0])
        self._pending_fps.append(fps)
        self._pending_ids.append(ids)
        ins = np.searchsorted(self.fps, fps)
        self.fps = np.insert(self.fps, ins, fps)
        self.ids = np.insert(self.ids, ins, ids)
        return int(fps.shape[0])

    def take_new_terms(self):
        """Drain terms allocated since the last call -> (fps, ids) or None.

        The caller folds them into the device dictionary as one TermTable
        chunk (``EncodedKB.tables``), keeping locate/extract complete.
        """
        if not self._pending_fps:
            return None
        fps = np.concatenate(self._pending_fps)
        ids = np.concatenate(self._pending_ids)
        self._pending_fps.clear()
        self._pending_ids.clear()
        return fps, ids


def encode_delta(dyn: DynamicDictionary,
                 s_fp: np.ndarray, p_fp: np.ndarray, o_fp: np.ndarray):
    """Encode raw delta triples, growing the instance dictionary in place.

    Predicates must already be TBox properties (the TBox is fixed between
    re-encodes; only the ABox grows).  Returns (spo int32[M, 3], n_new).
    """
    p_ids = dyn.lookup(p_fp)
    bad = (p_ids < 0) | (p_ids >= dyn.instance_base)
    if bad.any():
        raise ValueError(
            "delta contains predicates outside the TBox property map — "
            "schema growth needs a re-encode (KnowledgeBase.build), the "
            "incremental path only grows the ABox"
        )
    # one encode over s+o: a single sorted splice of the dictionary arrays
    so_ids, n_new = dyn.encode(np.concatenate([s_fp, o_fp]))
    s_ids, o_ids = np.split(so_ids, 2)
    spo = np.stack([s_ids, p_ids, o_ids], axis=1).astype(np.int32)
    return spo, n_new


def absorb_new_terms(kb: EncodedKB, dyn: DynamicDictionary,
                     term_strings: dict | None = None) -> int:
    """Fold freshly allocated terms into the device dictionary + string map."""
    chunk = dyn.take_new_terms()
    if chunk is None:
        return 0
    fps, ids = chunk
    kb.tables = (*kb.tables, dct.table_from_host(fps, ids,
                                                 device=kb.spo.device))
    kb._merged = None  # next locate/extract re-merges lazily
    kb.n_instance_terms += int(ids.shape[0])
    if term_strings:
        if kb.term_strings is None:
            kb.term_strings = {}
        kb.term_strings.update(term_strings)
    return int(ids.shape[0])


# ---------------------------------------------------------------------------
# Delta materialization
# ---------------------------------------------------------------------------


_MATERIALIZERS = {
    "litemat": lite_materialize_rows,
    "full": full_materialize_rows,
}


def materialize_delta_mode(spo: np.ndarray, dtb: DeviceTBox,
                           mode: str) -> np.ndarray:
    """Materialize delta rows for ONE store mode ('litemat' | 'full').

    The unit of lazy per-mode derivation: a deployment that only serves the
    lite store never pays for the full closure of its inserts (and vice
    versa).  The rows run unpadded on the TBox's device (the reference pads
    them to a power-of-two bucket so its jitted materializers compile once
    per bucket; the padding rows derive nothing, so the output is the same).
    """
    spo = np.asarray(spo, dtype=np.int32).reshape(-1, 3)
    if spo.shape[0] == 0:
        return np.zeros((0, 3), dtype=np.int32)
    rows = torch.as_tensor(spo, device=dtb.concept_sorted_ids.device)
    out, valid, _ = _MATERIALIZERS[mode](rows, dtb)
    return out[valid].cpu().numpy()


# ---------------------------------------------------------------------------
# Delete support: exact row location + re-derivation frontier
# ---------------------------------------------------------------------------


@dataclass
class RowLocator:
    """Exact (s, p, o) -> row-index lookup over one store (all copies).

    One lexsort at build; each probe is two binary searches over an int64
    (s << 32 | p) composite plus a search of the o column inside the run.
    """

    perm: np.ndarray
    key_sp: np.ndarray  # int64 (s << 32 | p), sorted
    o_sorted: np.ndarray

    @classmethod
    def build(cls, rows: np.ndarray) -> "RowLocator":
        rows = np.asarray(rows)
        perm = np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))
        sp = ((rows[perm, 0].astype(np.int64) << np.int64(32))
              | rows[perm, 1].astype(np.int64))
        return cls(perm=perm, key_sp=sp,
                   o_sorted=np.ascontiguousarray(rows[perm, 2]))

    def find(self, spo: np.ndarray) -> np.ndarray:
        """Row indices (original coordinates) matching ANY query triple."""
        spo = np.asarray(spo).reshape(-1, 3)
        qsp = ((spo[:, 0].astype(np.int64) << np.int64(32))
               | spo[:, 1].astype(np.int64))
        l = np.searchsorted(self.key_sp, qsp, side="left")
        r = np.searchsorted(self.key_sp, qsp, side="right")
        hits = []
        for i in range(spo.shape[0]):
            lo, hi = int(l[i]), int(r[i])
            if hi <= lo:
                continue
            seg = self.o_sorted[lo:hi]
            a = lo + int(np.searchsorted(seg, spo[i, 2], side="left"))
            b = lo + int(np.searchsorted(seg, spo[i, 2], side="right"))
            if b > a:
                hits.append(self.perm[a:b])
        if not hits:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.concatenate(hits))


def affected_instances(deleted_rows: np.ndarray, instance_base: int) -> np.ndarray:
    """Sorted instance/literal ids mentioned by the deleted raw triples.

    TBox ids (concepts as rdf:type objects, properties) are excluded: their
    derived rows are keyed by the *instance* side, which is what gets
    re-derived.
    """
    ends = np.concatenate([deleted_rows[:, 0], deleted_rows[:, 2]])
    return np.unique(ends[ends >= instance_base])


def mentions_mask(rows: np.ndarray, instances: np.ndarray) -> np.ndarray:
    """bool[N]: row mentions (as s or o) any of the sorted instance ids.

    O(N) scan — for the SMALL arrays of the delete path (delta logs,
    re-derived frontiers).  Base stores go through ``mention_rows``.
    """
    if rows.shape[0] == 0 or instances.shape[0] == 0:
        return np.zeros(rows.shape[0], dtype=bool)
    return (np.isin(rows[:, 0], instances, assume_unique=False)
            | np.isin(rows[:, 2], instances, assume_unique=False))


def mention_rows(index, instances: np.ndarray) -> np.ndarray:
    """Row indices (original coords) mentioning any instance as s or o.

    Each instance id is a contiguous run of the SPO permutation (as
    subject) and of the OSP permutation (as object), so the lookup is two
    vectorized binary searches per permutation plus the hit segments —
    O(k log N + hits) against an O(N) scan per delete.
    """
    instances = np.asarray(instances).reshape(-1)
    if instances.shape[0] == 0 or index.n == 0:
        return np.zeros(0, dtype=np.int64)
    hits = []
    for name in ("spo", "osp"):
        p = index.perm(name)
        l = np.searchsorted(p.primary, instances, side="left")
        r = np.searchsorted(p.primary, instances, side="right")
        for a, b in zip(l.tolist(), r.tolist()):
            if b > a:
                hits.append(p.perm[a:b])
    if not hits:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate(hits))


__all__ = [
    "DynamicDictionary", "encode_delta", "absorb_new_terms",
    "materialize_delta_mode", "RowLocator", "affected_instances",
    "mentions_mask", "mention_rows",
]
