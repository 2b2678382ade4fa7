"""Device-resident sorted indexes over an encoded triple store.

LiteMat's encoding turns RDFS inference into interval containment, so a
triple pattern with a constant predicate (and, for rdf:type patterns, a
constant concept interval) selects a *contiguous run* of a suitably sorted
store.  This module materializes four permutations of the (N, 3) store,
each lazily on first use:

  * POS — rows ordered by (predicate, object, subject),
  * PSO — rows ordered by (predicate, subject, object),
  * SPO — rows ordered by (subject, predicate, object),
  * OSP — rows ordered by (object, subject, predicate).

A permutation is sorted on the store's device; its primary column and
(primary << 32 | secondary) composite keys are then mirrored to the host,
where range endpoints are found with numpy binary searches — O(log N) on
a few cached arrays — while the row gathers happen on the device from the
permuted rows.  Each permutation keeps its source-row permutation vector
(the stable lexsort order) for the overlay machinery of later slices.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

_SHIFT = np.int64(32)

# StoreIndex identity tokens: device caches (core/delta.py) key their state
# on the *base* they were built from, and Python object ids can be recycled.
_TOKENS = itertools.count()

PERMUTATIONS = ("pos", "pso", "spo", "osp")

INVALID = np.int32(np.iinfo(np.int32).max)


def pow2_bucket(n: int, floor: int = 8) -> int:
    """Smallest power of two >= n (>= floor) — THE capacity-bucket helper."""
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), int(np.log2(floor)))


def pad_rows(rows: np.ndarray, cap: int) -> np.ndarray:
    """Pad an (N, 3) triple array to ``cap`` rows of INVALID."""
    pad = cap - rows.shape[0]
    if pad <= 0:
        return rows
    return np.concatenate(
        [rows, np.full((pad, 3), INVALID, dtype=np.int32)])


def _search_col(col: np.ndarray, v: int, side: str = "left") -> int:
    """np.searchsorted of a Python int in a sorted int32 column.

    The value goes in as the column's own dtype: a Python int (or int64)
    makes numpy promote and copy the whole column to int64 first — an
    O(N) copy per lookup (28 ms at 11M rows, numpy 2.0).
    """
    info = np.iinfo(col.dtype)
    if v > info.max:
        return int(col.shape[0])
    if v < info.min:
        return 0
    return int(np.searchsorted(col, col.dtype.type(v), side=side))


def _composite(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lexicographic (a, b) order as one sortable int64 key (ids are < 2^31)."""
    return (a.astype(np.int64) << _SHIFT) | b.astype(np.int64)


def lexsort_rows(rows: torch.Tensor, order) -> torch.Tensor:
    """Stable lexicographic sort permutation of [N, 3] rows by ``order``.

    ``order`` = (primary, secondary, tertiary) column indices.  Two stable
    passes — (secondary, tertiary) packed into one int64 key, then the
    primary column — give ``np.lexsort``'s order, ties included.
    """
    a, b, c = order
    low = (rows[:, b].to(torch.int64) << 32) + (rows[:, c].to(torch.int64)
                                                + (1 << 31))
    perm = torch.sort(low, stable=True).indices
    return perm[torch.sort(rows[perm, a], stable=True).indices]


@dataclass
class _Perm:
    """One sorted permutation: device rows + host search keys + source perm."""

    rows: torch.Tensor  # device copy of the permuted store
    primary: np.ndarray  # host primary-sort column
    key: np.ndarray  # host (primary << 32 | secondary) composite keys
    perm: np.ndarray  # source-row index of each sorted row


# (primary, secondary, tertiary) column indices per permutation name; the
# tertiary column breaks ties so exact duplicate rows sort adjacently.
_ORDERS = {"pos": (1, 2, 0), "pso": (1, 0, 2), "spo": (0, 1, 2), "osp": (2, 0, 1)}


def key_cols(name: str):
    """(primary, secondary) column indices of permutation ``name``.

    The device-side key planes of a sorted store are just these two columns
    of its permuted rows — the index-nested-loop join (core/query.py) probes
    them in place, so no separate key copy ever exists.
    """
    a, b, _ = _ORDERS[name]
    return a, b


@dataclass
class StoreIndex:
    """Sorted permutations of one triple store + host search keys."""

    _h: np.ndarray = field(repr=False)  # host copy of the store
    _d: torch.Tensor = field(repr=False)  # the store on its device
    _perms: dict = field(default_factory=dict, repr=False)
    token: int = field(default_factory=lambda: next(_TOKENS), repr=False)

    @classmethod
    def build(cls, spo: torch.Tensor) -> "StoreIndex":
        return cls(_h=spo.cpu().numpy(), _d=spo)

    def perm(self, name: str) -> _Perm:
        if name not in self._perms:
            a, b, _ = _ORDERS[name]
            p = lexsort_rows(self._d, _ORDERS[name])
            rows = self._d[p]
            # contiguous host columns: np.searchsorted copies a strided
            # array on every call, O(N) per range lookup
            primary = rows[:, a].contiguous().cpu().numpy()
            self._perms[name] = _Perm(
                rows=rows,
                primary=primary,
                key=_composite(primary, rows[:, b].contiguous().cpu().numpy()),
                perm=p.cpu().numpy(),
            )
        return self._perms[name]

    @property
    def n(self) -> int:
        return int(self._h.shape[0])

    # -- host-side O(log N) range lookups ------------------------------------
    def primary_range(self, name: str, lo: int, hi: int):
        """Row range of primary-column interval [lo, hi) in permutation ``name``."""
        col = self.perm(name).primary
        return _search_col(col, lo), _search_col(col, hi)

    def composite_range(self, name: str, a_id: int, blo: int, bhi: int):
        """Row range of (primary == a_id, secondary in [blo, bhi))."""
        key = self.perm(name).key
        r0 = int(np.searchsorted(key, _composite_scalar(a_id, blo)))
        r1 = int(np.searchsorted(key, _composite_scalar(a_id, bhi)))
        return r0, r1

    def p_range(self, plo: int, phi: int):
        """Row range of predicate interval [plo, phi) (valid in POS and PSO)."""
        return self.primary_range("pos", plo, phi)

    def single_p_run(self, r0: int, r1: int):
        """The unique predicate id of POS rows [r0, r1), or None if mixed/empty."""
        pos_p = self.perm("pos").primary
        if r1 <= r0:
            return None
        if pos_p[r0] == pos_p[r1 - 1]:
            return int(pos_p[r0])
        return None

    def distinct_p_ids(self, plo: int, phi: int, limit: int = 8):
        """Distinct predicate ids the store holds in [plo, phi), or None
        past ``limit`` ids (one binary search per distinct id)."""
        col = self.perm("pos").primary
        r0, r1 = self.p_range(plo, phi)
        out = []
        while r0 < r1:
            pid = int(col[r0])
            out.append(pid)
            if len(out) > limit:
                return None
            r0 = _search_col(col, pid, side="right")
        return out

    def po_range(self, p_id: int, olo: int, ohi: int):
        """Row range of (p == p_id, o in [olo, ohi)) in POS order."""
        return self.composite_range("pos", p_id, olo, ohi)

    def ps_range(self, p_id: int, slo: int, shi: int):
        """Row range of (p == p_id, s in [slo, shi)) in PSO order."""
        return self.composite_range("pso", p_id, slo, shi)

    def s_range(self, slo: int, shi: int):
        """Row range of subject interval [slo, shi) in SPO order."""
        return self.primary_range("spo", slo, shi)

    def o_range(self, olo: int, ohi: int):
        """Row range of object interval [olo, ohi) in OSP order."""
        return self.primary_range("osp", olo, ohi)


def _composite_scalar(a: int, b: int) -> np.int64:
    return (np.int64(a) << _SHIFT) | np.int64(b)
