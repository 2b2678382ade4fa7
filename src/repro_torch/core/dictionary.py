"""Dictionary encoding (the paper's §III.B), single-shard half.

The paper's Spark algorithm extracts each partition's distinct new terms,
sums the per-partition distinct counts into disjoint id ranges and assigns
ids within them.  On one device that is sort + adjacent-unique + cumsum
(rank == id offset).  The sharded build waits for the sharding slice.

Fingerprints are 62-bit values kept as (hi, lo) int32 planes in the
tables' public fields; every sort and search runs on their int64 composite
(utils/pair64.py), which orders the same way.  ``extract`` resolves
fp -> string on the host, mirroring the paper's driver-side string world.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.utils import pair64

SENTINEL = int(np.iinfo(np.int32).max)  # > any real 30-bit hi word
INT32_MAX = int(np.iinfo(np.int32).max)


@dataclass
class TermTable:
    """Dictionary: lex-sorted fp pairs -> int32 ids (+reverse view)."""

    fp_hi: torch.Tensor  # int32[T], sorted (pairs with SENTINEL padding tail)
    fp_lo: torch.Tensor
    ids: torch.Tensor  # int32[T], -1 on padding rows
    rev_ids: torch.Tensor  # int32[T] ids sorted ascending (padding: INT32_MAX)
    rev_hi: torch.Tensor  # fp planes aligned with rev_ids
    rev_lo: torch.Tensor
    count: torch.Tensor  # int32 scalar: number of real entries

    def locate(self, qhi, qlo):
        """fp pairs -> (ids, hit_mask); -1 where absent."""
        return pair64.lookup_pair(self.fp_hi, self.fp_lo, self.ids, qhi, qlo)

    def extract_fp(self, q_ids):
        """ids -> (fp_hi, fp_lo, hit_mask)."""
        pos = torch.searchsorted(self.rev_ids, q_ids)
        pos_c = pos.clamp(0, self.rev_ids.shape[0] - 1)
        hit = self.rev_ids[pos_c] == q_ids
        neg = torch.full_like(q_ids, -1)
        return (torch.where(hit, self.rev_hi[pos_c], neg),
                torch.where(hit, self.rev_lo[pos_c], neg), hit)

    @classmethod
    def from_numpy(cls, planes: dict, device) -> "TermTable":
        """A table from host planes (``KnowledgeBase.from_numpy``)."""
        return cls(**{k: torch.as_tensor(np.array(planes[k], np.int32),
                                         device=device)
                      for k in ("fp_hi", "fp_lo", "ids", "rev_ids", "rev_hi",
                                "rev_lo", "count")})


def table_from_host(fps: np.ndarray, ids: np.ndarray, device=None) -> TermTable:
    """Small host-built map (e.g. the TBox term map) -> TermTable."""
    hi, lo = pair64.split_np(fps)
    order = np.lexsort((lo, hi))
    hi, lo, ids = hi[order], lo[order], np.asarray(ids, dtype=np.int32)[order]
    rorder = np.argsort(ids, kind="stable")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return TermTable(
        fp_hi=t(hi), fp_lo=t(lo), ids=t(ids),
        rev_ids=t(ids[rorder]), rev_hi=t(hi[rorder]), rev_lo=t(lo[rorder]),
        count=t(np.int32(len(ids))),
    )


def build_local_dictionary(hi, lo, valid, base: int) -> TermTable:
    """Single-shard dictionary build.

    ``(hi, lo)`` are term-occurrence fingerprints, ``valid`` masks real
    occurrences.  Returns a TermTable of size len(hi) (padding rows carry
    SENTINEL fps / -1 ids) whose ids are ``base + rank`` in fp order.
    """
    dev = hi.device
    sentinel = torch.full_like(hi, SENTINEL)
    hi = torch.where(valid, hi, sentinel)
    lo = torch.where(valid, lo, sentinel)
    hi_s, lo_s, _ = pair64.sort_pairs(hi, lo)
    valid_s = hi_s != SENTINEL
    uniq = pair64.unique_mask_sorted(hi_s, lo_s) & valid_s
    ranks = torch.cumsum(uniq, 0, dtype=torch.int64) - 1  # dups share the head's rank
    ids = torch.where(valid_s, base + ranks,
                      torch.full_like(ranks, -1)).to(torch.int32)
    count = int(uniq.sum())

    # unique rows compacted to the front: the reverse view is dense in id
    # order (ids are assigned in fp order, so fp order == id order here)
    T = hi_s.shape[0]
    rev_hi = torch.full((T,), SENTINEL, dtype=torch.int32, device=dev)
    rev_lo = torch.full((T,), SENTINEL, dtype=torch.int32, device=dev)
    dest = ranks[uniq]
    rev_hi[dest] = hi_s[uniq]
    rev_lo[dest] = lo_s[uniq]
    ar = torch.arange(T, dtype=torch.int64, device=dev)
    rev_ids = torch.where(ar < count, base + ar,
                          torch.full_like(ar, INT32_MAX)).to(torch.int32)
    return TermTable(hi_s, lo_s, ids, rev_ids, rev_hi, rev_lo,
                     torch.tensor(count, dtype=torch.int32, device=dev))


def merge_tables(a: TermTable, b: TermTable) -> TermTable:
    """Union of two tables (disjoint key sets) -> one lex-sorted table."""
    hi = torch.cat([a.fp_hi, b.fp_hi])
    lo = torch.cat([a.fp_lo, b.fp_lo])
    ids = torch.cat([a.ids, b.ids])
    hi_s, lo_s, perm = pair64.sort_pairs(hi, lo)
    rev_ids = torch.cat([a.rev_ids, b.rev_ids])
    rev_hi = torch.cat([a.rev_hi, b.rev_hi])
    rev_lo = torch.cat([a.rev_lo, b.rev_lo])
    rperm = torch.sort(rev_ids, stable=True).indices
    return TermTable(
        hi_s, lo_s, ids[perm],
        rev_ids[rperm], rev_hi[rperm], rev_lo[rperm],
        a.count + b.count,
    )
