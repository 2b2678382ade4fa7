"""62-bit keys as (hi, lo) int32 pairs, and their int64 composite.

The reference keeps fingerprints as two int32 planes holding the top and
bottom 31 bits of a 62-bit value, because its accelerator has no fast
int64.  Both planes are non-negative 31-bit words, so lexicographic
(hi, lo) order is the numeric order of one int64 key — the form every
torch op here sorts and searches on.  ``pair_key`` builds that key for any
signed int32 planes (``hi * 2**32 + (lo + 2**31)``), so INVALID-padded and
offset probes order exactly as the plane-wise compare would.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 31
WORD_MASK = (1 << WORD_BITS) - 1


# -- host conversions --------------------------------------------------------

def split_np(fp: np.ndarray):
    """int64 62-bit values -> (hi, lo) int32 numpy planes."""
    fp = np.asarray(fp, dtype=np.int64)
    return (fp >> WORD_BITS).astype(np.int32), (fp & WORD_MASK).astype(np.int32)


def combine_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (np.asarray(hi, dtype=np.int64) << WORD_BITS) | np.asarray(lo, dtype=np.int64)


# -- device ops ---------------------------------------------------------------

def pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Lexicographic (hi, lo) order of int32 planes as one int64 key."""
    return (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + (1 << 31))


def pair_less(ahi, alo, bhi, blo):
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def pair_eq(ahi, alo, bhi, blo):
    return (ahi == bhi) & (alo == blo)


def sort_pairs(hi, lo):
    """Sort pairs lexicographically (stable); returns (hi_s, lo_s, perm)."""
    perm = torch.sort(pair_key(hi, lo), stable=True).indices
    return hi[perm], lo[perm], perm


def unique_mask_sorted(hi_s, lo_s):
    """mask[i] = True iff pair i differs from pair i-1 (first occurrence)."""
    prev_ne = ~pair_eq(hi_s[1:], lo_s[1:], hi_s[:-1], lo_s[:-1])
    return torch.cat([torch.ones(1, dtype=torch.bool, device=hi_s.device),
                      prev_ne])


def searchsorted_pair(table_hi, table_lo, qhi, qlo, side: str = "left"):
    """Insertion index of each query pair in a lex-sorted pair table (int32)."""
    return torch.searchsorted(pair_key(table_hi, table_lo), pair_key(qhi, qlo),
                              right=side == "right", out_int32=True)


def lookup_pair(table_hi, table_lo, values, qhi, qlo, default=-1):
    """Exact-match lookup: value for each query pair, ``default`` if absent."""
    if table_hi.shape[0] == 0:
        hit = torch.zeros(qhi.shape, dtype=torch.bool, device=qhi.device)
        return torch.full(qhi.shape, default, dtype=values.dtype,
                          device=qhi.device), hit
    pos = searchsorted_pair(table_hi, table_lo, qhi, qlo).long()
    pos_c = pos.clamp(0, table_hi.shape[0] - 1)
    hit = pair_eq(table_hi[pos_c], table_lo[pos_c], qhi, qlo)
    return torch.where(hit, values[pos_c],
                       torch.full_like(values[pos_c], default)), hit
