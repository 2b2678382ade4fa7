"""Interval arithmetic on LiteMat ids.

The heart of the paper: for two TBox entities A, B encoded over
``total_bits`` bits with prefix encoding,

    B is subsumed by A   <=>   idA <= idB < bound(idA)
    bound(idA)            =    idA + 2 ** (total_bits - used_bits(A))

where ``used_bits(A)`` (= the paper's ``start + localLength``) is the number
of significant prefix bits of A.  Every function takes numpy arrays or
torch tensors and answers in the same kind.

Two id widths are supported:

* **narrow ids** — a single int32/int64 word.  Covers LUBM (14 bits) and
  DBPedia (27 bits) comfortably.  This is the fast path used on device.
* **wide ids** — fixed-size vectors of 30-bit words (most significant word
  first), for hierarchies like Wikidata whose encoding needs >31 bits (the
  paper measured 102).  Comparison is lexicographic; ``bound`` is
  precomputed host-side with Python bigints.
"""
from __future__ import annotations

import numpy as np
import torch

WIDE_WORD_BITS = 30
_WORD_MASK = (1 << WIDE_WORD_BITS) - 1


def _is_torch(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


def _as(x, like):
    """``x`` as an array of ``like``'s kind, dtype and device."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return np.asarray(x, dtype=like.dtype)


# ---------------------------------------------------------------------------
# Narrow ids
# ---------------------------------------------------------------------------


def bound_of(ids, used_bits, total_bits: int):
    """Upper (exclusive) bound of the subsumption interval of each id.

    ``used_bits`` broadcasts against ``ids``; ``total_bits`` is a Python int.
    """
    ids = ids if _is_torch(ids) else np.asarray(ids)
    shift = total_bits - _as(used_bits, ids)
    return ids + (_as(1, ids) << shift)


def is_subsumed_by(x, lo, hi):
    """x in [lo, hi) — vectorized; the paper's single-comparison matcher."""
    return (x >= lo) & (x < hi)


def ancestor_at(ids, ancestor_used_bits, total_bits: int):
    """Mask ``ids`` down to an ancestor's prefix (keep top ``used`` bits).

    For a concept id this reconstructs the id of its ancestor at the tree
    level that consumed ``ancestor_used_bits`` prefix bits — pure bit math,
    no table lookup.
    """
    ids = ids if _is_torch(ids) else np.asarray(ids)
    one = _as(1, ids)
    low_mask = (one << (total_bits - _as(ancestor_used_bits, ids))) - one
    return ids & ~low_mask


def lookup_index(sorted_ids, query_ids):
    """Index of each query id in a sorted id table; -1 if absent."""
    if _is_torch(sorted_ids, query_ids):
        ref = sorted_ids if isinstance(sorted_ids, torch.Tensor) else query_ids
        sorted_ids = torch.as_tensor(sorted_ids, device=ref.device)
        query_ids = torch.as_tensor(query_ids, dtype=sorted_ids.dtype,
                                    device=ref.device)
        pos = torch.searchsorted(sorted_ids, query_ids)
        pos = pos.clamp(0, sorted_ids.shape[0] - 1)
        found = sorted_ids[pos] == query_ids
        return torch.where(found, pos, torch.full_like(pos, -1))
    sorted_ids = np.asarray(sorted_ids)
    query_ids = np.asarray(query_ids)
    pos = np.clip(np.searchsorted(sorted_ids, query_ids), 0,
                  sorted_ids.shape[0] - 1)
    found = sorted_ids[pos] == query_ids
    return np.where(found, pos, -1)


# ---------------------------------------------------------------------------
# Wide ids (W words of 30 bits, most-significant word first)
# ---------------------------------------------------------------------------


def words_needed(total_bits: int) -> int:
    return max(1, -(-total_bits // WIDE_WORD_BITS))


def pack_wide(value: int, n_words: int) -> np.ndarray:
    """Python bigint -> int32[n_words] (MSW first)."""
    out = np.zeros((n_words,), dtype=np.int32)
    for i in range(n_words - 1, -1, -1):
        out[i] = value & _WORD_MASK
        value >>= WIDE_WORD_BITS
    if value:
        raise ValueError("value does not fit in the requested wide-id width")
    return out


def unpack_wide(words: np.ndarray) -> int:
    value = 0
    for w in np.asarray(words).tolist():
        value = (value << WIDE_WORD_BITS) | int(w)
    return value


def wide_bound_host(value: int, used_bits: int, total_bits: int) -> int:
    """bound() on host bigints (precomputed into device tables)."""
    return value + (1 << (total_bits - used_bits))


def lex_lt(a, b):
    """Lexicographic a < b over the trailing word axis. Shapes (..., W)."""
    if _is_torch(a, b):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        lt, gt = a < b, a > b
        eq = ~(lt | gt)
        # all words before index i equal: exclusive cumulative AND
        prefix = torch.cat([torch.ones_like(eq[..., :1]), eq[..., :-1]], -1)
        eq_prefix = torch.cumprod(prefix.to(torch.int32), -1).bool()
        return (lt & eq_prefix).any(-1)
    a, b = np.asarray(a), np.asarray(b)
    lt, gt = a < b, a > b
    eq = ~(lt | gt)
    prefix = np.concatenate([np.ones_like(eq[..., :1]), eq[..., :-1]], -1)
    eq_prefix = np.cumprod(prefix.astype(np.int32), -1).astype(bool)
    return np.any(lt & eq_prefix, axis=-1)


def lex_le(a, b):
    return ~lex_lt(b, a)


def wide_is_subsumed_by(x, lo, hi):
    """lo <= x < hi with (..., W) wide ids."""
    return lex_le(lo, x) & lex_lt(x, hi)
