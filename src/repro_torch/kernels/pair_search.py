"""Lexicographic (hi, lo) binary search: the CUDA kernel and its plain version.

The port of ``pair_search_pallas``: for each query pair, its left insertion
point in a table sorted lexicographically by (hi, lo) — the contract of
``ref_pair_search``.  The table planes may be strided column views of the
permuted [T, 3] store rows (``index.key_cols``); the kernel
(``csrc/pair_search.cu``) reads them in place.  Two wrappers share it:

  * ``pair_search`` — one lower bound per query;
  * ``pair_range``  — the two bounds of an INL probe in one launch, the
    lower bounds of (qhi, qlo) and (qhi, qlo + 1), the + 1 wrapping in
    int32 as torch's add does (``core/query.py::_inl_ranges``).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel (counted in ``<wrapper>.launches``) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.utils import pair64

_P, _L = ctypes.c_void_p, ctypes.c_longlong
_I32 = torch.int32
_SEARCH = build.Entry("pair_search", "pair_search",
                      [_P, _P, _L, _L, _P, _P, _L, _P, _P])
_RANGE = build.Entry("pair_search", "pair_range",
                     [_P, _P, _L, _L, _P, _P, _L, _P, _P, _P])


def pair_search_plain(table_hi, table_lo, qhi, qlo):
    """Plain version: one searchsorted over the int64 composite keys."""
    return pair64.searchsorted_pair(table_hi, table_lo, qhi, qlo, side="left")


def pair_range_plain(table_hi, table_lo, qhi, qlo):
    """Plain version: the two plain searches."""
    return (pair_search_plain(table_hi, table_lo, qhi, qlo),
            pair_search_plain(table_hi, table_lo, qhi, qlo + 1))


def _checked(table_hi, table_lo, qhi, qlo):
    """Check the kernel's arguments -> (device, contiguous qhi, qlo)."""
    dev = build.require_cuda(table_hi, table_lo, qhi, qlo)
    if (table_hi.dtype != _I32 or table_lo.dtype != _I32 or qhi.dtype != _I32
            or qlo.dtype != _I32 or table_hi.dim() != 1 or table_lo.dim() != 1
            or qhi.dim() != 1 or qlo.dim() != 1):
        raise ValueError("pair_search takes 1-D int32 planes")
    t = table_hi.shape[0]
    if table_lo.shape[0] != t or table_hi.stride(0) != table_lo.stride(0):
        raise ValueError("table planes must share one length and stride")
    n = qhi.shape[0]
    if qlo.shape[0] != n or t == 0 or n == 0:
        raise ValueError("pair_search needs a non-empty table and matched "
                         "non-empty query planes")
    if not qhi.is_contiguous():
        qhi = qhi.contiguous()
    if not qlo.is_contiguous():
        qlo = qlo.contiguous()
    return dev, qhi, qlo


def pair_search(table_hi: torch.Tensor, table_lo: torch.Tensor,
                qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """Lex-sorted table planes int32[T]; queries int32[n] -> int32[n]."""
    if qhi.device.type == "cpu":
        return pair_search_plain(table_hi, table_lo, qhi, qlo)
    dev, qhi, qlo = _checked(table_hi, table_lo, qhi, qlo)
    n = qhi.shape[0]
    out = torch.empty(n, dtype=_I32, device=dev)
    _SEARCH(dev, table_hi.data_ptr(), table_lo.data_ptr(), table_hi.stride(0),
            table_hi.shape[0], qhi.data_ptr(), qlo.data_ptr(), n,
            out.data_ptr())
    build.launched(pair_search, dev)
    return out


def pair_range(table_hi: torch.Tensor, table_lo: torch.Tensor,
               qhi: torch.Tensor, qlo: torch.Tensor):
    """Lex-sorted table planes int32[T]; queries int32[n] -> (starts, ends)
    int32[n]: what ``pair_search`` gives for (qhi, qlo) and (qhi, qlo + 1)."""
    if qhi.device.type == "cpu":
        return pair_range_plain(table_hi, table_lo, qhi, qlo)
    dev, qhi, qlo = _checked(table_hi, table_lo, qhi, qlo)
    n = qhi.shape[0]
    starts = torch.empty(n, dtype=_I32, device=dev)
    ends = torch.empty(n, dtype=_I32, device=dev)
    _RANGE(dev, table_hi.data_ptr(), table_lo.data_ptr(), table_hi.stride(0),
           table_hi.shape[0], qhi.data_ptr(), qlo.data_ptr(), n,
           starts.data_ptr(), ends.data_ptr())
    build.launched(pair_range, dev)
    return starts, ends


pair_search.launches = 0
pair_range.launches = 0
