"""Lexicographic (hi, lo) binary search: the CUDA kernel and its plain version.

The port of ``pair_search_pallas``: for each query pair, its left insertion
point in a table sorted lexicographically by (hi, lo) — the contract of
``ref_pair_search``.  The table planes may be strided column views of the
permuted [T, 3] store rows (``index.key_cols``); the kernel
(``csrc/pair_search.cu``) reads them in place.

On a CPU tensor ``pair_search`` runs the plain version; on a CUDA tensor it
launches the kernel (counted in ``pair_search.launches``) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.utils import pair64

_P, _L = ctypes.c_void_p, ctypes.c_longlong


def pair_search_plain(table_hi, table_lo, qhi, qlo):
    """Plain version: one searchsorted over the int64 composite keys."""
    return pair64.searchsorted_pair(table_hi, table_lo, qhi, qlo, side="left")


def pair_search(table_hi: torch.Tensor, table_lo: torch.Tensor,
                qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """Lex-sorted table planes int32[T]; queries int32[n] -> int32[n]."""
    if qhi.device.type == "cpu":
        return pair_search_plain(table_hi, table_lo, qhi, qlo)
    build.require_cuda(table_hi, table_lo, qhi, qlo)
    if any(t.dtype != torch.int32 or t.dim() != 1
           for t in (table_hi, table_lo, qhi, qlo)):
        raise ValueError("pair_search takes 1-D int32 planes")
    if table_hi.shape != table_lo.shape or table_hi.stride() != table_lo.stride():
        raise ValueError("table planes must share one length and stride")
    n = qhi.shape[0]
    if qlo.shape[0] != n or table_hi.shape[0] == 0 or n == 0:
        raise ValueError("pair_search needs a non-empty table and matched "
                         "non-empty query planes")
    qhi, qlo = qhi.contiguous(), qlo.contiguous()
    out = torch.empty(n, dtype=torch.int32, device=qhi.device)
    fn = build.bind("pair_search", "pair_search",
                    [_P, _P, _L, _L, _P, _P, _L, _P, _P])
    build.check(fn(table_hi.data_ptr(), table_lo.data_ptr(),
                   table_hi.stride(0), table_hi.shape[0], qhi.data_ptr(),
                   qlo.data_ptr(), n, out.data_ptr(), build.stream(qhi.device)),
                "pair_search")
    pair_search.launches += 1
    return out


pair_search.launches = 0
