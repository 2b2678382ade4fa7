"""Merge-path gather map of two lex-sorted runs: the CUDA kernel and its
plain version.

The port of ``merge_path_partitioned_pallas`` (with ``_diag_splits``) and
``merge_path_pallas``: for every slot of the stable merge of run A (n keys)
and run B (m keys), the source index — ``< n`` selects ``A[v]``, ``>= n``
selects ``B[v - n]``; equal keys place A first (``ref_merge_sorted``).  One
kernel (``csrc/merge_path.cu``) serves both of ``ops.merge_gather``'s
branches.  Key planes may be strided column views (the table side of
``ops.pair_search_windowed`` is two columns of the permuted store rows).

On a CPU tensor ``merge_path`` runs the plain version; on a CUDA tensor it
launches the kernel (counted in ``merge_path.launches``) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.utils import pair64

DEFAULT_BLOCK = 1024
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def merge_path_plain(a_hi, a_lo, b_hi, b_lo):
    """Plain version: each key's merged slot is its rank in the other run
    (A: left, B: right — ties put A first) plus its own index."""
    n, m = a_hi.shape[0], b_hi.shape[0]
    dev = a_hi.device
    pos_a = pair64.searchsorted_pair(b_hi, b_lo, a_hi, a_lo, side="left").long()
    pos_b = pair64.searchsorted_pair(a_hi, a_lo, b_hi, b_lo, side="right").long()
    ar_n = torch.arange(n, dtype=torch.int32, device=dev)
    ar_m = torch.arange(m, dtype=torch.int32, device=dev)
    out = torch.empty(n + m, dtype=torch.int32, device=dev)
    out[pos_a + ar_n] = ar_n
    out[pos_b + ar_m] = n + ar_m
    return out


def merge_path(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
               b_lo: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Lex-sorted runs int32[n] / int32[m] (n, m >= 1) -> int32[n + m]."""
    n, m = a_hi.shape[0], b_hi.shape[0]
    if n == 0 or m == 0:
        raise ValueError("merge_path needs two non-empty runs")
    if a_hi.device.type == "cpu":
        return merge_path_plain(a_hi, a_lo, b_hi, b_lo)
    build.require_cuda(a_hi, a_lo, b_hi, b_lo)
    if any(t.dtype != torch.int32 or t.dim() != 1
           for t in (a_hi, a_lo, b_hi, b_lo)):
        raise ValueError("merge_path takes 1-D int32 key planes")
    if (a_lo.shape[0] != n or b_lo.shape[0] != m
            or a_hi.stride() != a_lo.stride() or b_hi.stride() != b_lo.stride()):
        raise ValueError("each run's planes must share one length and stride")
    if not 1 <= block <= 1024:
        raise ValueError(f"block must be in [1, 1024], got {block}")
    nb = -(-(n + m) // block)
    splits = torch.empty(nb + 1, dtype=torch.int64, device=a_hi.device)
    out = torch.empty(n + m, dtype=torch.int32, device=a_hi.device)
    fn = build.bind("merge_path", "merge_path",
                    [_P, _P, _L, _L, _P, _P, _L, _L, _I, _P, _P, _P])
    build.check(fn(a_hi.data_ptr(), a_lo.data_ptr(), a_hi.stride(0), n,
                   b_hi.data_ptr(), b_lo.data_ptr(), b_hi.stride(0), m, block,
                   splits.data_ptr(), out.data_ptr(),
                   build.stream(a_hi.device)),
                "merge_path")
    merge_path.launches += 1
    return out


merge_path.launches = 0
