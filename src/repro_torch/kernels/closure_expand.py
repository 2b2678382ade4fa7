"""RDFS closure expansion: the CUDA kernel and its plain version.

The port of ``closure_expand_pallas``: for each concept id of ``conc``, a
lower-bound search in ``sorted_ids`` (clipped to the last slot) and, where
that slot holds the id, its row of ``anc_table[C, D]``; a miss gives a row
of -1 — the contract of ``ref_closure_expand``.  The kernel
(``csrc/closure_expand.cu``) fuses the search and the row copy: a template
kernel for D <= 32 (exact D up to 8, buckets of 16 and 32) that takes four
queries a thread, and a generic one past that.

On a CPU tensor ``closure_expand`` runs the plain version; on a CUDA tensor
it launches the kernel (counted in ``closure_expand.launches``) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_EXPAND = build.Entry("closure_expand", "closure_expand",
                      [_P, _L, _P, _I, _P, _I, _P, _P])


def closure_expand_plain(conc, sorted_ids, anc_table):
    """Plain version: searchsorted, clip, hit test, row gather."""
    pos = torch.searchsorted(sorted_ids, conc.contiguous()).clamp(
        0, sorted_ids.shape[0] - 1)
    hit = sorted_ids[pos] == conc
    return torch.where(hit[:, None], anc_table[pos], -1)


def closure_expand(conc: torch.Tensor, sorted_ids: torch.Tensor,
                   anc_table: torch.Tensor) -> torch.Tensor:
    """int32[n] ids, sorted int32[C], int32[C, D] -> int32[n, D]."""
    if conc.device.type == "cpu":
        return closure_expand_plain(conc, sorted_ids, anc_table)
    dev = build.require_cuda(conc, sorted_ids, anc_table)
    if (any(t.dtype != torch.int32 for t in (conc, sorted_ids, anc_table))
            or conc.dim() != 1 or sorted_ids.dim() != 1
            or anc_table.dim() != 2
            or anc_table.shape[0] != sorted_ids.shape[0]):
        raise ValueError("closure_expand takes int32 conc[n], sorted_ids[C] "
                         "and anc_table[C, D]")
    c = sorted_ids.shape[0]
    if c == 0:
        raise ValueError("closure_expand needs a non-empty sorted_ids")
    n, d = conc.shape[0], anc_table.shape[1]
    if d >= 1 << 23 or c * d >= 1 << 31:  # the kernels' offsets are int32
        raise ValueError(f"closure_expand takes D < 2**23 ancestors and "
                         f"C * D < 2**31, got C = {c}, D = {d}")
    conc, sorted_ids = conc.contiguous(), sorted_ids.contiguous()
    anc_table = anc_table.contiguous()
    out = torch.empty((n, d), dtype=torch.int32, device=dev)
    if n == 0 or d == 0:
        return out
    _EXPAND(dev, conc.data_ptr(), n, sorted_ids.data_ptr(), c,
            anc_table.data_ptr(), d, out.data_ptr())
    build.launched(closure_expand, dev)
    return out


closure_expand.launches = 0
