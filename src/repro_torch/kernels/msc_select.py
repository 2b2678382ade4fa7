"""Grouped most-specific-concept selection: the CUDA kernel and its plain version.

The port of ``msc_select_pallas``: ``conc``/``bounds`` are int32[G, K]
candidate concept ids of G groups (instances) and their subsumption
bounds, -1 padded.  Slot j is kept iff it is valid, no valid candidate of
its group lies strictly inside (conc[j], bounds[j]), and no earlier slot
duplicates it — the contract of ``ref_msc_select``.  The kernel
(``csrc/msc_select.cu``) writes the bool keep mask the ``ops`` wrapper
returns.

On a CPU tensor ``msc_select`` runs the plain version; on a CUDA tensor it
launches the kernel (counted in ``msc_select.launches``) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_MSC = build.Entry("msc_select", "msc_select", [_P, _P, _L, _I, _P, _P])


def msc_select_plain(conc, bounds):
    """Plain version: the (G, K, K) pairwise compare of the reference."""
    valid = conc >= 0
    c1, b1 = conc[:, :, None], bounds[:, :, None]  # candidate under test
    c2, v2 = conc[:, None, :], valid[:, None, :]  # the other candidates
    strict_desc = v2 & (c2 > c1) & (c2 < b1)
    k = conc.shape[1]
    slot = torch.arange(k, device=conc.device)
    earlier = slot[None, :, None] > slot[None, None, :]
    dup = v2 & (c2 == c1) & earlier
    return valid & ~(strict_desc | dup).any(dim=2)


def msc_select(conc: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """int32[G, K] ids and bounds (-1 padded) -> bool[G, K] keep mask."""
    if conc.device.type == "cpu":
        return msc_select_plain(conc, bounds)
    dev = build.require_cuda(conc, bounds)
    if (conc.dtype != torch.int32 or bounds.dtype != torch.int32
            or conc.dim() != 2 or bounds.shape != conc.shape):
        raise ValueError("msc_select takes int32[G, K] conc and bounds")
    conc, bounds = conc.contiguous(), bounds.contiguous()
    g, k = conc.shape
    keep = torch.empty((g, k), dtype=torch.bool, device=dev)
    if g == 0 or k == 0:
        return keep
    _MSC(dev, conc.data_ptr(), bounds.data_ptr(), g, k, keep.data_ptr())
    build.launched(msc_select, dev)
    return keep


msc_select.launches = 0
