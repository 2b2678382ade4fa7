"""LiteMat interval triple filter: the CUDA kernel and its plain version.

The port of ``interval_filter_pallas``: per row, ``plo <= p < phi and olo
<= o < ohi`` — the contract of ``ref_interval_filter`` — with no
compaction.  The kernel (``csrc/interval_filter.cu``) writes the bool mask
the ``ops`` wrapper returns; ``p`` and ``o`` may be strided column views of
an [N, 3] store, read in place.

On a CPU tensor ``interval_filter`` runs the plain version; on a CUDA
tensor it launches the kernel (counted in ``interval_filter.launches``) or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FILTER = build.Entry("interval_filter", "interval_filter",
                      [_P, _P, _L, _I, _I, _I, _I, _L, _P, _P])


def interval_filter_plain(p, o, params):
    """Plain version: the predicate as four compares."""
    plo, phi, olo, ohi = params
    return (p >= plo) & (p < phi) & (o >= olo) & (o < ohi)


def check_columns(p: torch.Tensor, o: torch.Tensor) -> None:
    """``p``/``o`` are int32[n] views sharing one stride (else raise)."""
    if (p.dtype != torch.int32 or o.dtype != torch.int32 or p.dim() != 1
            or o.shape != p.shape or p.stride() != o.stride()):
        raise ValueError("p and o must be int32[n] views with one stride")


def interval_filter(p: torch.Tensor, o: torch.Tensor, params) -> torch.Tensor:
    """int32[n] columns (one shared stride), four ints -> bool[n]."""
    params = [int(v) for v in params]
    if p.device.type == "cpu":
        return interval_filter_plain(p, o, params)
    dev = build.require_cuda(p, o)
    check_columns(p, o)
    n = p.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    _FILTER(dev, p.data_ptr(), o.data_ptr(), p.stride(0), *params, n,
            out.data_ptr())
    build.launched(interval_filter, dev)
    return out


interval_filter.launches = 0
