"""Tile-local stable stream compaction: the CUDA kernel and its plain version.

Two wrappers share one templated kernel (``csrc/stream_compact.cu``):

  * ``compact_tiles``         — compacts a precomputed bool mask (the port
    of ``stream_compact_pallas``),
  * ``masked_interval_tiles`` — evaluates ``plo <= p < phi and olo <= o <
    ohi and alive`` per row and compacts in the same pass (the port of
    ``masked_interval_compact_pallas``); ``p`` and ``o`` may be strided
    column views of an [N, 3] store, read in place.

Both return ``(local int32[nb * block], counts int32[nb])`` with the
contract of ``ref_stream_compact``: tile t's slice holds the global indices
of its matching rows in ascending order, INVALID behind them.  Rows past
the input length are padding and never match; an empty input still yields
one (all-padding) tile.  kernels/ops.py stitches the tiles.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel (counted in ``<wrapper>.launches``) or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

INVALID = int(np.iinfo(np.int32).max)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def n_tiles(n: int, block: int) -> int:
    """Tiles covering n rows; an empty input still takes one tile."""
    return max(1, -(-n // block))


def compact_tiles_plain(mask: torch.Tensor, block: int):
    """Plain version: the ``ref_stream_compact`` oracle over the padded mask."""
    n = mask.shape[0]
    nb = n_tiles(n, block)
    m = torch.zeros(nb * block, dtype=torch.int32, device=mask.device)
    m[:n] = mask.to(torch.int32)
    m = m.view(nb, block)
    cnt = m.sum(1, dtype=torch.int32)
    order = torch.sort(1 - m, dim=1, stable=True).indices  # matches first
    gidx = torch.arange(nb, device=mask.device)[:, None] * block + order
    slot = torch.arange(block, device=mask.device)[None, :]
    local = torch.where(slot < cnt[:, None], gidx, INVALID)
    return local.reshape(-1).to(torch.int32), cnt


def _check_block(block: int) -> None:
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")


def compact_tiles(mask: torch.Tensor, block: int):
    """bool[n] -> (local int32[nb * block], counts int32[nb])."""
    _check_block(block)
    if mask.device.type == "cpu":
        return compact_tiles_plain(mask, block)
    build.require_cuda(mask)
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise ValueError("compact_tiles takes a contiguous 1-D bool mask")
    n = mask.shape[0]
    nb = n_tiles(n, block)
    local = torch.empty(nb * block, dtype=torch.int32, device=mask.device)
    counts = torch.empty(nb, dtype=torch.int32, device=mask.device)
    fn = build.bind("stream_compact", "stream_compact_mask",
                    [_P, _L, _I, _I, _P, _P, _P])
    build.check(fn(mask.data_ptr(), n, block, nb, local.data_ptr(),
                   counts.data_ptr(), build.stream(mask.device)),
                "stream_compact_mask")
    compact_tiles.launches += 1
    return local, counts


compact_tiles.launches = 0


def interval_mask(p, o, alive, params):
    """The fused scan predicate, row by row (plain version's first half)."""
    plo, phi, olo, ohi = params
    return (p >= plo) & (p < phi) & (o >= olo) & (o < ohi) & alive


def masked_interval_tiles_plain(p, o, alive, params, block: int):
    """Plain version: the predicate, then the plain compaction."""
    return compact_tiles_plain(interval_mask(p, o, alive, params), block)


def masked_interval_tiles(p: torch.Tensor, o: torch.Tensor,
                          alive: torch.Tensor, params, block: int):
    """Fused interval + liveness predicate and compaction in one pass.

    ``p``/``o``: int32[n] (strided views allowed, one shared stride);
    ``alive``: bool[n]; ``params``: four ints (plo, phi, olo, ohi).
    """
    _check_block(block)
    params = [int(v) for v in params]
    if p.device.type == "cpu":
        return masked_interval_tiles_plain(p, o, alive, params, block)
    build.require_cuda(p, o, alive)
    n = p.shape[0]
    if (p.dtype != torch.int32 or o.dtype != torch.int32 or p.dim() != 1
            or o.shape != p.shape or p.stride() != o.stride()):
        raise ValueError("p and o must be int32[n] views with one stride")
    if alive.dtype != torch.bool or alive.shape != p.shape or not alive.is_contiguous():
        raise ValueError("alive must be a contiguous bool[n]")
    nb = n_tiles(n, block)
    local = torch.empty(nb * block, dtype=torch.int32, device=p.device)
    counts = torch.empty(nb, dtype=torch.int32, device=p.device)
    fn = build.bind("stream_compact", "masked_interval_compact",
                    [_P, _P, _L, _P, _I, _I, _I, _I, _L, _I, _I, _P, _P, _P])
    build.check(fn(p.data_ptr(), o.data_ptr(), p.stride(0), alive.data_ptr(),
                   *params, n, block, nb, local.data_ptr(), counts.data_ptr(),
                   build.stream(p.device)),
                "masked_interval_compact")
    masked_interval_tiles.launches += 1
    return local, counts


masked_interval_tiles.launches = 0
