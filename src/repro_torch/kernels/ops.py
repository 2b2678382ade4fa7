"""Public wrappers around the ported kernels.

Each wrapper keeps the contract of its namesake in the JAX package's
``kernels/ops.py`` — outputs sliced to the input length, INVALID padding,
totals for overflow accounting — and leaves the kernel launch to the
kernel module (stream_compact.py, pair_search.py, merge_sorted.py), which
runs the CUDA kernel on a CUDA tensor and the plain version on a CPU one.
The helpers with no kernel (``segment_positions``, ``two_source_gather``,
the tile stitch) are plain torch.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels import merge_sorted as _ms
from repro_torch.kernels import pair_search as _ps
from repro_torch.kernels import stream_compact as _sc
from repro_torch.obs.metrics import REGISTRY
from repro_torch.utils import pair64

INVALID = int(np.iinfo(np.int32).max)

# Kernel-pass accounting by kind.  The JAX package bumps these while a plan
# is traced (once per compiled executable); eager torch has no trace, so
# here they count wrapper calls — the per-launch counts live on the kernel
# wrappers themselves (``<wrapper>.launches``).  Every bump is mirrored into
# the process registry as ``kernels/passes{kind=...}``.
pass_counters = {"compact": 0, "merge_resident": 0, "merge_partitioned": 0}
_PASS_LOCK = threading.Lock()


def _bump_pass(kind: str) -> None:
    with _PASS_LOCK:
        pass_counters[kind] += 1
    REGISTRY.counter("kernels/passes", kind=kind).inc()


def reset_pass_counters() -> dict:
    """Zero the pass counters; returns the pre-reset snapshot."""
    with _PASS_LOCK:
        snap = dict(pass_counters)
        for k in pass_counters:
            pass_counters[k] = 0
    return snap


# Compaction tile size: large stores take 4096-row tiles (8x fewer tiles
# and stitch segments), small ones 512-row tiles so padding stays bounded.
LARGE_BLOCK = 4096
_LARGE_N = 1 << 16


def auto_block(n: int) -> int:
    """Compaction tile size for an n-row store."""
    return LARGE_BLOCK if n >= _LARGE_N else 512


def pair_search(table_hi, table_lo, qhi, qlo):
    """Lexicographic binary search (left); -> int32 positions.

    An empty table puts every query at 0.
    """
    n = qhi.shape[0]
    if table_hi.shape[0] == 0 or n == 0:
        return torch.zeros(n, dtype=torch.int32, device=qhi.device)
    return _ps.pair_search(table_hi, table_lo, qhi, qlo)


def pair_search_windowed(table_hi, table_lo, qhi, qlo, block: int = 1024):
    """Lexicographic binary search as a stable merge (for large tables).

    Sort the queries (the probe side is small), merge the sorted query run
    against the table run, and read each query's position off its merge
    slot: query rank ``r`` landing at merged slot ``i`` has exactly
    ``i - r`` table keys before it.  Ties keep queries before equal table
    keys (run A first), so positions match the 'left' contract of
    ``pair_search``.  Queries are padded to ``block`` so a table of at
    least ``block`` rows takes the partitioned merge branch.
    """
    n = qhi.shape[0]
    dev = qhi.device
    perm = torch.sort(pair64.pair_key(qhi, qlo), stable=True).indices
    qh_s, ql_s = qhi[perm], qlo[perm]
    pad = max(block - n, 0)
    if pad:
        fill = torch.full((pad,), INVALID, dtype=torch.int32, device=dev)
        qh_s, ql_s = torch.cat([qh_s, fill]), torch.cat([ql_s, fill])
    nq = n + pad
    g = merge_gather(qh_s, ql_s, table_hi, table_lo, block=block)
    # the merge is stable and the query run sorted, so the slots holding
    # queries, in slot order, hold query ranks 0, 1, ..., nq - 1
    slots = torch.nonzero(g < nq).squeeze(1)
    pos = (slots - torch.arange(nq, device=dev)).to(torch.int32)
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    out[perm] = pos[:n]
    return out


def merge_gather(a_hi, a_lo, b_hi, b_lo, block: int = 1024):
    """Stable-merge gather map of two lex-sorted (hi, lo) pair runs.

    Returns int32[n + m]: values < n select run A, values >= n select
    ``B[value - n]``; ties keep A-before-B order (``ref.ref_merge_sorted``).
    The dispatch and its counters are the reference's: the partitioned
    branch when both runs reach ``block`` rows, the resident branch
    otherwise.  One merge-path kernel serves both.
    """
    n, m = a_hi.shape[0], b_hi.shape[0]
    if m == 0:
        return torch.arange(n, dtype=torch.int32, device=a_hi.device)
    if n == 0:
        return torch.arange(m, dtype=torch.int32, device=a_hi.device)
    _bump_pass("merge_partitioned" if n >= block and m >= block
               else "merge_resident")
    return _ms.merge_path(a_hi, a_lo, b_hi, b_lo, block=block)


def two_source_gather(base, delta, idx):
    """Gather rows addressed in combined [base | delta] coordinates.

    Static stores have no delta (``delta=None``), so this is a plain base
    gather; the overlay's second source arrives with the live store.
    Indices are clamped into range, as the reference's gathers clamp them.
    """
    if delta is not None:
        raise NotImplementedError("delta overlays are not ported yet")
    bn = base.shape[0]
    idx = idx.long()
    if bn == 0:
        return torch.zeros((idx.shape[0], *base.shape[1:]),
                           dtype=base.dtype, device=base.device)
    return base[idx.clamp(0, bn - 1)]


def segment_positions(starts, lens, cap: int):
    """Map output slots [0, cap) onto k variable-length segments.

    One inclusive prefix sum over ``lens`` assigns every output slot j a
    (segment, rank-in-segment); returns (src = starts[seg] + rank int32,
    ok = j < total, total int32, seg int32).
    """
    offsets = torch.cumsum(lens, 0, dtype=torch.int64)
    total = offsets[-1]
    begin = offsets - lens
    j = torch.arange(cap, dtype=torch.int64, device=lens.device)
    seg = torch.searchsorted(offsets, j, right=True).clamp(0, lens.shape[0] - 1)
    src = starts[seg] + (j - begin[seg])
    return (src.to(torch.int32), j < total, total.to(torch.int32),
            seg.to(torch.int32))


def _assemble_compact(local, counts, cap: int, block: int):
    """Stitch tile-compacted indices into one front-compacted [cap] gather.

    The per-tile counts are the segment lengths (tile t's matches start at
    t*block); the total match count rides along for overflow accounting.
    """
    tile_starts = torch.arange(counts.shape[0], dtype=torch.int64,
                               device=counts.device) * block
    src, ok, total, _ = segment_positions(tile_starts, counts, cap)
    take = local[src.long().clamp(0, local.shape[0] - 1)]
    return torch.where(ok, take, 0), ok, total


def compact_indices(mask, cap: int, block: int = 512):
    """Stable compaction of a bool mask.

    Returns (take int32[cap] — indices of the first cap True positions,
    0-filled past the end; ok bool[cap]; total int32 match count).
    """
    _bump_pass("compact")
    local, counts = _sc.compact_tiles(mask, block)
    return _assemble_compact(local, counts, cap, block)


def masked_interval_compact(p, o, alive, params, cap: int, block: int = 512):
    """Fused interval predicate + liveness mask + compaction in one pass.

    ``params`` = (plo, phi, olo, ohi) as ints; ``p``/``o`` may be strided
    column views of the store rows.  Same returns as ``compact_indices``.
    """
    _bump_pass("compact")
    local, counts = _sc.masked_interval_tiles(p, o, alive, params, block)
    return _assemble_compact(local, counts, cap, block)


__all__ = [
    "pair_search", "pair_search_windowed", "compact_indices",
    "masked_interval_compact", "merge_gather", "two_source_gather",
    "segment_positions", "auto_block", "LARGE_BLOCK", "pass_counters",
    "reset_pass_counters",
]
