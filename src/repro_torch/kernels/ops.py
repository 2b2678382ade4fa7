"""Public wrappers around the ported kernels.

Each wrapper keeps the contract of its namesake in the JAX package's
``kernels/ops.py`` — outputs sliced to the input length, INVALID padding,
totals for overflow accounting — and leaves the kernel launch to the
kernel module (stream_compact.py, pair_search.py, merge_sorted.py,
interval_filter.py, msc_select.py, closure_expand.py), which runs the CUDA
kernel on a CUDA tensor and the plain version on a CPU one.
The helpers with no kernel (``segment_positions``, ``two_source_gather``,
the tile stitch of K8's compaction) are plain torch.

The ``*_batched`` entry points are the member-axis forms the batched plan
body (``core/query.py``'s ``run_batch``) calls: B same-shape calls in one
launch, each output with a leading [B].  The reference reaches the same
functions through ``jax.vmap`` of its solo entries; here they are entry
points of their own, kept out of ``__all__`` like ``pair_range``.  Each
bumps its pass counter once per call.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels import closure_expand as _ce
from repro_torch.kernels import interval_filter as _if
from repro_torch.kernels import merge_sorted as _ms
from repro_torch.kernels import msc_select as _msc
from repro_torch.kernels import pair_search as _ps
from repro_torch.kernels import stream_compact as _sc
from repro_torch.obs.metrics import REGISTRY
from repro_torch.utils import pair64

INVALID = int(np.iinfo(np.int32).max)

# Kernel-pass accounting by kind.  The JAX package bumps these while a plan
# is traced (once per compiled executable); eager torch has no trace, so
# here they count wrapper calls — the per-launch counts live on the kernel
# wrappers themselves (``<wrapper>.launches``).  Every bump is mirrored into
# the process registry as ``kernels/passes{kind=...}``.  No query path
# calls ``dual_compact_indices`` (rewrite mode compacts through
# ``rewrite_member_compact``), so ``dual_compact`` moves only when a caller
# uses that entry point directly.
pass_counters = {"compact": 0, "dual_compact": 0, "member_compact": 0,
                 "merge_resident": 0, "merge_partitioned": 0}
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


# The kernels whose wrappers already keep the reference's contract: the
# LiteMat triple filter (bool[n]), the grouped MSC keep-mask (bool[G, K])
# and the ancestor-row expansion (int32[n, D], -1 on a miss).
interval_filter = _if.interval_filter
msc_select = _msc.msc_select
closure_expand = _ce.closure_expand


def pair_search(table_hi, table_lo, qhi, qlo):
    """Lexicographic binary search (left); -> int32 positions.

    An empty table puts every query at 0.
    """
    n = qhi.shape[0]
    if table_hi.shape[0] == 0 or n == 0:
        return torch.zeros(n, dtype=torch.int32, device=qhi.device)
    return _ps.pair_search(table_hi, table_lo, qhi, qlo)


def pair_range(table_hi, table_lo, qhi, qlo):
    """Both bounds of an INL probe in one launch -> (starts, ends) int32:
    ``pair_search`` of (qhi, qlo) and of (qhi, qlo + 1), the + 1 wrapping
    in int32 as torch's add does.  An empty table puts every bound at 0.
    A launch fusion for ``core/query.py::_inl_ranges``, not part of the
    reference's ``ops`` surface."""
    n = qhi.shape[0]
    if table_hi.shape[0] == 0 or n == 0:
        zeros = torch.zeros(n, dtype=torch.int32, device=qhi.device)
        return zeros, zeros
    return _ps.pair_range(table_hi, table_lo, qhi, qlo)


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
    otherwise.  One merge-path kernel serves both, through one wrapper
    per branch (``merge_path`` / ``merge_path_resident``).
    """
    n, m = a_hi.shape[0], b_hi.shape[0]
    if m == 0:
        return torch.arange(n, dtype=torch.int32, device=a_hi.device)
    if n == 0:
        return torch.arange(m, dtype=torch.int32, device=a_hi.device)
    if n >= block and m >= block:
        _bump_pass("merge_partitioned")
        return _ms.merge_path(a_hi, a_lo, b_hi, b_lo, block=block)
    _bump_pass("merge_resident")
    return _ms.merge_path_resident(a_hi, a_lo, b_hi, b_lo, block=block)


def two_source_gather(base, delta, idx):
    """Gather rows addressed in combined [base | delta] coordinates.

    ``idx < base_n`` selects ``base[idx]``; the rest select
    ``delta[idx - base_n]`` — the virtual concatenation every live store
    view uses, so a mutation never re-concatenates the base.  ``delta=None``
    (a delta-free view) is a plain base gather.  Indices are clamped into
    range, as the reference's gathers clamp them.
    """
    bn = base.shape[0]
    idx = idx.long()
    if delta is None or delta.shape[0] == 0:
        if bn == 0:
            return torch.zeros((idx.shape[0], *base.shape[1:]),
                               dtype=base.dtype, device=base.device)
        return base[idx.clamp(0, bn - 1)]
    dn = delta.shape[0]
    if bn == 0:  # fully compacted-away base: every coord is a delta coord
        return delta[idx.clamp(0, dn - 1)]
    b = base[idx.clamp(0, bn - 1)]
    d = delta[(idx - bn).clamp(0, dn - 1)]
    from_d = (idx >= bn).reshape(idx.shape + (1,) * (base.dim() - 1))
    return torch.where(from_d, d, b)


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


def segment_positions_batched(starts, lens, cap: int):
    """``segment_positions`` per member: starts/lens [B, k] -> (src int32[B,
    cap], ok bool[B, cap], total int32[B], seg int32[B, cap]), row b what
    ``segment_positions(starts[b], lens[b], cap)`` gives."""
    b = lens.shape[0]
    offsets = torch.cumsum(lens, 1, dtype=torch.int64)
    total = offsets[:, -1]
    begin = offsets - lens
    j = torch.arange(cap, dtype=torch.int64, device=lens.device)
    seg = torch.searchsorted(offsets, j.expand(b, cap).contiguous(),
                             right=True).clamp(0, lens.shape[1] - 1)
    src = starts.gather(1, seg) + (j - begin.gather(1, seg))
    return (src.to(torch.int32), j < total[:, None], total.to(torch.int32),
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
    0-filled past the end; ok bool[cap]; total int32 match count).  One
    single-pass kernel writes all three; ``block``, the reference's tile
    size, changes nothing in the result.
    """
    _bump_pass("compact")
    return _sc.compact_mask(mask, cap)


def compact_indices_batched(mask, cap: int):
    """``compact_indices`` for each row of a bool[B, n] mask, in one launch
    -> (take int32[B, cap], ok bool[B, cap], total int32[B])."""
    _bump_pass("compact")
    return _sc.compact_mask_batched(mask, cap)


def dual_compact_indices(mask_a, mask_b, cap: int, block: int = 512):
    """Stable compaction of two bool masks over the same rows in one pass.

    Returns (take_a, ok_a, total_a, take_b, ok_b, total_b), each triple
    what ``compact_indices`` returns for its mask.  One single-pass kernel
    writes both streams; ``block``, the reference's tile size, changes
    nothing in the result.
    """
    _bump_pass("dual_compact")
    a, b = _sc.dual_compact(mask_a, mask_b, cap)
    return (*a, *b)


def rewrite_member_compact(spo, alive, tid: int, mem, dom, rng, cap: int,
                           has_dom: bool, has_rng: bool, block: int = 512):
    """Fused rewrite-mode type-pattern member-set masks + compaction.

    One kernel pass over ``spo`` evaluates the RDFS reformulation of
    ``(?x rdf:type C)`` — subject branch ``(p == tid & o in mem) | p in
    dom`` and object branch ``p in rng`` — and compacts the matching row
    indices of each branch.  Returns ``(take_s, ok_s, total_s)``, extended
    with ``(take_o, ok_o, total_o)`` when ``has_rng``; each triple matches
    the ``compact_indices`` contract.  One single-pass kernel writes them
    all; ``block``, the reference's tile size, changes nothing.
    """
    _bump_pass("member_compact")
    streams = _sc.member_compact(spo[:, 0], spo[:, 1], spo[:, 2], alive, tid,
                                 mem, dom, rng, has_dom, has_rng, cap)
    return (*streams[0], *streams[1]) if has_rng else tuple(streams[0])


def rewrite_member_compact_batched(spo, alive, tid: int, mem, dom, rng,
                                   cap: int, has_dom: bool, has_rng: bool):
    """``rewrite_member_compact`` for B members over one store in one
    launch: ``mem``/``dom``/``rng`` int32[B, k], one padded set per member.
    Returns the same tuple, each plane with a leading [B]."""
    _bump_pass("member_compact")
    streams = _sc.member_compact_batched(spo[:, 0], spo[:, 1], spo[:, 2],
                                         alive, tid, mem, dom, rng, has_dom,
                                         has_rng, cap)
    return (*streams[0], *streams[1]) if has_rng else tuple(streams[0])


def interval_compact(p, o, params, cap: int, block: int = 512):
    """Fused interval predicate + compaction in one pass.

    ``params`` = (plo, phi, olo, ohi) as ints; ``p``/``o`` may be strided
    column views of the store rows.  Same returns as ``compact_indices``.
    """
    _bump_pass("compact")
    local, counts = _sc.interval_tiles(p, o, params, block)
    return _assemble_compact(local, counts, cap, block)


def masked_interval_compact(p, o, alive, params, cap: int, block: int = 512):
    """Fused interval predicate + liveness mask + compaction in one pass.

    ``params`` = (plo, phi, olo, ohi) as ints; ``p``/``o`` may be strided
    column views of the store rows.  Same returns as ``compact_indices``:
    one single-pass kernel writes them; ``block`` changes nothing.
    """
    _bump_pass("compact")
    return _sc.masked_interval_compact(p, o, alive, params, cap)


def masked_interval_compact_batched(p, o, alive, params, cap: int):
    """``masked_interval_compact`` for B members over one store in one
    launch: ``params`` int32[B, 4] on the store's device.  Returns (take
    int32[B, cap], ok bool[B, cap], total int32[B])."""
    _bump_pass("compact")
    return _sc.masked_interval_compact_batched(p, o, alive, params, cap)


__all__ = [
    "interval_filter", "msc_select", "closure_expand", "pair_search",
    "pair_search_windowed", "compact_indices", "dual_compact_indices",
    "interval_compact", "masked_interval_compact", "rewrite_member_compact",
    "merge_gather", "two_source_gather",
    "segment_positions", "auto_block", "LARGE_BLOCK", "pass_counters",
    "reset_pass_counters",
]
