"""Stable stream compaction: the CUDA kernels and their plain versions.

Four wrappers launch the single-pass compaction (``csrc/stream_compact.cu``'s
``compact_lookback``, one predicate each) and return ``ops``' contract
themselves, per output stream: ``take int32[cap]`` (the indices of the
first ``cap`` matching rows, 0 behind), ``ok bool[cap]`` (slot < total)
and ``total`` (int32, 0-d):

  * ``compact_mask``            — a bool mask (the port of
    ``stream_compact_pallas``),
  * ``dual_compact``            — two bool masks over the same rows, each
    compacted into its own stream (the port of ``dual_compact_pallas``),
  * ``masked_interval_compact`` — ``plo <= p < phi and olo <= o < ohi and
    alive`` per row (the port of ``masked_interval_compact_pallas``),
  * ``member_compact``          — the rewrite-mode type pattern (the port
    of ``member_compact_pallas``): the subject stream ``(p == tid and o in
    mem) or p in dom`` and, with ``has_rng``, the object stream ``p in
    rng``, each ANDed with ``alive and s != INVALID`` and compacted on its
    own; the sorted id sets are searched inside the kernel.

In the last two, ``p``/``o`` (and ``s``) may be strided column views of an
[N, 3] store, read in place.  Each is one ctypes call: the entry point
zeroes the outputs and the look-back state and launches the kernel; no
torch op follows it.

Three of them have a batched form — what ``jax.vmap`` of the TPU kernel
computes: B independent compactions of one shape and one cap, in ONE
launch, each output gaining a leading [B]: ``compact_mask_batched``
(masks bool[B, n]: one CTA per member and tile),
``masked_interval_compact_batched`` (one store, bounds int32[B, 4] on the
device) and ``member_compact_batched`` (one store, sets [B, k] each).  The
last two run ``compact_lookback_group``: a CTA reads a tile of the shared
store once and compacts it for a group of up to 16 members, so one launch
reads the store ceil(B / 16) times (``launched_ctas`` reads back how many
CTAs a launch ran).

One wrapper launches the tile-local kernel (``compact_tiles``), fusing a
predicate with a compaction per tile: ``interval_tiles``, the interval
predicate without ``alive`` (the port of ``interval_compact_pallas``).
Its output is ``(local int32[nb * block], counts int32[nb])`` with the
contract of ``ref_stream_compact`` (``compact_tiles_plain``): tile t's
slice holds the global indices of its matching rows in ascending order,
INVALID behind them.  Rows past the input length are padding and never
match; an empty input still yields one (all-padding) tile.  kernels/ops.py
stitches the tiles.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel (counted in ``<wrapper>.launches``) or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.interval_filter import (
    check_columns, interval_filter_plain,
)

INVALID = int(np.iinfo(np.int32).max)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_OUT = [_L, _P, _P, _P, _P, _L, _L, _P]  # cap, the outputs, the stream
_COMPACT_MASK = build.Entry("stream_compact", "compact_mask", [_P, _L, *_OUT])
_MASKED_INTERVAL = build.Entry(
    "stream_compact", "masked_interval_compact",
    [_P, _P, _L, _P, _I, _I, _I, _I, _L, *_OUT])
_INTERVAL = build.Entry("stream_compact", "interval_compact",
                        [_P, _P, _L, _I, _I, _I, _I, _L, _I, _I, _P, _P, _P])
_MEMBER = build.Entry("stream_compact", "member_compact",
                      [_P, _P, _P, _L, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I,
                       _L, *_OUT])
_DUAL_MASK = build.Entry("stream_compact", "dual_compact_mask",
                         [_P, _P, _L, *_OUT])
_COMPACT_MASK_B = build.Entry("stream_compact", "compact_mask_batched",
                              [_P, _L, _L, _L, *_OUT])
_MASKED_INTERVAL_B = build.Entry(
    "stream_compact", "masked_interval_compact_batched",
    [_P, _P, _L, _P, _P, _L, _L, *_OUT])
_MEMBER_B = build.Entry("stream_compact", "member_compact_batched",
                        [_P, _P, _P, _L, _P, _I, _P, _I, _P, _I, _P, _I, _I,
                         _I, _L, _L, *_OUT])
_TILE_ROWS = 8192  # compact_lookback's rows per tile


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


def compact_mask_plain(mask: torch.Tensor, cap: int):
    """Plain version: ``torch.nonzero``, then a cut to ``cap``."""
    idx = torch.nonzero(mask).squeeze(1)
    total = idx.shape[0]
    take = torch.zeros(cap, dtype=torch.int32, device=mask.device)
    k = min(cap, total)
    take[:k] = idx[:k]
    ok = torch.arange(cap, device=mask.device) < total
    return take, ok, torch.tensor(total, dtype=torch.int32, device=mask.device)


def _scratch_at(outs: int, cap: int) -> int:
    """Where the scratch starts, in int32 words, in the buffer of
    ``_lookback_outputs`` for ``outs`` output streams of ``cap`` slots."""
    slots = outs * cap
    at = slots + outs + -(-slots // 4)
    return at + (at & 1)  # int64 words start 8-byte aligned


def launched_ctas(take: torch.Tensor, streams: int) -> int:
    """The CTAs that the look-back launch which wrote ``take`` (stream 0's
    take of a batched or solo output of ``streams`` streams, on the device)
    ran, read back from its ticket: each CTA draws one.  Over ``n`` rows a
    launch runs ceil(n / 8192) tiles per read of the store.  Synchronizes.
    """
    b, cap = (1, take.shape[0]) if take.dim() == 1 else tuple(take.shape)
    ticket = torch.empty(0, dtype=torch.int32, device=take.device).set_(
        take.untyped_storage(), _scratch_at(streams * b, cap), (2,), (1,))
    return int(ticket.view(torch.int64).item())


def _lookback_outputs(dev: torch.device, streams: int, n: int, cap: int,
                      members: int | None = None):
    """The outputs of one look-back launch over ``n`` rows, in one int32
    buffer that the entry point zeroes whole: take int32[streams * B * cap],
    total int32[streams * B], ok bool[streams * B * cap] (a byte per slot),
    then the scratch (int64 words: the ticket, then each output stream's
    tile status words).  B is ``members`` (1 when None, the solo shapes).

    Returns (the entry's trailing arguments but the stream, [(take, ok,
    total)] per stream): [cap], [cap] and 0-d solo, [B, cap], [B, cap] and
    [B] batched.  The views are made with ``as_strided``, the cheapest view
    torch has: this runs once per launch.
    """
    b = 1 if members is None else members
    if n >= 1 << 31 or cap < 0 or b < 1:
        raise ValueError(f"the compaction takes n < 2**31 rows, cap >= 0 and "
                         f"members >= 1, got n={n}, cap={cap}, members={b}")
    outs = streams * b  # output streams: member j's stream st is st * b + j
    words = 1 + outs * (n // _TILE_ROWS + 2)  # a ragged head adds a tile
    slots = outs * cap
    ok_at = slots + outs
    scratch_at = _scratch_at(outs, cap)
    buf = torch.empty(scratch_at + 2 * words, dtype=torch.int32, device=dev)
    ok_bytes = buf.view(torch.bool)
    at = buf.data_ptr()
    args = (cap, at, at + 4 * ok_at, at + 4 * slots, at + 4 * scratch_at,
            words, 4 * buf.shape[0])
    if members is None:
        return args, [(buf.as_strided((cap,), (1,), st * cap),
                       ok_bytes.as_strided((cap,), (1,), 4 * ok_at + st * cap),
                       buf.as_strided((), (), slots + st))
                      for st in range(streams)]
    return args, [(buf.as_strided((b, cap), (cap, 1), st * b * cap),
                   ok_bytes.as_strided((b, cap), (cap, 1),
                                       4 * ok_at + st * b * cap),
                   buf.as_strided((b,), (1,), slots + st * b))
                  for st in range(streams)]


def _stack_plain(outs):
    """Per-member plain outputs [(take, ok, total)] -> one batched triple."""
    if not outs:
        raise ValueError("a batch needs at least one member")
    return tuple(torch.stack(planes) for planes in zip(*outs))


def compact_mask(mask: torch.Tensor, cap: int):
    """bool[n] -> (take int32[cap], ok bool[cap], total int32 0-d).

    ``mask`` must be contiguous (any alignment: a view such as ``keep[1:]``
    is read in place).
    """
    if mask.device.type == "cpu":
        return compact_mask_plain(mask, cap)
    dev = build.require_cuda(mask)
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise ValueError("compact_mask takes a contiguous 1-D bool mask")
    n = mask.shape[0]
    args, (out,) = _lookback_outputs(dev, 1, n, cap)
    _COMPACT_MASK(dev, mask.data_ptr(), n, *args)
    build.launched(compact_mask, dev)
    return out


compact_mask.launches = 0


def compact_mask_batched_plain(mask: torch.Tensor, cap: int):
    """Plain version: the solo plain version per member, stacked."""
    return _stack_plain([compact_mask_plain(m, cap) for m in mask])


def compact_mask_batched(mask: torch.Tensor, cap: int):
    """bool[B, n] -> (take int32[B, cap], ok bool[B, cap], total int32[B]):
    member b's row what ``compact_mask(mask[b], cap)`` gives, in one launch.

    ``mask``'s rows must each be contiguous (any alignment, any row stride).
    """
    if mask.device.type == "cpu":
        return compact_mask_batched_plain(mask, cap)
    dev = build.require_cuda(mask)
    if (mask.dtype != torch.bool or mask.dim() != 2 or mask.shape[0] < 1
            or (mask.shape[1] > 1 and mask.stride(1) != 1)):
        raise ValueError("compact_mask_batched takes a bool[B, n] mask, "
                         "B >= 1, with contiguous rows")
    members, n = mask.shape
    args, (out,) = _lookback_outputs(dev, 1, n, cap, members)
    _COMPACT_MASK_B(dev, mask.data_ptr(), members, n, mask.stride(0), *args)
    build.launched(compact_mask_batched, dev)
    return out


compact_mask_batched.launches = 0


def _check_alive(alive: torch.Tensor, n: int) -> None:
    if (alive.dtype != torch.bool or alive.shape != (n,)
            or not alive.is_contiguous()):
        raise ValueError("alive must be a contiguous bool[n]")


def interval_mask(p, o, alive, params):
    """The fused scan predicate, row by row (plain version's first half)."""
    return interval_filter_plain(p, o, params) & alive


def masked_interval_compact_plain(p, o, alive, params, cap: int):
    """Plain version: the predicate, then the plain compaction."""
    return compact_mask_plain(interval_mask(p, o, alive, params), cap)


def masked_interval_compact(p: torch.Tensor, o: torch.Tensor,
                            alive: torch.Tensor, params, cap: int):
    """Fused interval + liveness predicate and compaction in one pass ->
    (take int32[cap], ok bool[cap], total int32 0-d).

    ``p``/``o``: int32[n] (strided views allowed, one shared stride);
    ``alive``: bool[n]; ``params``: four ints (plo, phi, olo, ohi).
    """
    params = [int(v) for v in params]
    if p.device.type == "cpu":
        return masked_interval_compact_plain(p, o, alive, params, cap)
    dev = build.require_cuda(p, o, alive)
    check_columns(p, o)
    n = p.shape[0]
    _check_alive(alive, n)
    args, (out,) = _lookback_outputs(dev, 1, n, cap)
    _MASKED_INTERVAL(dev, p.data_ptr(), o.data_ptr(), p.stride(0),
                     alive.data_ptr(), *params, n, *args)
    build.launched(masked_interval_compact, dev)
    return out


masked_interval_compact.launches = 0


def masked_interval_compact_batched_plain(p, o, alive, params, cap: int):
    """Plain version: the solo plain version per member's bounds, stacked."""
    return _stack_plain([masked_interval_compact_plain(p, o, alive, prm, cap)
                         for prm in params.tolist()])


def masked_interval_compact_batched(p: torch.Tensor, o: torch.Tensor,
                                    alive: torch.Tensor, params: torch.Tensor,
                                    cap: int):
    """The fused scan for B members over one store in one launch ->
    (take int32[B, cap], ok bool[B, cap], total int32[B]).

    ``p``/``o``/``alive`` as ``masked_interval_compact`` takes them, shared;
    ``params``: int32[B, 4] (plo, phi, olo, ohi per member) on the store's
    device, read there by each group's CTAs (no host copy).
    """
    if p.device.type == "cpu":
        return masked_interval_compact_batched_plain(p, o, alive, params, cap)
    dev = build.require_cuda(p, o, alive, params)
    check_columns(p, o)
    n = p.shape[0]
    _check_alive(alive, n)
    if (params.dtype != torch.int32 or params.dim() != 2
            or params.shape[1] != 4 or params.shape[0] < 1):
        raise ValueError("params must be int32[B, 4], B >= 1")
    if not params.is_contiguous() or params.data_ptr() % 16:
        params = params.clone()  # the kernel reads each row as one int4
    args, (out,) = _lookback_outputs(dev, 1, n, cap, params.shape[0])
    _MASKED_INTERVAL_B(dev, p.data_ptr(), o.data_ptr(), p.stride(0),
                       alive.data_ptr(), params.data_ptr(), params.shape[0], n,
                       *args)
    build.launched(masked_interval_compact_batched, dev)
    return out


masked_interval_compact_batched.launches = 0


def _check_block(block: int) -> None:
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")


def interval_tiles_plain(p, o, params, block: int):
    """Plain version: the interval predicate, then the plain compaction."""
    return compact_tiles_plain(interval_filter_plain(p, o, params), block)


def interval_tiles(p: torch.Tensor, o: torch.Tensor, params, block: int):
    """Fused interval predicate and compaction in one pass.

    ``p``/``o``: int32[n] (strided views allowed, one shared stride);
    ``params``: four ints (plo, phi, olo, ohi).
    """
    _check_block(block)
    params = [int(v) for v in params]
    if p.device.type == "cpu":
        return interval_tiles_plain(p, o, params, block)
    dev = build.require_cuda(p, o)
    check_columns(p, o)
    n = p.shape[0]
    nb = n_tiles(n, block)
    local = torch.empty(nb * block, dtype=torch.int32, device=dev)
    counts = torch.empty(nb, dtype=torch.int32, device=dev)
    _INTERVAL(dev, p.data_ptr(), o.data_ptr(), p.stride(0), *params, n, block,
              nb, local.data_ptr(), counts.data_ptr())
    build.launched(interval_tiles, dev)
    return local, counts


interval_tiles.launches = 0


def in_set(col: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Sorted-membership test; ``ids`` is INT32_MAX-padded (maybe all-pad)."""
    pos = torch.searchsorted(ids, col.contiguous()).clamp(0, ids.shape[0] - 1)
    return (ids[pos] == col) & (col != INVALID)


def member_masks(s, p, o, alive, tid: int, mem, dom, rng, has_dom: bool,
                 has_rng: bool):
    """The rewrite type pattern ``(?x rdf:type C)``'s row masks.

    Returns (mask_s, mask_o): rows binding ?x to their SUBJECT (explicit
    type triples, domain-entailing predicates) and rows binding it to their
    OBJECT (range-entailing predicates; None without ``has_rng``).  The
    branches are not exclusive: a row entailing C through both binds both
    endpoints.  The plain version's first half and the planner's counting
    pass (the reference's ``_type_rewrite_masks_dyn``).
    """
    valid = (s != INVALID) & alive
    m_s = (p == tid) & in_set(o, mem)
    if has_dom:
        m_s = m_s | in_set(p, dom)
    m_o = (in_set(p, rng) & valid) if has_rng else None
    return m_s & valid, m_o


def member_tiles_plain(s, p, o, alive, tid: int, mem, dom, rng,
                       has_dom: bool, has_rng: bool, block: int):
    """Plain version: the masks, then the plain compaction of each."""
    m_s, m_o = member_masks(s, p, o, alive, tid, mem, dom, rng, has_dom,
                            has_rng)
    out = [compact_tiles_plain(m_s, block)]
    if has_rng:
        out.append(compact_tiles_plain(m_o, block))
    return out


def member_compact_plain(s, p, o, alive, tid: int, mem, dom, rng,
                         has_dom: bool, has_rng: bool, cap: int):
    """Plain version: the masks, then the plain compaction of each."""
    m_s, m_o = member_masks(s, p, o, alive, tid, mem, dom, rng, has_dom,
                            has_rng)
    out = [compact_mask_plain(m_s, cap)]
    if has_rng:
        out.append(compact_mask_plain(m_o, cap))
    return out


def _check_member_args(s, p, o, alive, sets, set_dim: int) -> None:
    n = s.shape[0]
    if not (s.dtype == p.dtype == o.dtype == torch.int32 and s.dim() == 1
            and s.shape == p.shape == o.shape
            and s.stride() == p.stride() == o.stride()):
        raise ValueError("s, p and o must be int32[n] views with one stride")
    _check_alive(alive, n)
    for ids in sets:
        k = ids.shape[-1]
        if (ids.dtype != torch.int32 or ids.dim() != set_dim
                or not ids.is_contiguous() or k == 0 or k & (k - 1)):
            raise ValueError("member sets must be contiguous int32 of a "
                             "power-of-two length")


def member_compact(s: torch.Tensor, p: torch.Tensor, o: torch.Tensor,
                   alive: torch.Tensor, tid: int, mem: torch.Tensor,
                   dom: torch.Tensor, rng: torch.Tensor, has_dom: bool,
                   has_rng: bool, cap: int):
    """Fused rewrite type-pattern predicate and compaction in one pass.

    ``s``/``p``/``o``: int32[n] views with one shared stride (the columns
    of an [N, 3] store); ``alive``: bool[n]; ``mem``/``dom``/``rng``: sorted
    int32 sets padded with INT32_MAX to a power of two.  Returns a list of
    one (subject) or, with ``has_rng``, two (subject, object) triples
    (take int32[cap], ok bool[cap], total int32 0-d).
    """
    tid = int(tid)
    if s.device.type == "cpu":
        return member_compact_plain(s, p, o, alive, tid, mem, dom, rng,
                                    has_dom, has_rng, cap)
    dev = build.require_cuda(s, p, o, alive, mem, dom, rng)
    n = s.shape[0]
    _check_member_args(s, p, o, alive, (mem, dom, rng), 1)
    args, outs = _lookback_outputs(dev, 2 if has_rng else 1, n, cap)
    _MEMBER(dev, s.data_ptr(), p.data_ptr(), o.data_ptr(), s.stride(0),
            alive.data_ptr(), tid, mem.data_ptr(), mem.shape[0],
            dom.data_ptr(), dom.shape[0], rng.data_ptr(), rng.shape[0],
            int(has_dom), int(has_rng), n, *args)
    build.launched(member_compact, dev)
    return outs


member_compact.launches = 0


def member_compact_batched_plain(s, p, o, alive, tid: int, mem, dom, rng,
                                 has_dom: bool, has_rng: bool, cap: int):
    """Plain version: the solo plain version per member's sets, stacked."""
    per = [member_compact_plain(s, p, o, alive, tid, mem[b], dom[b], rng[b],
                                has_dom, has_rng, cap)
           for b in range(mem.shape[0])]
    return [_stack_plain([m[st] for m in per]) for st in range(len(per[0]))]


def member_compact_batched(s: torch.Tensor, p: torch.Tensor, o: torch.Tensor,
                           alive: torch.Tensor, tid: int, mem: torch.Tensor,
                           dom: torch.Tensor, rng: torch.Tensor, has_dom: bool,
                           has_rng: bool, cap: int):
    """The rewrite type pattern for B members over one store in one launch.

    ``s``/``p``/``o``/``alive``/``tid`` as ``member_compact`` takes them,
    shared; ``mem``/``dom``/``rng``: int32[B, k] (one sorted INT32_MAX-padded
    set per member, k a power of two per set).  Returns the streams of
    ``member_compact``, each (take int32[B, cap], ok bool[B, cap], total
    int32[B]).
    """
    tid = int(tid)
    if s.device.type == "cpu":
        return member_compact_batched_plain(s, p, o, alive, tid, mem, dom,
                                            rng, has_dom, has_rng, cap)
    dev = build.require_cuda(s, p, o, alive, mem, dom, rng)
    n = s.shape[0]
    _check_member_args(s, p, o, alive, (mem, dom, rng), 2)
    members = mem.shape[0]
    if members < 1 or dom.shape[0] != members or rng.shape[0] != members:
        raise ValueError("mem, dom and rng must hold one set per member")
    args, outs = _lookback_outputs(dev, 2 if has_rng else 1, n, cap, members)
    _MEMBER_B(dev, s.data_ptr(), p.data_ptr(), o.data_ptr(), s.stride(0),
              alive.data_ptr(), tid, mem.data_ptr(), mem.shape[1],
              dom.data_ptr(), dom.shape[1], rng.data_ptr(), rng.shape[1],
              int(has_dom), int(has_rng), members, n, *args)
    build.launched(member_compact_batched, dev)
    return outs


member_compact_batched.launches = 0


def dual_compact_tiles_plain(mask_a, mask_b, block: int):
    """The tile contract of each mask (``ref_dual_compact``'s body)."""
    return [compact_tiles_plain(mask_a, block),
            compact_tiles_plain(mask_b, block)]


def dual_compact_plain(mask_a, mask_b, cap: int):
    """Plain version: the plain compaction of each mask."""
    return [compact_mask_plain(mask_a, cap), compact_mask_plain(mask_b, cap)]


def dual_compact(mask_a: torch.Tensor, mask_b: torch.Tensor, cap: int):
    """Two bool[n] masks over the same rows -> [(take int32[cap], ok
    bool[cap], total int32 0-d)] for a, then for b, in one pass.

    Both masks must be contiguous, each at any alignment (views such as
    ``m[1:]`` beside ``m[3:]`` are read in place).
    """
    if mask_a.device.type == "cpu":
        return dual_compact_plain(mask_a, mask_b, cap)
    dev = build.require_cuda(mask_a, mask_b)
    if any(m.dtype != torch.bool or m.dim() != 1 or not m.is_contiguous()
           for m in (mask_a, mask_b)) or mask_b.shape != mask_a.shape:
        raise ValueError("dual_compact takes two contiguous bool[n] masks "
                         "of one length")
    n = mask_a.shape[0]
    args, outs = _lookback_outputs(dev, 2, n, cap)
    _DUAL_MASK(dev, mask_a.data_ptr(), mask_b.data_ptr(), n, *args)
    build.launched(dual_compact, dev)
    return outs


dual_compact.launches = 0
