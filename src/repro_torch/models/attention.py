"""Attention variants: GQA/MQA (+sliding window) and DeepSeek-V2 MLA.

Attention is computed as the reference computes it: einsums and a
float32 softmax (``NEG_INF`` on masked scores, the weights cast to the
values' dtype before the PV product).  Decode steps write the new key
and value into the cache in place.

On DTensors (a sharded step) the projections stay DTensor ops and the
attention core between them (RoPE, scores, softmax, PV) runs as a local
region on each rank's batch rows and heads (``_local_core``), which needs
no collective: DTensor's own propagation through the core's batched
products is slow and picks layouts that move the scores.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharded as shd
from repro_torch.models.layers import apply_rope, normal

NEG_INF = -1e30


def _causal_mask(Sq, Skv, device):
    # query position i attends kv position j <= i
    qi = torch.arange(Sq, device=device)[:, None]
    kj = torch.arange(Skv, device=device)[None, :]
    return kj <= qi


def _check_pos(pos: int, max_seq: int) -> int:
    pos = int(pos)
    if not 0 <= pos < max_seq:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{max_seq} slots")
    return pos


def gqa_init(gen, cfg, dtype, device, lead: tuple = ()):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    return {
        "wq": normal(gen, lead + (d, H, hd), s, dtype, device),
        "wk": normal(gen, lead + (d, KV, hd), s, dtype, device),
        "wv": normal(gen, lead + (d, KV, hd), s, dtype, device),
        "wo": normal(gen, lead + (H, hd, d), 1.0 / np.sqrt(H * hd), dtype,
                     device),
    }


def _sdpa(q, k, v, mask):
    """q: (B,Sq,H,hd) k/v: (B,Skv,KV,hd); grouped heads; f32 softmax."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float()
    scores = scores / np.sqrt(hd)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def _kv_step(q_i, k_j, v_j, m, l, acc, ok, scale):
    """One (q tile, kv tile) step of the online softmax."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q_i, k_j).float()
    s = s * scale
    s = torch.where(ok, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bkgqs,bskh->bkgqh", p.to(v_j.dtype), v_j).float()
    return m_new, l_new, acc_new


def _sdpa_blockwise(q, k, v, window: int, is_global: bool,
                    q_chunk: int = 512, kv_chunk: int = 1024):
    """FlashAttention-style blockwise SDPA: an online softmax over
    (q_chunk, kv_chunk) tiles with the causal / sliding-window predicate
    computed per tile; never materializes (Sq, Skv) scores.  Under
    autograd each tile step is checkpointed, so the backward pass
    recomputes the tile's scores instead of keeping them.
    """
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    nq = max(1, Sq // q_chunk)
    nk = max(1, Skv // kv_chunk)
    qc = Sq // nq
    kc = Skv // nk
    qr = q.reshape(B, nq, qc, KV, G, hd)
    scale = 1.0 / np.sqrt(hd)
    step = _kv_step
    if torch.is_grad_enabled():
        def step(*args):
            return checkpoint(_kv_step, *args, use_reentrant=False)
    outs = []
    for qi in range(nq):
        q_i = qr[:, qi]  # (B, qc, KV, G, hd)
        # train/prefill positions are always 0..S-1 (batch-uniform)
        q_pos = qi * qc + torch.arange(qc, device=q.device)
        m = torch.full((B, KV, G, qc), -torch.inf, device=q.device)
        l = torch.zeros((B, KV, G, qc), device=q.device)
        acc = torch.zeros((B, KV, G, qc, hd), device=q.device)
        for ki in range(nk):
            kv_pos = ki * kc + torch.arange(kc, device=q.device)
            ok = kv_pos[None, :] <= q_pos[:, None]
            if window > 0 and not is_global:
                ok = ok & (kv_pos[None, :] > q_pos[:, None] - window)
            cut = slice(ki * kc, (ki + 1) * kc)
            m, l, acc = step(q_i, k[:, cut], v[:, cut], m, l, acc, ok, scale)
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, qc, KV, G, hd)
    out = torch.stack(outs, dim=1).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def gqa_forward_flagged(params, x, positions, window: int, is_global: bool,
                        impl: str = "naive"):
    """Training/prefill attention; ``window > 0`` and not ``is_global``
    means sliding-window causal, so one layer stack can interleave window
    patterns (gemma3)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if shd.is_dtensor(q):
        (out, k, v) = _local_core(
            lambda q_, k_, v_, pos: _gqa_core(q_, k_, v_, pos, window,
                                              is_global, impl),
            q, (k, v), positions)
    else:
        out, k, v = _gqa_core(q, k, v, positions, window, is_global, impl)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), (k, v)


def _gqa_core(q, k, v, positions, window: int, is_global: bool, impl: str):
    """RoPE and attention over projected (B, S, H|KV, hd) heads: the
    output and the roped k, and v."""
    S = q.shape[1]
    q = apply_rope(q, positions)
    k = apply_rope(k, positions)
    if impl == "blockwise":
        out = _sdpa_blockwise(q, k, v, window, is_global)
    elif impl == "stub":
        # measurement surrogate: one pass over v with the attention
        # output's shape, NOT a real model
        G = q.shape[2] // k.shape[2]
        out = torch.repeat_interleave(v, G, dim=2) + 0.0 * q
    else:
        mask = _causal_mask(S, S, q.device)
        if window > 0 and not is_global:
            qi = torch.arange(S, device=q.device)[:, None]
            kj = torch.arange(S, device=q.device)[None, :]
            mask = mask & (kj > qi - window)
        out = _sdpa(q, k, v, mask)
    return out, k, v


def _local_core(core, q, kvs, positions):
    """``core(q, *kvs, positions)`` on each rank's share, in the layout
    DTensor gave q where the core can run in it: on each mesh dim q's
    batch rows split (``Shard(0)``) or its heads (``Shard(2)``); any other
    placement becomes a split of the batch rows (or a replica when the dim
    does not divide them).  The kv tensors split their batch rows as q
    does, and where q's heads are split, their heads too when the dim
    divides them, else each rank takes the kv heads its q heads read (GQA
    groups) from the whole.  The core's first output comes back a
    DTensor in q's layout, the rest in their kv tensor's."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    mesh = q.device_mesh
    B, H = q.shape[0], q.shape[2]
    heads = [t.shape[2] for t in kvs if t.dim() == 4]
    q_pl, kv_pl, kv_grad, kv3_pl, kv3_grad = [], [], [], [], []
    rows = 1  # the mesh dims splitting the batch rows so far, multiplied
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if isinstance(p, Shard) and p.dim == 0:
            rows *= n
        if isinstance(p, Shard) and p.dim == 2:
            q_pl.append(p)
            split = all(h % n == 0 for h in heads)
            kv_pl.append(Shard(2) if split else Replicate())
            kv_grad.append(Shard(2) if split else Partial())
            kv3_pl.append(Replicate())
            kv3_grad.append(Partial())
        else:
            if not (isinstance(p, Shard) and p.dim == 0):
                p = Shard(0) if B % (rows * n) == 0 else Replicate()
                rows *= n if isinstance(p, Shard) else 1
            q_pl += [p]
            kv_pl += [p]
            kv_grad += [p]
            kv3_pl += [p]
            kv3_grad += [p]
    ql = q.redistribute(mesh, q_pl).to_local()
    _, (b0, _, h0, _) = compute_local_shape_and_global_offset(
        q.shape, mesh, q_pl)
    pos = positions[b0:b0 + ql.shape[0]]
    local = []
    for t in kvs:
        pl, gp = (kv_pl, kv_grad) if t.dim() == 4 else (kv3_pl, kv3_grad)
        tl = t.redistribute(mesh, pl).to_local(grad_placements=gp)
        sliced = False
        if t.dim() == 4 and tl.shape[2] == t.shape[2] and ql.shape[2] < H:
            G = H // t.shape[2]  # q heads per kv head
            lo, hi = h0 // G, (h0 + ql.shape[2] - 1) // G + 1
            sliced = hi - lo < t.shape[2]
            tl = tl[:, :, lo:hi]
        local.append((tl, pl, sliced))
    outs = [o.contiguous()
            for o in core(ql, *[tl for tl, _, _ in local], pos)]
    shape = tuple(q.shape[:-1]) + (outs[0].shape[-1],)  # MLA: hd < q's
    wrapped = [DTensor.from_local(outs[0], mesh, q_pl, run_check=False,
                                  shape=shape, stride=_strides(shape))]
    for o, t, (_, pl, sliced) in zip(outs[1:], kvs, local):
        # a slice of the kv heads is no whole tensor: not returned (only
        # a prefill's cache reads these)
        wrapped.append(None if sliced else DTensor.from_local(
            o, mesh, pl, run_check=False, shape=t.shape,
            stride=_strides(t.shape)))
    return tuple(wrapped)


def _strides(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def gqa_decode_flagged(params, x, cache_k, cache_v, pos, window: int,
                       is_global: bool):
    """One-token decode: x (B,1,d); cache (B,Smax,KV,hd); pos an int."""
    B = x.shape[0]
    Smax = cache_k.shape[1]
    pos = _check_pos(pos, Smax)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    posv = torch.full((B, 1), pos, device=x.device)
    q = apply_rope(q, posv)
    k = apply_rope(k, posv)
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    kj = torch.arange(Smax, device=x.device)
    mask = kj <= pos
    if window > 0 and not is_global:
        mask = mask & (kj > pos - window)
    out = _sdpa(q, cache_k, cache_v, mask[None, :])
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), (cache_k, cache_v)


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2): low-rank compressed KV cache
# ---------------------------------------------------------------------------


def mla_init(gen, cfg, dtype, device, lead: tuple = ()):
    d, H = cfg.d_model, cfg.n_heads
    hd, rd = cfg.head_dim, cfg.rope_dim
    ql, kvl = cfg.q_lora, cfg.kv_lora

    def mat(shape, fan_in):
        return normal(gen, lead + shape, 1.0 / np.sqrt(fan_in), dtype, device)

    return {
        "wdq": mat((d, ql), d),  # q down-projection
        "wuq": mat((ql, H, hd + rd), ql),  # q up (nope + rope parts)
        "wdkv": mat((d, kvl), d),  # shared latent KV down-projection
        "wkr": mat((d, rd), d),  # decoupled rope key (shared)
        "wuk": mat((kvl, H, hd), kvl),  # k up (nope)
        "wuv": mat((kvl, H, hd), kvl),  # v up
        "wo": mat((H, hd, d), H * hd),
    }


def mla_forward(params, x, positions, cfg):
    """Training/prefill MLA; returns compressed cache (c_kv, k_rope)."""
    q = torch.einsum("bsd,dq->bsq", x, params["wdq"])
    q = torch.einsum("bsq,qhk->bshk", q, params["wuq"])
    c_kv = torch.einsum("bsd,dc->bsc", x, params["wdkv"])  # (B,S,kv_lora)
    kr = torch.einsum("bsd,dr->bsr", x, params["wkr"])
    k_nope = torch.einsum("bsc,chk->bshk", c_kv, params["wuk"])
    v = torch.einsum("bsc,chk->bshk", c_kv, params["wuv"])
    hd = cfg.head_dim
    if shd.is_dtensor(q):
        out, _, _, k_rope = _local_core(
            lambda q_, kn, v_, kr_, pos: _mla_core(q_, kn, v_, kr_, pos, hd),
            q, (k_nope, v, kr), positions)
    else:
        out, _, _, k_rope = _mla_core(q, k_nope, v, kr, positions, hd)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), (c_kv, k_rope)


def _mla_core(q, k_nope, v, kr, positions, hd: int):
    """MLA's attention over projected heads: q (B,S,H,hd+rd), k_nope and
    v (B,S,H,hd), the shared rope key kr (B,S,rd) before RoPE.  Returns
    the output, k_nope, v and the roped key."""
    rd = kr.shape[-1]
    S = q.shape[1]
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions)
    k_rope = apply_rope(kr[:, :, None, :], positions)[:, :, 0]
    scale = 1.0 / np.sqrt(hd + rd)
    scores = (
        torch.einsum("bqhk,bshk->bhqs", q_nope, k_nope)
        + torch.einsum("bqhr,bsr->bhqs", q_rope, k_rope)
    ).float() * scale
    mask = _causal_mask(S, S, q.device)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqs,bshk->bqhk", w, v)
    return out, k_nope, v, k_rope


def mla_decode(params, x, cache_c, cache_kr, pos, cfg):
    """One-token decode against the compressed (c_kv, k_rope) cache, with
    ``wuk`` absorbed into the query: it attends in latent space."""
    hd, rd = cfg.head_dim, cfg.rope_dim
    B = x.shape[0]
    Smax = cache_c.shape[1]
    pos = _check_pos(pos, Smax)
    posv = torch.full((B, 1), pos, device=x.device)
    q = torch.einsum("bsd,dq->bsq", x, params["wdq"])
    q = torch.einsum("bsq,qhk->bshk", q, params["wuq"])
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, posv)

    c_new = torch.einsum("bsd,dc->bsc", x, params["wdkv"])
    kr_new = apply_rope(
        torch.einsum("bsd,dr->bsr", x, params["wkr"])[:, :, None, :],
        posv)[:, :, 0]
    cache_c[:, pos] = c_new[:, 0]
    cache_kr[:, pos] = kr_new[:, 0]

    # absorb wuk into q (the MLA trick): score = (q_nope @ wuk^T) . c_kv
    q_lat = torch.einsum("bqhk,chk->bqhc", q_nope, params["wuk"])
    scores = (
        torch.einsum("bqhc,bsc->bhqs", q_lat, cache_c)
        + torch.einsum("bqhr,bsr->bhqs", q_rope, cache_kr)
    ).float() / np.sqrt(hd + rd)
    mask = torch.arange(Smax, device=x.device)[None, :] <= pos
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhqs,bsc->bqhc", w, cache_c)  # latent space
    out = torch.einsum("bqhc,chk->bqhk", out_lat, params["wuv"])
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return out, (cache_c, cache_kr)
