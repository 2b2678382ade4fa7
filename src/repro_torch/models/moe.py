"""Mixture-of-Experts FFN: shared + routed experts, top-k, sort/gather
dispatch.

  1. router logits -> top-k (expert, weight) per token (ties go to the
     lower expert id, as ``jax.lax.top_k`` breaks them),
  2. rank each (token, slot) assignment within its expert: a stable sort
     by expert id, then ``searchsorted`` for each expert's first slot,
  3. scatter token ids into an (E, C) slot table (capacity-dropped),
  4. gather tokens -> (E, C, d), per-expert batched products, weighted
     scatter-add back.

The reference's ``.at[...].set(mode="drop")`` scatters send a dropped
assignment to slot ``E*C``; here they land in one spare slot past the
table, which is cut off, so nothing waits on the host for a count.

On DTensors (a sharded step, ``launch/cells.py``) the route and the
dispatch run as an explicit local region (``_moe_apply_sharded``):
``searchsorted`` has no sharding strategy, and the (E, C) slot table is
global.  Every rank routes its own share of the tokens; the per-expert
counts are all-gathered so each assignment's rank within its expert, and
so capacity and drops, are those of the whole batch, as the reference's
single program has them.  The table's slots are computed where the
experts live: expert e on the rank of 'model' index ``e // (E / m)``
(``lm_param_specs`` shards wi, wg and wo over 'model' on E), slot c on the
rank whose other coordinates, row-major, are chunk ``c // ceil(C / n)``.
Token rows go to the ranks of their slots and come back through one
``all_to_all_single`` each way over every rank of the mesh, in buffers
sized for the most a rank can send to another, so no assignment is ever
dropped for lack of room.  Rows move between buffers by ``index_select``
(its backward an ``index_add``): most of a buffer's slots are empty and
read one zero row, and advanced indexing's backward accumulates such a
run of equal indices serially.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import sharded as shd
from repro_torch.models.layers import mlp_apply, mlp_init, normal


def moe_init(gen, cfg, dtype, device, lead: tuple = ()):
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_dff
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(ff)
    p = {
        "router": normal(gen, lead + (d, E), s_in, torch.float32, device),
        "wi": normal(gen, lead + (E, d, ff), s_in, dtype, device),
        "wg": normal(gen, lead + (E, d, ff), s_in, dtype, device),
        "wo": normal(gen, lead + (E, ff, d), s_out, dtype, device),
    }
    if cfg.n_shared > 0:
        p["shared"] = mlp_init(gen, d, cfg.moe_dff * cfg.n_shared, "swiglu",
                               dtype, device, lead)
    return p


def route(router, xt, cfg) -> dict:
    """Top-k routing of tokens ``xt`` (T, d): router ``probs`` (T, E), the
    renormalized weights ``topw`` and expert ids ``tope`` (T, k), and per
    flattened (token, slot) assignment its ``slot`` in the (E*C,) table
    and whether it was ``kept`` under capacity ``C``."""
    T = xt.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    C = int(np.ceil(T * k / E * cfg.capacity_factor))  # in Python floats
    logits = (xt.float() @ router).float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: among equal probabilities the lower id first
    topw, tope = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, tope = topw[:, :k], tope[:, :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    flat_e = tope.reshape(-1)  # (T*k,)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    idx = torch.arange(T * k, device=xt.device)
    rank = torch.empty_like(idx).scatter_(0, order, idx - first)
    kept = rank < C
    slot = (torch.clamp(flat_e, 0, E - 1) * C + torch.clamp(rank, 0, C - 1))
    return {"probs": probs, "topw": topw, "tope": tope, "flat_e": flat_e,
            "slot": torch.where(kept, slot, E * C), "kept": kept, "C": C}


def moe_apply(params, x, cfg):
    """x: (B, S, d) -> (B, S, d), aux. Routed top-k + optional shared
    experts."""
    if shd.is_dtensor(x):
        return _moe_apply_sharded(params, x, cfg)
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)
    r = route(params["router"], xt, cfg)
    C, slot = r["C"], r["slot"]

    # (E*C,) token id feeding each expert slot; T = the empty sentinel
    tok_of_flat = torch.arange(T * k, device=x.device) // k
    slot_tok = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    slot_tok = slot_tok.scatter(0, slot, tok_of_flat)[:E * C]

    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    expert_in = xt_pad[slot_tok].reshape(E, C, d)
    h = torch.einsum("ecd,edf->ecf", expert_in, params["wi"])
    g = torch.einsum("ecd,edf->ecf", expert_in, params["wg"])
    h = h * F.silu(g)
    expert_out = torch.einsum("ecf,efd->ecd", h, params["wo"])  # (E, C, d)

    # combine: weighted scatter-add back to tokens
    slot_w = torch.zeros((E * C + 1,), dtype=torch.float32, device=x.device)
    slot_w = slot_w.scatter(0, slot, r["topw"].reshape(-1))[:E * C]
    contrib = (expert_out.reshape(E * C, d)
               * slot_w[:, None].to(expert_out.dtype))
    out = x.new_zeros((T + 1, d)).index_add(0, slot_tok, contrib)[:T]

    if "shared" in params:
        out = out + mlp_apply(params["shared"], xt, "swiglu")
    # load-balancing auxiliary loss (Switch-style)
    me = r["probs"].mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add(
        0, r["flat_e"], torch.full((T * k,), 1.0 / (T * k), device=x.device))
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, d), aux


def _ranks_within(keys: torch.Tensor) -> torch.Tensor:
    """Each entry's rank among the equal keys before it (in order)."""
    order = torch.sort(keys, stable=True).indices
    sk = keys[order]
    first = torch.searchsorted(sk, sk, side="left")
    idx = torch.arange(keys.shape[0], device=keys.device)
    return torch.empty_like(idx).scatter_(0, order, idx - first)


def _moe_apply_sharded(params, x, cfg):
    """``moe_apply`` on DTensors (see the module docstring)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    nd = mesh.ndim
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = int(np.ceil(T * k / E * cfg.capacity_factor))
    G = mesh.size()
    g = shd.flat_index(mesh)
    group = shd.flat_mesh(mesh)

    # this rank's tokens: chunk g of the flattened batch (padded when the
    # ranks do not divide it)
    xt = x.reshape(T, d)
    Tg = -(-T // G)
    if T % G == 0:
        xl = xt.redistribute(mesh, [Shard(0)] * nd).to_local()
        valid = None
    else:
        full = shd.replicated_local(xt)
        full = torch.cat([full, full.new_zeros((Tg * G - T, d))])
        xl = full[g * Tg:(g + 1) * Tg]
        valid = torch.arange(g * Tg, (g + 1) * Tg, device=xl.device) < T

    # route: the plain expressions on the local tokens
    router = shd.replicated_local(params["router"])
    logits = (xl.float() @ router).float()
    probs = torch.softmax(logits, dim=-1)
    topw, tope = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, tope = topw[:, :k], tope[:, :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    flat_e = tope.reshape(-1)  # (Tg*k,)
    if valid is not None:  # a padding token's assignments: bucket E
        flat_e = torch.where(valid.repeat_interleave(k), flat_e, E)

    # each assignment's rank within its expert over the whole batch
    counts = torch.zeros((E + 1,), dtype=torch.int64, device=xl.device)
    counts = counts.index_add(0, flat_e, torch.ones_like(flat_e))[:E]
    every = shd.all_gather(counts[None], group)  # (G, E), rank order
    before = (torch.cumsum(every, 0) - every)[g]
    grank = _ranks_within(flat_e) + before[torch.clamp(flat_e, max=E - 1)]
    kept = (grank < C) & (flat_e < E)

    # the rank computing each kept assignment's slot, and the slot there
    wi_pl = params["wi"].placements
    md = (mesh.mesh_dim_names.index("model")
          if "model" in (mesh.mesh_dim_names or ()) else None)
    split = md is not None and wi_pl[md] == Shard(0)
    es = mesh.size(md) if split else 1
    El = E // es
    n_chunks = G // es
    Cc = -(-C // n_chunks)
    e_c = torch.clamp(flat_e, max=E - 1)
    q = torch.clamp(grank // Cc, max=n_chunks - 1)
    owners = shd.owner_table(mesh, md if split else None, xl.device)
    owner = owners[q, e_c // El]
    lslot = (e_c % El) * Cc + (grank - q * Cc)

    # send buffers: (G, cap) rows, an assignment at its rank among those
    # bound for the same owner
    cap = min(Tg * min(k, El), El * Cc)
    key = torch.where(kept, owner, G)
    pos = _ranks_within(key)
    dest = torch.where(kept, key * cap + pos, G * cap)
    tok = torch.arange(Tg * k, device=xl.device) // k
    src_row = torch.full((G * cap + 1,), Tg, dtype=torch.long,
                         device=xl.device).scatter(0, dest, tok)[:G * cap]
    send_x = torch.cat([xl, xl.new_zeros((1, d))]).index_select(0, src_row)
    send_slot = torch.full((G * cap + 1,), -1, dtype=torch.long,
                           device=xl.device).scatter(
        0, dest, torch.where(kept, lslot, -1))[:G * cap]
    recv_x = shd.all_to_all(send_x, group)
    recv_slot = shd.all_to_all(send_slot, group, grad=False)

    # this rank's slots of its experts, filled from what it received
    R = G * cap
    hole = El * Cc
    at = torch.where(recv_slot >= 0, recv_slot, hole)
    slot_row = torch.full((hole + 1,), R, dtype=torch.long,
                          device=xl.device).scatter(
        0, at, torch.arange(R, device=xl.device))[:hole]
    expert_in = torch.cat([recv_x, recv_x.new_zeros((1, d))]).index_select(
        0, slot_row)
    expert_in = expert_in.reshape(El, Cc, d)
    keep = {md: Shard(0)} if split else {}
    wi = shd.replicated_local(params["wi"], keep)
    wg = shd.replicated_local(params["wg"], keep)
    wo = shd.replicated_local(params["wo"], keep)
    h = torch.einsum("ecd,edf->ecf", expert_in, wi)
    gg = torch.einsum("ecd,edf->ecf", expert_in, wg)
    h = h * F.silu(gg)
    expert_out = torch.einsum("ecf,efd->ecd", h, wo).reshape(hole, d)

    # the rows back to their tokens' ranks; the weighted combine
    back = torch.cat([expert_out, expert_out.new_zeros((1, d))]).index_select(
        0, at)
    ret = shd.all_to_all(back, group)
    rows = torch.cat([ret, ret.new_zeros((1, d))]).index_select(0, dest)
    contrib = rows * topw.reshape(-1)[:, None].to(rows.dtype)
    tok_at = torch.where(kept, tok, Tg)
    out = xl.new_zeros((Tg + 1, d)).index_add(0, tok_at, contrib)[:Tg]
    out = DTensor.from_local(out, mesh, [Shard(0)] * nd, run_check=False,
                             shape=torch.Size((Tg * G, d)), stride=(d, 1))
    if valid is not None:
        out = out[:T]

    # whole sequences a rank before the (T, d) -> (B, S, d) view: the
    # leading mesh dims that divide the batch keep their split, the rest
    # gather (DTensor cannot view a split that cuts a sequence)
    keep, n = [], 1
    for i in range(nd):
        n *= mesh.size(i)
        if B % n:
            break
        keep.append(i)
    want = [Shard(0) if i in keep else Replicate() for i in range(nd)]
    if list(out.placements) != want:
        out = out.redistribute(mesh, want)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], xt, "swiglu")
    # load-balancing auxiliary loss (Switch-style), a partial sum a rank
    psum = probs.sum(dim=0) if valid is None else (
        probs * valid[:, None]).sum(dim=0)
    ce = every.sum(dim=0).to(torch.float32) * (1.0 / (T * k))
    aux = E * torch.sum((psum / T) * ce)
    aux = DTensor.from_local(aux, mesh, [Partial()] * nd, run_check=False)
    return out.reshape(B, S, d), aux
