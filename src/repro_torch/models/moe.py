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
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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
