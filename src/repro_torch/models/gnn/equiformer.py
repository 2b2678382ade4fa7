"""EquiformerV2-style equivariant graph attention via eSCN [arXiv:2306.12059].

Node features are real-SH irrep tensors x: (N, (l_max+1)^2, C) with l_max=6.
Per edge, the eSCN trick [arXiv:2302.03655]: rotate both endpoint features
into the edge-aligned frame (so3.py — constant-J factorization, no per-edge
Wigner matrices), where the SO(3) tensor product collapses to a *block-
diagonal SO(2) linear map over |m| <= m_max* (m_max=2), i.e. the O(L^6)
Clebsch-Gordan contraction becomes O(L^3) dense matmuls.
Messages are attention-weighted (invariant logits from the m=0 block),
rotated back, and scatter-summed.

Memory discipline: edge tensors ((E, 49, C)) are processed in
``edge_chunks`` slices, a Python loop over the chunks in the reference's
order (its ``lax.scan``).  Autograd keeps what each chunk's backward
needs, as the reference's scan keeps its residuals: at full width on the
molecule shape (8,192 edges) a training step peaks at ~16 GiB on the
card, so no layer is recomputed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import carry_tree
from repro_torch.models.gnn import so3
from repro_torch.models.gnn.common import (
    cross_entropy_nodes, dense_init, edge_endpoints, generator, graph_sum,
    node_rows, seg_sum,
)
from repro_torch.models.layers import normal


@dataclass(frozen=True)
class EquiformerConfig:
    name: str = "equiformer-v2"
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_species: int = 100
    edge_chunks: int = 1
    n_out: int = 1  # 1 = energy regression; >1 = node classification
    dtype: str = "float32"
    # perf knobs: compute only the |m| <= m_max rows of the edge-frame
    # rotation (exact — the SO(2) conv never reads the rest), and stream
    # edge tensors in bf16.
    rotate_restrict: bool = False
    edge_dtype: str = "float32"

    @property
    def n_coeff(self) -> int:
        return (self.l_max + 1) ** 2


def _m_groups(l_max: int, m_max: int):
    """Coefficient indices per |m| group: m=0 -> list, m>0 -> (pos, neg)."""
    groups = {}
    off = 0
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            idx = off + m + l
            key = abs(m)
            if key <= m_max:
                sign = "0" if m == 0 else ("+" if m > 0 else "-")
                groups.setdefault(key, {}).setdefault(sign, []).append(idx)
        off += 2 * l + 1
    return groups


def init_params(cfg: EquiformerConfig, device=None, seed: int = 0):
    """The reference's distributions and scales from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (None: CUDA, which must exist;
    ``"meta"`` allocates nothing)."""
    device = resolve_device(device)
    gen = generator(device, seed)
    C = cfg.channels
    groups = _m_groups(cfg.l_max, cfg.m_max)
    layers = []
    for _ in range(cfg.n_layers):
        p = {"so2": {}}
        for m, g in groups.items():
            dim = len(g["0" if m == 0 else "+"]) * C
            if m == 0:
                p["so2"]["m0"] = dense_init(gen, 2 * dim, dim, device)
            else:
                p["so2"][f"m{m}r"] = dense_init(gen, 2 * dim, dim, device)
                p["so2"][f"m{m}i"] = dense_init(gen, 2 * dim, dim, device)
        n_l0 = len(groups[0]["0"])
        p["attn_w"] = dense_init(gen, 2 * n_l0 * C, C, device)
        p["attn_a"] = dense_init(gen, C, cfg.n_heads, device)
        # equivariant FFN: per-l channel mixing (shared across m) + gate
        p["ffn_w"] = normal(gen, (cfg.l_max + 1, C, C), 1.0 / np.sqrt(C),
                            torch.float32, device)
        p["gate_w"] = dense_init(gen, C, (cfg.l_max + 1) * C, device)
        layers.append(p)
    return {
        "embed": normal(gen, (cfg.n_species, C), 0.3, torch.float32, device),
        "head": dense_init(gen, C, cfg.n_out, device),
        "layers": layers,
    }


def params_from_reference(tree, cfg: EquiformerConfig, device=None):
    """The reference's parameter tree (numpy leaves) on ``device`` (None:
    CUDA); paths, shapes and dtypes must be ``cfg``'s."""
    return carry_tree(tree, init_params(cfg, device="meta"),
                      resolve_device(device))


def _equiv_norm(x, l_max: int, eps=1e-5):
    """Per-l RMS norm over (m, channel) — rotation invariant."""
    outs = []
    off = 0
    for l in range(l_max + 1):
        k = 2 * l + 1
        blk = x[:, off:off + k, :]
        rms = torch.sqrt(blk.square().mean(dim=(1, 2), keepdim=True) + eps)
        outs.append(blk / rms)
        off += k
    return torch.cat(outs, dim=1)


def _conv_plan(groups, n_rows: int, device) -> dict:
    """The SO(2) conv's row indices as tensors on ``device``, made once per
    forward: each group's rows, and the permutation that puts the groups'
    outputs (then zero rows for the coefficients no group writes) back in
    row order."""
    idx = {m: {s: torch.as_tensor(lst, dtype=torch.int64, device=device)
               for s, lst in g.items()} for m, g in groups.items()}
    written = [i for m in sorted(groups)
               for s in (("0",) if m == 0 else ("+", "-"))
               for i in groups[m][s]]
    zero_rows = [i for i in range(n_rows) if i not in set(written)]
    order = np.argsort(np.asarray(written + zero_rows))
    return {"idx": idx, "n_zero": len(zero_rows),
            "order": torch.as_tensor(order, dtype=torch.int64,
                                     device=device)}


def _pair_rows(z_src, z_dst, rows):
    """The coefficient rows ``rows`` of both endpoints, src's then dst's."""
    return torch.cat([z_src.index_select(1, rows),
                      z_dst.index_select(1, rows)], dim=1)


def _so2_conv(p, z_src, z_dst, groups, C: int, plan: dict):
    """SO(2)-restricted linear map in the edge frame (the eSCN core).

    The reference writes each group's rows into a zero tensor; here the
    groups' outputs and a zero block are concatenated and put in row order
    by one gather, so the coefficients with |m| > m_max stay exactly zero
    (the eSCN truncation)."""
    E = z_src.shape[0]
    idx = plan["idx"]
    parts = []
    for m in sorted(groups):
        if m == 0:
            i0 = idx[0]["0"]
            xin = _pair_rows(z_src, z_dst, i0).reshape(E, -1)
            y = xin @ p["so2"]["m0"].to(xin.dtype)
            parts.append(y.reshape(E, len(groups[0]["0"]), C))
        else:
            ip, im = idx[m]["+"], idx[m]["-"]
            xp = _pair_rows(z_src, z_dst, ip).reshape(E, -1)
            xm = _pair_rows(z_src, z_dst, im).reshape(E, -1)
            Wr = p["so2"][f"m{m}r"].to(xp.dtype)
            Wi = p["so2"][f"m{m}i"].to(xp.dtype)
            yp = xp @ Wr - xm @ Wi
            ym = xm @ Wr + xp @ Wi
            parts.append(yp.reshape(E, len(groups[m]["+"]), C))
            parts.append(ym.reshape(E, len(groups[m]["-"]), C))
    if plan["n_zero"]:
        parts.append(z_src.new_zeros((E, plan["n_zero"], C)))
    return torch.cat(parts, dim=1).index_select(1, plan["order"])


def _sel_layout(groups, n_coeff):
    """Row subset with |m| <= m_max + groups remapped into that layout."""
    sel = sorted({i for g in groups.values() for lst in g.values() for i in lst})
    pos = {orig: k for k, orig in enumerate(sel)}
    rgroups = {
        m: {s: [pos[i] for i in lst] for s, lst in g.items()}
        for m, g in groups.items()
    }
    return sel, rgroups


def _edge_pass(p, xn, pos, ech, cfg: EquiformerConfig, rot: dict, n: int):
    """One chunk of edges: rotate both endpoints into the edge frame, the
    SO(2) conv, the soft-capped attention weights, the message rotated
    back; returns its sums into the ``n`` destinations (agg, wsum).
    ``xn`` and ``pos`` are the whole node tables (``node_rows``)."""
    C, L, H = cfg.channels, cfg.l_max, cfg.n_heads
    groups = rot["groups"]
    src, dst, valid = edge_endpoints(ech)
    vec = pos.index_select(0, dst) - pos.index_select(0, src)
    # zero-length edges (self-loops) have no well-defined frame and would
    # silently break equivariance — mask them out.
    valid = valid & ((vec * vec).sum(-1) > 1e-12)
    alpha_e, beta_e = so3.euler_from_edges(vec)
    Jb = rot["Jb"]
    if cfg.rotate_restrict:
        # exact: the SO(2) conv only reads |m| <= m_max rows, so the final
        # J product emits just those rows (49 -> n_rows) and the
        # back-rotation starts from them.
        Jb_sel = rot["Jb_sel"]

        def to_frame(xg):
            x1 = so3.z_rotate(xg, -alpha_e, L)
            x1 = Jb @ x1
            x1 = so3.z_rotate(x1, -beta_e, L)
            return Jb_sel @ x1

        def from_frame(msg_sel):
            x1 = Jb_sel.T @ msg_sel
            x1 = so3.z_rotate(x1, beta_e, L)
            x1 = Jb.T @ x1
            return so3.z_rotate(x1, alpha_e, L)
    else:
        def to_frame(xg):
            return so3.rotate_to_frame(xg, alpha_e, beta_e, L, Jb)

        def from_frame(m_):
            return so3.rotate_from_frame(m_, alpha_e, beta_e, L, Jb)

    z_src = to_frame(xn.index_select(0, src))
    z_dst = to_frame(xn.index_select(0, dst))
    msg_f = _so2_conv(p, z_src, z_dst, groups, C, rot["plan"])
    # invariant attention logits from the m=0 block
    idx0 = rot["plan"]["idx"][0]["0"]
    inv = _pair_rows(z_src, z_dst, idx0).reshape(z_src.shape[0], -1).float()
    logits = F.silu(inv @ p["attn_w"]) @ p["attn_a"]  # (Ec, H)
    # soft-cap: the chunked softmax accumulates exp-weights across chunks,
    # so logits must be bounded instead of max-subtracted.
    logits = 20.0 * torch.tanh(logits / 20.0)
    logits = torch.where(valid[:, None], logits, -1e30)
    msg = from_frame(msg_f).float()
    msg = torch.where(valid[:, None, None], msg, 0.0)
    # unnormalized attention (exp-logit weights, head-split); exp(-inf)
    # is 0 with a zero gradient
    w = torch.exp(torch.where(logits > -1e29, logits - 20.0,
                              float("-inf")))
    Ec = msg.shape[0]
    wm = msg.reshape(Ec, cfg.n_coeff, H, C // H) * w[:, None, :, None]
    agg = seg_sum(wm.reshape(Ec, cfg.n_coeff, C), dst, n)
    # each head's weight over its C // H consecutive channels
    # (``jnp.repeat``; ``Tensor.repeat`` would tile instead)
    wsum = seg_sum(w.repeat_interleave(C // H, dim=-1), dst, n)
    return agg, wsum


def forward(params, graph, cfg: EquiformerConfig):
    """graph: species int[N], pos f32[N,3], edges int[E,2] -> (N, n_out)."""
    C = cfg.channels
    L = cfg.l_max
    pos = graph["pos"]
    n = pos.shape[0]
    dev = pos.device
    groups = _m_groups(L, cfg.m_max)
    edt = getattr(torch, cfg.edge_dtype)
    rot = {"Jb": so3.J_tensor(L, edt, dev)}
    if cfg.rotate_restrict:
        sel_rows, rot["groups"] = _sel_layout(groups, cfg.n_coeff)
        rot["Jb_sel"] = rot["Jb"][torch.as_tensor(sel_rows, device=dev), :]
        n_rows = len(sel_rows)
    else:
        rot["groups"] = groups
        n_rows = cfg.n_coeff
    rot["plan"] = _conv_plan(rot["groups"], n_rows, dev)

    emb = params["embed"].index_select(0, graph["species"].long())
    x = torch.cat([emb[:, None, :], emb.new_zeros((n, cfg.n_coeff - 1, C))],
                  dim=1)

    edges = graph["edges"].long()
    E = edges.shape[0]
    chunks = max(1, cfg.edge_chunks)
    pad = (-E) % chunks
    if pad:
        edges = torch.cat([edges, edges.new_full((pad, 2), -1)])
    edges_c = edges.reshape(chunks, -1, 2)

    pos_all = node_rows(pos)
    for p in params["layers"]:
        # cast BEFORE the edge gathers: the (Ec, 49, C) gather outputs are
        # the edge pass's largest tensors
        xn = node_rows(_equiv_norm(x, L).to(edt))
        agg = x.new_zeros((n, cfg.n_coeff, C))
        wsum = x.new_zeros((n, C))
        for ech in edges_c:
            a, w = _edge_pass(p, xn, pos_all, ech, cfg, rot, n)
            agg = agg + a
            wsum = wsum + w
        attn_out = agg / torch.clamp(wsum[:, None, :], min=1e-9)
        x = x + attn_out

        # equivariant FFN: scalar-gated per-l channel mixing
        xn2 = _equiv_norm(x, L)
        gates = F.silu(xn2[:, 0, :] @ p["gate_w"]).reshape(n, L + 1, C)
        outs = []
        off = 0
        for l in range(L + 1):
            k = 2 * l + 1
            blk = xn2[:, off:off + k, :] @ p["ffn_w"][l]
            outs.append(blk * gates[:, l:l + 1, :])
            off += k
        x = x + torch.cat(outs, dim=1)

    inv_out = _equiv_norm(x, L)[:, 0, :]  # invariant readout
    return inv_out @ params["head"]


def loss_fn(params, graph, cfg: EquiformerConfig):
    out = forward(params, graph, cfg)
    if cfg.n_out == 1:
        seg = graph.get("batch_seg")
        if seg is not None:
            e = graph_sum(out[:, 0], seg.long(), graph["energy"].shape[0])
            return torch.mean((e - graph["energy"]) ** 2)
        return torch.mean((out.sum() - graph["energy"]) ** 2)
    return cross_entropy_nodes(out, graph["labels"], graph["train_mask"])
