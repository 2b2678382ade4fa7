"""GAT [arXiv:1710.10903] — graph attention via SDDMM + edge softmax + SpMM.

Cora config: 2 layers, 8 hidden per head, 8 heads (concat) -> 1 head out.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import carry_tree
from repro_torch.models.gnn.common import (
    cross_entropy_nodes, dense_init, edge_endpoints, generator, seg_softmax,
    seg_sum,
)
from repro_torch.models.layers import normal


@dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    dropout: float = 0.0  # inference/dry-run default
    dtype: str = "float32"


def init_params(cfg: GATConfig, device=None, seed: int = 0):
    """The reference's distributions and scales from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (None: CUDA, which must exist;
    ``"meta"`` allocates nothing)."""
    device = resolve_device(device)
    gen = generator(device, seed)
    dt = getattr(torch, cfg.dtype)
    params = {"layers": []}
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        params["layers"].append({
            "w": dense_init(gen, d_in, heads * d_out, device).to(dt),
            "a_src": normal(gen, (heads, d_out), 0.1, dt, device),
            "a_dst": normal(gen, (heads, d_out), 0.1, dt, device),
        })
        d_in = heads * d_out if not last else d_out
    return params


def params_from_reference(tree, cfg: GATConfig, device=None):
    """The reference's parameter tree (numpy leaves) on ``device`` (None:
    CUDA); paths, shapes and dtypes must be ``cfg``'s."""
    return carry_tree(tree, init_params(cfg, device="meta"),
                      resolve_device(device))


def layer_apply(p, x, edges, num_nodes: int, heads: int, d_out: int,
                concat: bool):
    src, dst, valid = edge_endpoints(edges)
    h = (x @ p["w"]).reshape(-1, heads, d_out)  # (N, H, F)
    e_src = (h * p["a_src"][None]).sum(-1)  # (N, H)
    e_dst = (h * p["a_dst"][None]).sum(-1)
    scores = F.leaky_relu(e_src.index_select(0, src)
                          + e_dst.index_select(0, dst), 0.2)  # (E, H)
    alpha = seg_softmax(scores, dst, num_nodes, valid[:, None])
    msg = h.index_select(0, src) * alpha[..., None]  # (E, H, F)
    out = seg_sum(torch.where(valid[:, None, None], msg, 0.0), dst,
                  num_nodes)
    return out.reshape(-1, heads * d_out) if concat else out.mean(dim=1)


def forward(params, graph, cfg: GATConfig):
    x = graph["nodes"]
    n = x.shape[0]
    for i, p in enumerate(params["layers"]):
        last = i == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        x = layer_apply(p, x, graph["edges"], n, heads, d_out,
                        concat=not last)
        if not last:
            x = F.elu(x)
    return x  # (N, n_classes) logits


def loss_fn(params, graph, cfg: GATConfig):
    logits = forward(params, graph, cfg)
    return cross_entropy_nodes(logits, graph["labels"], graph["train_mask"])
