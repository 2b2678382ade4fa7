"""GatedGCN [arXiv:1711.07553 / benchmarking-gnns arXiv:2003.00982].

16 layers, d=70, explicit edge features with gated aggregation:

    e'_ij = A h_i + B h_j + C e_ij
    h'_i  = U h_i + sum_j sigma(e'_ij) / (sum_j sigma(e'_ij) + eps) ⊙ V h_j

LayerNorm replaces the paper's BatchNorm + residuals, as in the
benchmarking-gnns reference code.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import carry_tree
from repro_torch.models.gnn.common import (
    cross_entropy_nodes, dense_init, edge_endpoints, generator, node_rows,
    seg_sum,
)


@dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70
    d_in: int = 1433
    d_edge_in: int = 1
    n_classes: int = 7
    dtype: str = "float32"


def init_params(cfg: GatedGCNConfig, device=None, seed: int = 0):
    """The reference's distributions and scales from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (None: CUDA, which must exist;
    ``"meta"`` allocates nothing)."""
    device = resolve_device(device)
    gen = generator(device, seed)
    d = cfg.d_hidden
    layers = [{k: dense_init(gen, d, d, device) for k in "ABCUV"}
              for _ in range(cfg.n_layers)]
    return {
        "embed_h": dense_init(gen, cfg.d_in, d, device),
        "embed_e": dense_init(gen, cfg.d_edge_in, d, device),
        "head": dense_init(gen, d, cfg.n_classes, device),
        "layers": layers,
    }


def params_from_reference(tree, cfg: GatedGCNConfig, device=None):
    """The reference's parameter tree (numpy leaves) on ``device`` (None:
    CUDA); paths, shapes and dtypes must be ``cfg``'s."""
    return carry_tree(tree, init_params(cfg, device="meta"),
                      resolve_device(device))


def _ln(x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def forward(params, graph, cfg: GatedGCNConfig):
    src, dst, valid = edge_endpoints(graph["edges"])
    n = graph["nodes"].shape[0]
    h = graph["nodes"] @ params["embed_h"]
    e = graph.get("edge_feat")
    if e is None:
        e = h.new_ones((graph["edges"].shape[0], cfg.d_edge_in))
    e = e @ params["embed_e"]

    for p in params["layers"]:
        hf = node_rows(h)
        h_src, h_dst = hf.index_select(0, src), hf.index_select(0, dst)
        e_new = h_src @ p["A"] + h_dst @ p["B"] + e @ p["C"]
        gate = torch.sigmoid(e_new)
        gate = torch.where(valid[:, None], gate, 0.0)
        msg = gate * (h_src @ p["V"])
        num = seg_sum(msg, dst, n)
        den = seg_sum(gate, dst, n)
        h_new = h @ p["U"] + num / (den + 1e-6)
        h = h + torch.relu(_ln(h_new))  # residual
        e = e + torch.relu(_ln(e_new))
    return h @ params["head"]


def loss_fn(params, graph, cfg: GatedGCNConfig):
    logits = forward(params, graph, cfg)
    return cross_entropy_nodes(logits, graph["labels"], graph["train_mask"])
