"""The GNN half of the cell builder: the graph inputs' static shapes, the
unified loss, the SGD train step and the analytic MODEL_FLOPS of a
(GNN architecture x input shape) cell.

``Cell``, ``build_cell`` and the shardings (the dry-run's lowering over a
mesh) are not ported here.
"""
from __future__ import annotations

import torch

from repro_torch.models.gnn import equiformer as eq_lib
from repro_torch.models.gnn import gat as gat_lib
from repro_torch.models.gnn import gatedgcn as ggcn_lib
from repro_torch.models.gnn import schnet as schnet_lib
from repro_torch.models.gnn.common import cross_entropy_nodes, seg_sum
from repro_torch.utils.tree import tree_leaves, tree_unflatten

F32 = torch.float32
INDEX = torch.int64  # ``graph_to_device``'s index dtype (the reference: int32)

_GNN_MODELS = {
    "gat": gat_lib, "gatedgcn": ggcn_lib, "schnet": schnet_lib,
    "equiformer": eq_lib,
}


def _pad_up(n: int, m: int) -> int:
    """Row counts of explicitly sharded arrays must divide the mesh size —
    the data pipeline pads with invalid rows (-1 edges / masked nodes), so
    the launcher rounds the static shapes up.  Logical sizes stay in meta."""
    return -(-n // m) * m


def _spec(shape, dtype) -> torch.Tensor:
    """A shape and dtype with no storage (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _gnn_graph_spec(shp: dict, pad_to: int = 1) -> dict:
    """The graph a cell's step takes, as meta tensors."""
    if "batch" in shp:  # molecule: batched small graphs
        G = shp["batch"]
        N = G * shp["n_nodes"]
        E = G * shp["n_edges"]
    elif "batch_nodes" in shp:  # sampled block
        from repro_torch.data.graphs import block_shape_for

        N, E = block_shape_for(shp["batch_nodes"], shp["fanouts"])
        G = 0
    else:
        N, E = shp["n_nodes"], shp["n_edges"]
        G = 0
    N = _pad_up(N, pad_to)
    E = _pad_up(E, pad_to)
    g = {
        "nodes": _spec((N, shp["d_feat"]), F32),
        "edges": _spec((E, 2), INDEX),
        "pos": _spec((N, 3), F32),
        "species": _spec((N,), INDEX),
    }
    if shp["task"] == "cls":
        g["labels"] = _spec((N,), INDEX)
        g["train_mask"] = _spec((N,), F32)
    else:
        g["energy"] = _spec((max(G, 1),), F32)
        g["batch_seg"] = _spec((N,), INDEX)
    return g


def gnn_unified_loss(model_id: str, params, graph, cfg, task: str):
    mod = _GNN_MODELS[model_id]
    if task == "cls":
        logits = mod.forward(params, graph, cfg)
        return cross_entropy_nodes(logits, graph["labels"], graph["train_mask"])
    # regression: per-graph energy = sum of node outputs
    out = mod.forward(params, graph, cfg)
    G = graph["energy"].shape[0]
    if out.dim() == 1:  # schnet already returns per-graph energies
        e = out
    else:
        e = seg_sum(out[:, 0], graph["batch_seg"].long(), G)
    return torch.mean((e - graph["energy"]) ** 2)


def make_gnn_train_step(model_id: str, cfg, task: str, lr: float = 1e-3):
    """``step(params, graph) -> (new params, loss)``: one plain SGD step,
    ``p - lr * g`` through ``torch.autograd``.  The new parameters are new
    tensors (the reference's functional update): ``params`` is left as it
    was."""

    def step(params, graph):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss = gnn_unified_loss(model_id, tree_unflatten(params, leaves),
                                graph, cfg, task)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            new = [p.detach().clone() if g is None else p - lr * g.to(p.dtype)
                   for p, g in zip(leaves, grads)]
        return tree_unflatten(params, new), loss.detach()

    return step


def _gnn_analytic_flops(model_id, cfg, N, E, d_feat):
    """Coarse useful-FLOPs estimate (matmul terms only, x3 for fwd+bwd)."""
    if model_id == "gat":
        per = 2 * N * d_feat * cfg.n_heads * cfg.d_hidden + 6 * E * cfg.n_heads * cfg.d_hidden
        f = per * cfg.n_layers
    elif model_id == "gatedgcn":
        d = cfg.d_hidden
        f = cfg.n_layers * (5 * 2 * N * d * d + 4 * E * d) + 2 * N * d_feat * d
    elif model_id == "schnet":
        d, r = cfg.d_hidden, cfg.n_rbf
        f = cfg.n_interactions * (2 * E * (r * d + d * d) + 4 * N * d * d)
    else:  # equiformer: SO(2) conv + 2 constant-J rotations per edge
        C = cfg.channels
        coeff = (cfg.l_max + 1) ** 2
        so2 = sum(
            2 * (2 * n_l * C) * (n_l * C)
            for n_l in [cfg.l_max + 1] + [cfg.l_max + 1 - m for m in range(1, cfg.m_max + 1)]
        )
        rot = 4 * 2 * coeff * coeff * C
        f = cfg.n_layers * E * (so2 + rot)
    return 3.0 * f  # fwd+bwd
