"""SchNet [arXiv:1706.08566] — continuous-filter convolutions on molecules.

3 interaction blocks, d=64, 300 Gaussian RBFs, 10 Å cutoff.  Energy readout
(sum over atom-wise MLP outputs); trained with MSE on energies.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import carry_tree
from repro_torch.models.gnn.common import (
    dense_init, edge_endpoints, generator, seg_sum,
)
from repro_torch.models.layers import normal


@dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 100
    n_out: int = 1  # 1 = energy regression; >1 = per-node classification
    dtype: str = "float32"


def init_params(cfg: SchNetConfig, device=None, seed: int = 0):
    """The reference's distributions and scales from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (None: CUDA, which must exist;
    ``"meta"`` allocates nothing)."""
    device = resolve_device(device)
    gen = generator(device, seed)
    d, r = cfg.d_hidden, cfg.n_rbf
    blocks = [{
        "filter1": dense_init(gen, r, d, device),
        "filter2": dense_init(gen, d, d, device),
        "in2f": dense_init(gen, d, d, device),
        "f2out": dense_init(gen, d, d, device),
    } for _ in range(cfg.n_interactions)]
    return {
        "embed": normal(gen, (cfg.n_species, d), 0.3, torch.float32, device),
        "out1": dense_init(gen, d, d // 2, device),
        "out2": dense_init(gen, d // 2, cfg.n_out, device),
        "blocks": blocks,
    }


def params_from_reference(tree, cfg: SchNetConfig, device=None):
    """The reference's parameter tree (numpy leaves) on ``device`` (None:
    CUDA); paths, shapes and dtypes must be ``cfg``'s."""
    return carry_tree(tree, init_params(cfg, device="meta"),
                      resolve_device(device))


def _shifted_softplus(x):
    # above softplus's threshold of 20 it returns x, where the reference
    # computes logaddexp(x, 0): they differ by under 1e-8 there
    return F.softplus(x) - np.log(2.0)


def rbf_expand(dist, cfg: SchNetConfig):
    centers = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, device=dist.device)
    gamma = 10.0 / cfg.cutoff
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def forward(params, graph, cfg: SchNetConfig):
    """graph: species int[N], pos f32[N,3], edges int[E,2], batch_seg."""
    src, dst, valid = edge_endpoints(graph["edges"])
    pos = graph["pos"]
    n = pos.shape[0]
    h = params["embed"].index_select(0, graph["species"].long())

    d_ij = torch.linalg.vector_norm(
        pos.index_select(0, src) - pos.index_select(0, dst) + 1e-12, dim=-1)
    rbf = rbf_expand(d_ij, cfg)
    # smooth cutoff envelope
    env = 0.5 * (torch.cos(np.pi * torch.clamp(d_ij / cfg.cutoff, 0, 1))
                 + 1.0)
    env = torch.where(valid, env, 0.0)

    for blk in params["blocks"]:
        W = _shifted_softplus(rbf @ blk["filter1"]) @ blk["filter2"]  # (E, d)
        W = W * env[:, None]
        m = (h @ blk["in2f"]).index_select(0, src) * W
        agg = seg_sum(m, dst, n)
        h = h + _shifted_softplus(agg @ blk["f2out"])

    atom_out = _shifted_softplus(h @ params["out1"]) @ params["out2"]
    if cfg.n_out > 1:
        return atom_out  # per-node logits (classification shapes)
    seg = graph.get("batch_seg")
    if seg is None:
        return atom_out.sum()
    return seg_sum(atom_out[:, 0], seg.long(), graph["energy"].shape[0])


def loss_fn(params, graph, cfg: SchNetConfig):
    pred = forward(params, graph, cfg)
    return torch.mean((pred - graph["energy"]) ** 2)
