"""AdamW + global-norm clipping over a tree of tensors.

The reference's expressions in its order: linear warmup, the global-norm
clip, float32 moments, the update computed in float32 and cast back to
the parameter's dtype (no master weights).  ``torch.optim.AdamW`` orders
these differently.  Parameters and moments are updated in place, one
leaf at a time, so no second copy of the state is ever held.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params):
    def zeros(p):  # a DTensor parameter's moments are DTensors like it
        return torch.zeros_like(p, dtype=torch.float32)

    device = tree_leaves(params)[0].device
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig):
    """One step; returns ``(params, opt_state, grad_norm)``: the same
    parameter and moment tensors, updated in place, and a new step."""
    step = opt_state["step"] + 1
    lr = cfg.lr * torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)

    gnorm = global_norm(grads)
    scale = torch.clamp(
        torch.full_like(gnorm, cfg.clip_norm) / torch.clamp(gnorm, min=1e-9),
        max=1.0)

    b1t = 1.0 - torch.pow(cfg.b1, step.float())
    b2t = 1.0 - torch.pow(cfg.b2, step.float())
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["mu"]),
                          tree_leaves(opt_state["nu"])):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mhat = m / b1t
        vhat = v / b2t
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                    "step": step}, gnorm
