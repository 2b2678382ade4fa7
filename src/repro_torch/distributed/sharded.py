"""Helpers for steps that run on DTensors over a ``DeviceMesh``.

A sharded step (``launch/cells.py``) runs the models' plain code on
DTensors: DTensor propagates each op's sharding and inserts the
collectives.  Where an op has no sharding strategy, or where DTensor's
choice would move far more than the step needs, a model leaves DTensor
for an explicit local region: it takes each rank's local tensors, runs
plain ops on them with the collectives named here (functional
collectives, which autograd differentiates and a dispatch mode sees as
``_c10d_functional`` ops), and wraps the result back as a DTensor.  The
MoE's expert exchange (``models/moe.py``) and the GNNs' message passing
(``models/gnn/common.py``) are such regions.
"""
from __future__ import annotations

import itertools

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate

def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def flat_mesh(mesh):
    """``mesh`` as one dim over all its ranks, row-major (a rank's index
    in it is ``flat_index(mesh)``).  Made once per mesh, kept on it."""
    if mesh.ndim == 1:
        return mesh
    flat = getattr(mesh, "_repro_flat", None)
    if flat is None:
        flat = mesh._repro_flat = mesh._flatten()
    return flat


def flat_index(mesh, coord=None) -> int:
    """The row-major index of ``coord`` (this rank's coordinate when
    None) in ``mesh``."""
    coord = mesh.get_coordinate() if coord is None else coord
    g = 0
    for c, n in zip(coord, tuple(mesh.mesh.shape)):
        g = g * n + int(c)
    return g


def owner_table(mesh, split_dim, device) -> torch.Tensor:
    """(n_chunks, n_split) int64: the flat index of the rank whose
    coordinate on ``split_dim`` is s and whose coordinates on the other
    dims, row-major, are chunk q.  ``split_dim`` None: one column, the
    chunks running over every dim."""
    shape = tuple(mesh.mesh.shape)
    rest = [i for i in range(len(shape)) if i != split_dim]
    n_split = 1 if split_dim is None else shape[split_dim]
    rows = []
    for chunk in itertools.product(*(range(shape[i]) for i in rest)):
        row = []
        for s in range(n_split):
            coord = [0] * len(shape)
            for i, c in zip(rest, chunk):
                coord[i] = c
            if split_dim is not None:
                coord[split_dim] = s
            row.append(flat_index(mesh, coord))
        rows.append(row)
    return torch.as_tensor(rows, dtype=torch.int64, device=device)


def _wait(t):
    return funcol.wait_tensor(t) if hasattr(t, "wait") else t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ``t`` stacked along dim 0 in rank order, no gradient."""
    return _wait(funcol.all_gather_tensor(t.detach(), 0, group))


def all_to_all(t: torch.Tensor, group, grad: bool = True) -> torch.Tensor:
    """Equal chunks of dim 0 exchanged over ``group``; differentiable
    (the backward is the exchange back) when ``grad``."""
    if grad and t.requires_grad:
        out = funcol.all_to_all_single_autograd(t, None, None, group)
    else:
        out = funcol.all_to_all_single(t, None, None, group)
    return _wait(out)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``t``, no gradient."""
    return _wait(funcol.all_reduce(t.detach(), "sum", group))


def placements_replicated(mesh) -> list:
    return [Replicate()] * mesh.ndim


def match_placements(grads: list, params: list) -> list:
    """Each DTensor gradient put on its parameter's placements (a partial
    sum reduce-scattered, as FSDP does) before the optimizer reads it."""
    return [g.redistribute(p.device_mesh, p.placements)
            if isinstance(g, DTensor) and g.placements != p.placements
            else g for g, p in zip(grads, params)]


def replicated_local(t: DTensor, keep: dict | None = None) -> torch.Tensor:
    """``t``'s whole value on every rank (``keep`` maps mesh dims to
    placements to leave as they are), as a local tensor whose gradient is
    each rank's partial sum: the rank uses it on its own share of the
    work."""
    keep = keep or {}
    nd = t.device_mesh.ndim
    want = [keep.get(i, Replicate()) for i in range(nd)]
    grad = [keep.get(i, Partial()) for i in range(nd)]
    if list(t.placements) != want:  # (an identity redistribute's backward
        t = t.redistribute(t.device_mesh, want)  # would all-reduce)
    return t.to_local(grad_placements=grad)


def gather_dp(tree):
    """Every DTensor of ``tree`` gathered whole over the mesh dims other
    than 'model' (FSDP's all-gather before a layer; its backward
    reduce-scatters the gradient), its 'model' sharding kept.  Plain
    tensors pass through."""
    def one(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names or ()
        want = [p if name == "model" else Replicate()
                for p, name in zip(t.placements, names)]
        if list(t.placements) == want:
            return t
        return t.redistribute(t.device_mesh, want)

    from repro_torch.utils.tree import tree_map

    return tree_map(one, tree)


def batch_rows(t):
    """A DTensor with its dim 0 split over every mesh dim (a free local
    slice where it was replicated) when the ranks divide it; as it is
    otherwise.  Plain tensors pass through."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    if t.shape[0] % mesh.size() != 0:
        return t
    from torch.distributed.tensor import Shard

    return t.redistribute(mesh, [Shard(0)] * mesh.ndim)


def replicate(t):
    """A DTensor whole on every rank; plain tensors pass through."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)
