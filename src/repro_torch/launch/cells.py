"""Cells: (architecture x input-shape) -> step + shardings.

A *cell* is everything the dry-run needs: the step function, its abstract
arguments (meta tensors: shapes and dtypes, no storage), the spec tree of
their shardings, and analytic MODEL_FLOPS for the roofline's
useful-compute ratio.

The reference lowers ``jax.jit(cell.fn, in_shardings=cell.shardings(mesh))``
over its abstract arguments.  Here ``place(cell.abstract_args,
cell.in_specs, mesh)`` makes DTensors of the arguments (meta DTensors of
the abstract ones, each rank's shard of real ones) and ``cell.fn`` runs
eagerly on them: DTensor propagates the shardings op by op, the models
leave it for explicit local regions where it cannot (the MoE's expert
exchange, the GNNs' message passing), and ``launch/hlo_analysis.py``
counts what one rank runs.  On plain tensors ``cell.fn`` is the
unsharded step.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.registry import get_arch
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import lm as lm_lib
from repro_torch.models.gnn import equiformer as eq_lib
from repro_torch.models.gnn import gat as gat_lib
from repro_torch.models.gnn import gatedgcn as ggcn_lib
from repro_torch.models.gnn import schnet as schnet_lib
from repro_torch.models.gnn.common import (
    NodeShard, cross_entropy_nodes, graph_sum, node_shard,
)
from repro_torch.train.optimizer import init_opt_state
from repro_torch.utils.tree import tree_leaves, tree_unflatten

F32 = torch.float32
I32 = torch.int32  # the LM's token ids (``TokenStream``'s, the reference's)
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


sds = _spec


def map_specs(fn, args, specs):
    """``fn(tensor, spec)`` over the tensors of ``args`` and the specs at
    the same paths of ``specs`` (a spec is a tuple, so the walk follows
    ``args``), the structure of ``args`` kept."""
    if isinstance(args, torch.Tensor):
        return fn(args, specs)
    if isinstance(args, dict):
        return {k: map_specs(fn, args[k], specs[k]) for k in args}
    if isinstance(args, (list, tuple)):
        return type(args)(map_specs(fn, a, s) for a, s in zip(args, specs))
    return args


def _sharded(fn):
    """``fn`` with the plain tensors it makes itself (positions, masks,
    zeros) read as replicated when it meets DTensors: DTensor's
    ``implicit_replication``, a no-op on plain tensors.  On a mesh with
    both 'pod' and 'data', which the LM rules only ever name together, it
    runs on the (pod x data, model) view of the mesh (``_dp_view``): the
    same layout, and DTensor's sharding propagation, which enumerates
    strategies per mesh dim, is several times faster on two dims than on
    three."""

    @functools.wraps(fn)
    def run(*args):
        view = _dp_view(args)
        if view is not None:
            args = map_specs(lambda t, _: _to_view(t, view), args,
                             _nones(args))
        with implicit_replication():
            out = fn(*args)
        # a partial sum (the loss, say) summed: float() of a DTensor reads
        # the rank's local value
        out = map_specs(lambda t, _: _summed(t), out, _nones(out))
        if view is not None:
            out = map_specs(lambda t, _: _from_view(t, view), out,
                            _nones(out))
        return out

    return run


def _dp_view(args):
    """(mesh, its 2-D view) when the DTensors of ``args`` live on a mesh
    with 'pod' and 'data' ahead of 'model' and every one of them places
    'pod' and 'data' alike, on a dim they divide; else None."""
    from torch.distributed.device_mesh import DeviceMesh

    ts = [t for t, _ in _leaves(args) if isinstance(t, DTensor)]
    if not ts:
        return None
    mesh = ts[0].device_mesh
    if tuple(mesh.mesh_dim_names or ()) != ("pod", "data", "model"):
        return None
    n_dp = mesh.size(0) * mesh.size(1)
    for t in ts:
        a, b = t.placements[0], t.placements[1]
        if t.device_mesh is not mesh or a != b or (
                a.is_shard() and t.shape[a.dim] % n_dp):
            return None
    view = getattr(mesh, "_repro_dp_view", None)
    if view is None:  # made once per mesh, kept on it
        view = mesh._repro_dp_view = DeviceMesh(
            mesh.device_type, mesh.mesh.reshape(n_dp, mesh.size(2)),
            mesh_dim_names=("dp", "model"))
    return mesh, view


def _summed(t):
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        return t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return t


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [(tree, None)]


def _to_view(t, view):
    if not isinstance(t, DTensor):
        return t
    return DTensor.from_local(t.to_local(), view[1], t.placements[1:],
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _from_view(t, view):
    if not isinstance(t, DTensor) or t.device_mesh is not view[1]:
        return t
    pl = t.placements
    return DTensor.from_local(t.to_local(), view[0], (pl[0],) + tuple(pl),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


@dataclass
class Cell:
    arch_id: str
    shape_id: str
    family: str
    kind: str  # train | prefill | decode | serve
    fn: object
    abstract_args: tuple
    in_specs: tuple  # spec tree matching abstract_args
    model_flops: float
    meta: dict = field(default_factory=dict)

    def shardings(self, mesh):
        """The DTensor placements of every argument, in its tree."""
        return map_specs(lambda _, s: shd.placements(s, mesh),
                         self.abstract_args, self.in_specs)


def place(tree, specs, mesh):
    """A tree of tensors as DTensors on ``mesh`` by the spec tree
    ``specs`` (the counterpart of ``jax.jit``'s ``in_shardings``).  A
    meta tensor becomes a meta DTensor, with nothing moved; a real tensor
    becomes a copy of this rank's shard of it, which every rank must hold
    whole and equal (no collective): the caller may free the whole
    tensor, and a step that updates the DTensor in place leaves it as it
    was."""

    def one(t, spec):
        pl = shd.placements(spec, mesh)
        if t.device.type != "meta":
            d = distribute_tensor(t, mesh, pl, src_data_rank=None)
            return DTensor.from_local(d.to_local().clone(), mesh, pl,
                                      run_check=False, shape=t.shape,
                                      stride=t.stride())
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset,
        )

        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
            run_check=False, shape=t.shape, stride=t.stride())

    return map_specs(one, tree, specs)


def _nones(tree):
    if isinstance(tree, dict):
        return {k: _nones(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_nones(v) for v in tree)
    return None


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _apply_overrides(cfg, overrides):
    if not overrides:
        return cfg
    return dataclasses.replace(cfg, **overrides)


def _lm_cell(mod, shape_id, mesh, overrides=None) -> Cell:
    from repro_torch.configs.shapes import LM_SHAPES

    cfg = _apply_overrides(mod.full_config(), overrides)
    shp = LM_SHAPES[shape_id]
    B, S = shp["global_batch"], shp["seq_len"]
    kind = shp["kind"]
    params_shape = lm_lib.init_params(cfg, device="meta")
    pspecs = shd.lm_param_specs(params_shape, mesh)
    nparams = sum(leaf.numel() for leaf in tree_leaves(params_shape))
    flops_tok = cfg.model_flops_per_token()  # 6*N_active

    if kind == "train":
        opt_shape = init_opt_state(params_shape)
        ospecs = shd.opt_state_specs(pspecs)
        batch = {
            "tokens": sds((B, S), I32),
            "targets": sds((B, S), I32),
            "mask": sds((B, S), F32),
        }
        bspecs = shd.lm_batch_spec(mesh)
        fn = _sharded(lm_lib.make_train_step(cfg))
        return Cell(mod.ARCH_ID, shape_id, "lm", kind, fn,
                    (params_shape, opt_shape, batch), (pspecs, ospecs, bspecs),
                    model_flops=flops_tok * B * S,
                    meta=dict(n_params=nparams, tokens=B * S))
    if kind == "prefill":
        tokens = sds((B, S), I32)
        fn = _sharded(lm_lib.make_prefill_step(cfg))
        return Cell(mod.ARCH_ID, shape_id, "lm", kind, fn,
                    (params_shape, tokens),
                    (pspecs, shd.P(dp_axes(mesh), None)),
                    model_flops=flops_tok / 3.0 * B * S,  # fwd-only = 2N
                    meta=dict(n_params=nparams, tokens=B * S))
    # decode
    cache_shape = lm_lib.init_cache(cfg, B, S, device="meta")
    cspecs = shd.lm_cache_specs(cache_shape, mesh)
    token = sds((B, 1), I32)
    pos = sds((), I32)
    fn = _sharded(lm_lib.make_decode_step(cfg))
    return Cell(mod.ARCH_ID, shape_id, "lm", kind, fn,
                (params_shape, cache_shape, token, pos),
                (pspecs, cspecs,
                 shd.P(dp_axes(mesh), None) if B > 1 else shd.P(), shd.P()),
                model_flops=flops_tok / 3.0 * B,
                meta=dict(n_params=nparams, tokens=B, cache_len=S))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


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
        e = graph_sum(out[:, 0], graph["batch_seg"].long(), G)
    return torch.mean((e - graph["energy"]) ** 2)


def make_gnn_train_step(model_id: str, cfg, task: str, lr: float = 1e-3):
    """``step(params, graph) -> (new params, loss)``: one plain SGD step,
    ``p - lr * g`` through ``torch.autograd``.  The new parameters are new
    tensors (the reference's functional update): ``params`` is left as it
    was."""

    def step(params, graph):
        if any(isinstance(t, DTensor) for t in graph.values()):
            return _gnn_sharded_step(model_id, cfg, task, lr, params, graph)
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


def _gnn_sharded_step(model_id, cfg, task, lr, params, graph):
    """The SGD step on a graph of DTensors (edges split over every rank,
    node rows split or whole) and replicated parameters, as one plain
    program a rank: the rank takes its edge rows and its chunk of the node
    rows (a slice where they are whole), runs the model under
    ``node_shard`` (the collectives of ``models/gnn/common.py``), so its
    loss is the whole loss and its gradients its edges' and nodes' share,
    sums the gradients over the ranks in one all-reduce and updates."""
    from repro_torch.distributed import sharded as shd

    edges = graph["edges"]
    mesh = edges.device_mesh
    world, rank = mesh.size(), shd.flat_index(mesh)
    n_nodes = graph["nodes"].shape[0]
    if n_nodes % world or edges.shape[0] % world:
        raise ValueError(f"{n_nodes} nodes and {edges.shape[0]} edges must "
                         f"divide over the {world} ranks (pad them)")
    n_local = n_nodes // world
    local = {}
    for k, t in graph.items():
        t = t.to_local() if isinstance(t, DTensor) else t
        if k in ("edges", "edge_feat"):
            if t.shape[0] != edges.shape[0] // world:
                raise ValueError(f"{k} is not split over every rank")
        elif t.shape[0] == n_nodes and k != "energy":
            t = t[rank * n_local:(rank + 1) * n_local]
        local[k] = t
    shard = NodeShard(shd.flat_mesh(mesh), rank, world, n_nodes)
    plain = [p.to_local() if isinstance(p, DTensor) else p
             for p in tree_leaves(params)]
    leaves = [p.detach().requires_grad_(True) for p in plain]
    with node_shard(shard):
        loss = gnn_unified_loss(model_id, tree_unflatten(params, leaves),
                                local, cfg, task)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with torch.no_grad():
        flat = torch.cat([(torch.zeros_like(p) if g is None else g)
                          .reshape(-1).to(torch.float32)
                          for p, g in zip(leaves, grads)])
        flat = shd.all_reduce_sum(flat, shard.group)
        new, at = [], 0
        for p in leaves:
            g = flat[at:at + p.numel()].reshape(p.shape).to(p.dtype)
            at += p.numel()
            new.append(p - lr * g)
    new = [DTensor.from_local(t, mesh, q.placements, run_check=False)
           if isinstance(q, DTensor) else t
           for t, q in zip(new, tree_leaves(params))]
    loss = DTensor.from_local(loss.detach(), mesh,
                              shd.placements_replicated(mesh),
                              run_check=False)
    return tree_unflatten(params, new), loss


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


def _gnn_cell(mod, shape_id, mesh, overrides=None) -> Cell:
    from repro_torch.configs.shapes import GNN_SHAPES

    shp = GNN_SHAPES[shape_id]
    graph = _gnn_graph_spec(shp, pad_to=int(mesh.size()))
    N, E = graph["nodes"].shape[0], graph["edges"].shape[0]
    cfg = mod.full_config(
        d_feat=shp["d_feat"],
        n_classes=(shp["n_classes"] if shp["task"] == "cls" else 1),
        edge_chunks=shp["edge_chunks"],
    )
    ov = dict(overrides or {})
    if not hasattr(cfg, "rotate_restrict"):
        ov.pop("rotate_restrict", None)  # equiformer-only knobs
        ov.pop("edge_dtype", None)
    cfg = _apply_overrides(cfg, ov)
    model_id = mod.MODEL
    params_shape = _GNN_MODELS[model_id].init_params(cfg, device="meta")
    pspecs = shd.replicated(params_shape, mesh)
    gspecs = shd.gnn_graph_specs(graph, mesh, shard_nodes=shp["shard_nodes"])
    fn = make_gnn_train_step(model_id, cfg, shp["task"])
    return Cell(mod.ARCH_ID, shape_id, "gnn", "train", fn,
                (params_shape, graph), (pspecs, gspecs),
                model_flops=_gnn_analytic_flops(model_id, cfg, N, E, shp["d_feat"]),
                meta=dict(n_nodes=N, n_edges=E))


def build_cell(arch_id: str, shape_id: str, mesh, variant: str | None = None) -> Cell:
    mod = get_arch(arch_id)
    overrides = None
    if variant:
        from repro_torch.configs.registry import variant_overrides

        overrides = variant_overrides(variant, mod.FAMILY)
    if mod.FAMILY == "lm":
        return _lm_cell(mod, shape_id, mesh, overrides)
    if mod.FAMILY == "gnn":
        return _gnn_cell(mod, shape_id, mesh, overrides)
    raise KeyError(f"unknown cell family {mod.FAMILY!r}")
