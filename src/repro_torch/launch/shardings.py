"""Sharding rules per model family, and their DTensor placements.

LM: FSDP over the data-parallel axes + tensor/expert parallel over 'model'.
GNN: edge/node row sharding.
Every rule guards divisibility — a dimension is only sharded when the axis
size divides it, so one rule set covers gemma-2b (kv=1) and dsv2 (kv=128)
alike.

A spec is the reference's ``PartitionSpec`` in plain form: a tuple with
one entry per leading tensor dim (missing trailing dims are unsharded),
each entry None, an axis name, or a tuple of axis names (a one-name tuple
is written as the name, as ``PartitionSpec`` normalizes it).
``placements(spec, mesh)`` turns a spec into DTensor placements.
"""
from __future__ import annotations

from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import all_axes, axis_sizes, dp_axes
from repro_torch.utils.tree import tree_map, tree_map_with_path


def _div(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _axes_size(sizes, axes) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _entry(axes):
    """A spec entry for ``axes`` (None, a name, or a tuple of names)."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def P(*entries) -> tuple:
    return tuple(_entry(e) for e in entries)


def _names(path) -> list:
    return [str(k) for k in path]


def lm_param_specs(params_shape, mesh):
    """Path-based spec assignment for the LM family."""
    sizes = axis_sizes(mesh)
    fsdp = dp_axes(mesh)
    fs = _axes_size(sizes, fsdp)
    ms = sizes.get("model", 1)

    def rule(path, leaf):
        keys = _names(path)
        name = keys[-1]
        shp = leaf.shape
        scanned = "layers" in keys

        def m(dim):  # 'model' if divisible
            return "model" if _div(shp[dim], ms) else None

        def f(dim):  # fsdp axes if divisible
            return fsdp if _div(shp[dim], fs) else None

        if name == "embed":
            return P(m(0), f(1))
        if name in ("wq", "wk", "wv"):  # (L,) d, H, hd
            o = 1 if scanned else 0
            return P(*([None] * o), f(o), m(o + 1), None)
        if name == "wo" and len(shp) == (4 if scanned else 3):  # attn out
            o = 1 if scanned else 0
            return P(*([None] * o), m(o), None, f(o + 2))
        if name in ("wuq", "wuk", "wuv"):  # (L,) lora, H, hd
            o = 1 if scanned else 0
            return P(*([None] * o), None, m(o + 1), None)
        if name in ("wdq", "wdkv", "wkr"):  # (L,) d, r
            o = 1 if scanned else 0
            return P(*([None] * o), f(o), None)
        if name in ("wi", "wg") and len(shp) == (4 if scanned else 3):  # MoE (L,)E,d,ff
            o = 1 if scanned else 0
            return P(*([None] * o), m(o), f(o + 1), None)
        if name in ("wi", "wg"):  # dense (L,) d, ff
            o = 1 if scanned else 0
            return P(*([None] * o), f(o), m(o + 1))
        if name == "wo":  # dense (L,) ff, d  OR MoE (L,) E, ff, d
            o = 1 if scanned else 0
            if len(shp) - o == 3:  # MoE
                return P(*([None] * o), m(o), None, f(o + 2))
            return P(*([None] * o), m(o), f(o + 1))
        if name == "router":  # (L,) d, E
            o = 1 if scanned else 0
            return P(*([None] * o), f(o), None)
        return P()  # norms & misc: replicated

    return tree_map_with_path(rule, params_shape)


def lm_batch_spec(mesh):
    return {k: P(dp_axes(mesh), None) for k in ("tokens", "targets", "mask")}


def lm_cache_specs(cache_shape, mesh):
    """KV caches: batch over dp axes when divisible, else seq over axes."""
    sizes = axis_sizes(mesh)
    fsdp = dp_axes(mesh)
    fs = _axes_size(sizes, fsdp)
    ms = sizes.get("model", 1)

    def rule(path, leaf):
        shp = leaf.shape  # (L, B, S, ...rest)
        B, S = shp[1], shp[2]
        rest = len(shp) - 3
        if _div(B, fs) and B >= fs:
            if rest >= 1 and _div(shp[3], ms):  # shard KV heads / latent dim
                return P(None, fsdp, None, "model", *([None] * (rest - 1)))
            if _div(S, ms):
                return P(None, fsdp, "model", *([None] * rest))
            return P(None, fsdp, *([None] * (rest + 1)))
        # tiny batch (long-context): shard the sequence over everything
        ax = all_axes(mesh)
        if _div(S, _axes_size(sizes, ax)):
            return P(None, None, ax, *([None] * rest))
        if _div(S, ms):
            return P(None, None, "model", *([None] * rest))
        return P()

    return tree_map_with_path(rule, cache_shape)


def replicated(tree_shape, mesh):
    return tree_map(lambda _: P(), tree_shape)


def rows_over(axes):
    def rule(leaf_shape):
        return P(axes, *([None] * (len(leaf_shape.shape) - 1)))

    return rule


def gnn_graph_specs(graph_shape, mesh, shard_nodes: bool):
    """Edges always row-sharded; nodes row-sharded on the big graphs."""
    ax = all_axes(mesh)

    def rule(path, leaf):
        name = _names(path)[-1]
        if name in ("edges", "edge_feat"):
            return P(ax, *([None] * (leaf.dim() - 1)))
        if name in ("nodes", "pos", "species", "labels", "train_mask",
                    "batch_seg"):
            if shard_nodes:
                return P(ax, *([None] * (leaf.dim() - 1)))
            return P()
        return P()

    return tree_map_with_path(rule, graph_shape)


def opt_state_specs(param_specs):
    """AdamW mu/nu mirror the parameter shardings; step is replicated."""
    return {
        "mu": param_specs,
        "nu": param_specs,
        "step": P(),
    }


def placements(spec, mesh) -> tuple:
    """A spec as DTensor placements on ``mesh``: a mesh dim that the spec
    names on tensor dim d is ``Shard(d)``, every other mesh dim
    ``Replicate()``.  A tensor dim sharded over several axes splits in the
    order the spec names them, the first the major one (the reference's
    device order), which DTensor's nested shards give when that order is
    the mesh's.  An axis the mesh does not have is one of size 1."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        # an axis the mesh lacks has size 1 (the rules name 'model' on
        # any dim it divides, which size 1 divides)
        dims = [names.index(a) for a in axes if a in names]
        if dims != sorted(dims):
            raise NotImplementedError(
                f"spec {spec}: axes {axes} are not in the mesh's order "
                f"{names}")
        for i in dims:
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec} names mesh axis "
                                 f"{names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)
