"""Shared GNN machinery: edge-index message passing via segment ops.

Message passing gathers source features by edge index (``index_select``,
whose backward is an ``index_add``), transforms them and sums
(``index_add``) or maxes (``scatter_reduce``) them into their
destinations.  All ops take ``num_nodes`` statically, as the reference's
do.

Graphs are plain dicts of tensors (``data.graphs.graph_to_device`` makes
them from the generators' numpy dicts):
  nodes: f32[N, F]   edges: int64[E, 2] (src, dst)   plus optional fields
  (edge_feat, pos, labels, train_mask; -1-padded edges allowed).

On the card ``index_add`` sums with atomics, so a sum's order differs from
run to run and from the CPU's: compare card and CPU by float tolerances.

Sharded (``node_shard``, which ``launch/cells.make_gnn_train_step`` enters
when the graph holds DTensors) a model runs as plain code on each rank's
share: its edge rows and its own chunk of the node rows, the edge ids
global.  Four helpers then carry the collectives, each one a rank: a
gather of node rows by edge (``node_rows``: the node table all-gathered
once, then ``index_select``), a segment sum into the nodes (``seg_sum``:
the rank's edges summed locally into every node, one reduce-scatter back
to the node rows), a segment max (one reduce-scatter of the maxima), and
a sum over the nodes into graphs or the loss (``graph_sum``,
``cross_entropy_nodes``: one all-reduce of the partial sums).
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F

from repro_torch.distributed.checkpoint import to_numpy
from repro_torch.models.layers import normal
from repro_torch.utils.tree import tree_map


@dataclass(frozen=True)
class NodeShard:
    """A rank's share of a sharded graph: ``group`` (a 1-D mesh over the
    ranks) splits the ``n_nodes`` node rows into equal chunks, this rank
    holding chunk ``rank``."""

    group: object
    rank: int
    world: int
    n_nodes: int

    @property
    def n_local(self) -> int:
        return self.n_nodes // self.world


_SHARD: contextvars.ContextVar = contextvars.ContextVar("node_shard",
                                                        default=None)


@contextlib.contextmanager
def node_shard(shard: NodeShard):
    """Run the models' message passing on ``shard``'s rows."""
    token = _SHARD.set(shard)
    try:
        yield shard
    finally:
        _SHARD.reset(token)


def current_shard() -> NodeShard | None:
    return _SHARD.get()


def _wait(t):
    return funcol.wait_tensor(t) if hasattr(t, "wait") else t


class _SumReplicated(torch.autograd.Function):
    """The group's sum of each rank's partial, whole on every rank.  Its
    backward passes the gradient through: what follows runs alike on
    every rank, so each rank's partial gets the whole gradient."""

    @staticmethod
    def forward(ctx, t, group):
        return _wait(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_ranks(t):
    """``t`` summed over the ranks of the current shard (as it is when
    there is none)."""
    sh = current_shard()
    return t if sh is None else _SumReplicated.apply(t, sh.group)


def node_rows(h):
    """The node table that edge ids index: ``h`` itself, or sharded the
    ranks' rows all-gathered (its backward reduce-scatters)."""
    sh = current_shard()
    if sh is None:
        return h
    if h.requires_grad:
        return _wait(funcol.all_gather_tensor_autograd(h, 0, sh.group))
    return _wait(funcol.all_gather_tensor(h, 0, sh.group))


def seg_sum(data, segment_ids, num_segments: int):
    """Sum ``data`` rows into ``num_segments`` node rows.  Sharded, the
    ids are global, ``num_segments`` the rank's rows, and the result the
    rank's rows of the sum over every rank's data."""
    sh = current_shard()
    if sh is not None:
        if num_segments != sh.n_local:
            raise ValueError(f"a sharded seg_sum sums into the rank's "
                             f"{sh.n_local} node rows, not {num_segments}")
        num_segments = sh.n_nodes
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    out = out.index_add(0, segment_ids, data)
    if sh is None:
        return out
    if out.requires_grad:
        return _wait(funcol.reduce_scatter_tensor_autograd(out, "sum", 0,
                                                           sh.group))
    return _wait(funcol.reduce_scatter_tensor(out, "sum", 0, sh.group))


def graph_sum(data, segment_ids, num_segments: int):
    """Sum node rows into ``num_segments`` graphs (whole on every rank
    when sharded)."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return sum_over_ranks(out.index_add(0, segment_ids, data))


def seg_max(data, segment_ids, num_segments: int):
    """Per-segment max; a segment that receives nothing is ``-inf`` (the
    reference's ``segment_max``).  Sharded as ``seg_sum``; no gradient
    flows through the sharded one."""
    sh = current_shard()
    if sh is not None:
        num_segments = sh.n_nodes
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    idx = segment_ids.reshape((-1,) + (1,) * (data.dim() - 1))
    out = out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                             include_self=True)
    if sh is None:
        return out
    return _wait(funcol.reduce_scatter_tensor(out.detach(), "max", 0,
                                              sh.group))


def seg_softmax(scores, segment_ids, num_segments: int, valid=None):
    """Numerically-stable softmax over edges grouped by destination.

    The shift by each segment's max carries no gradient (the softmax does
    not depend on it), so it is taken outside autograd."""
    if valid is not None:
        scores = torch.where(valid, scores, -1e30)
    with torch.no_grad():
        mx = seg_max(scores, segment_ids, num_segments)
        mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(scores - node_rows(mx).index_select(0, segment_ids))
    if valid is not None:
        ex = torch.where(valid, ex, 0.0)
    den = seg_sum(ex, segment_ids, num_segments)
    return ex / torch.clamp(node_rows(den).index_select(0, segment_ids),
                            min=1e-16)


def edge_endpoints(edges):
    """(src, dst, valid) with -1 padding mapped to node 0 + invalid mask.
    Indices come back int64 (a no-op on ``graph_to_device``'s edges)."""
    edges = edges.long()
    src, dst = edges[:, 0], edges[:, 1]
    valid = (src >= 0) & (dst >= 0)
    return torch.clamp(src, min=0), torch.clamp(dst, min=0), valid


def degree(edges, num_nodes: int):
    src, dst, valid = edge_endpoints(edges)
    return seg_sum(valid.float(), dst, num_nodes)


def dense_init(gen, d_in, d_out, device, scale=None):
    """``N(0, 1) / sqrt(d_in)`` (or ``* scale``), float32."""
    s = scale if scale is not None else 1.0 / np.sqrt(d_in)
    return normal(gen, (d_in, d_out), s, torch.float32, device)


def cross_entropy_nodes(logits, labels, mask):
    logp = F.log_softmax(logits.float(), dim=-1)
    gold = logp.gather(-1, labels.long()[:, None])[:, 0]
    m = mask.float()
    return (-sum_over_ranks((gold * m).sum())
            / torch.clamp(sum_over_ranks(m.sum()), min=1.0))


def generator(device, seed: int):
    """The ``torch.Generator`` an ``init_params`` draws from (None on the
    meta device, where nothing is drawn)."""
    if device.type == "meta":
        return None
    return torch.Generator(device).manual_seed(seed)


# ---------------------------------------------------------------------------
# Weights carried back to the reference (each model's
# ``params_from_reference`` carries them across, on its own paths)
# ---------------------------------------------------------------------------


def params_to_reference(tree):
    """The port's parameter tree as numpy leaves on the host, in the same
    structure: the reference's layout (exact both ways)."""
    return tree_map(to_numpy, tree)
