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
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.checkpoint import to_numpy
from repro_torch.models.layers import normal
from repro_torch.utils.tree import tree_map


def seg_sum(data, segment_ids, num_segments: int):
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def seg_max(data, segment_ids, num_segments: int):
    """Per-segment max; a segment that receives nothing is ``-inf`` (the
    reference's ``segment_max``)."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    idx = segment_ids.reshape((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                              include_self=True)


def seg_softmax(scores, segment_ids, num_segments: int, valid=None):
    """Numerically-stable softmax over edges grouped by destination.

    The shift by each segment's max carries no gradient (the softmax does
    not depend on it), so it is taken outside autograd."""
    if valid is not None:
        scores = torch.where(valid, scores, -1e30)
    with torch.no_grad():
        mx = seg_max(scores, segment_ids, num_segments)
        mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(scores - mx.index_select(0, segment_ids))
    if valid is not None:
        ex = torch.where(valid, ex, 0.0)
    den = seg_sum(ex, segment_ids, num_segments)
    return ex / torch.clamp(den.index_select(0, segment_ids), min=1e-16)


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
    return -(gold * m).sum() / torch.clamp(m.sum(), min=1.0)


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
