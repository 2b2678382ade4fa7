"""Graph data pipeline: synthetic datasets + a real neighbor sampler.

Generators mirror the assigned shape grid:
  * ``make_cora_like``      — full_graph_sm   (2708 nodes / 10556 edges / 1433 feats)
  * ``make_product_graph``  — ogb_products-like power-law graphs
  * ``make_reddit_like``    — minibatch_lg source graph (sampled training)
  * ``make_molecules``      — batched small geometric graphs

``NeighborSampler`` implements real fanout-based k-hop sampling over a CSR
adjacency (numpy, host side — this is the data pipeline, exactly where
GraphSAGE-style systems put it), emitting padded, relabeled subgraphs whose
static shapes match the dry-run's input_specs.

A copy of the reference's module (the same seeds, draw order and
arrays), plus ``graph_to_device``, which moves a graph dict onto the
card for the models in ``repro_torch.models.gnn``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device


def _sym(edges, n):
    e = np.concatenate([edges, edges[:, ::-1]], axis=0)
    e = np.unique(e, axis=0)
    return e


def make_cora_like(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7, seed=0,
                   with_pos: bool = False):
    rng = np.random.default_rng(seed)
    # preferential-attachment-ish edges
    src = rng.integers(0, n_nodes, n_edges)
    dst = (src + rng.zipf(2.0, n_edges)) % n_nodes
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    feats = (rng.random((n_nodes, d_feat)) < 0.012).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    # make labels weakly learnable: add label-correlated feature block
    feats[np.arange(n_nodes), labels % d_feat] += 3.0
    mask = np.zeros(n_nodes, bool)
    mask[rng.permutation(n_nodes)[: max(140, n_nodes // 20)]] = True
    g = dict(
        nodes=feats, edges=edges, labels=labels,
        train_mask=mask.astype(np.float32),
    )
    if with_pos:
        g["pos"] = rng.normal(size=(n_nodes, 3)).astype(np.float32)
        g["species"] = labels % 64
    return g


def make_product_graph(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                       n_classes=47, seed=0, with_pos: bool = False):
    return make_cora_like(n_nodes, n_edges, d_feat, n_classes, seed, with_pos)


def make_reddit_like(n_nodes=232_965, n_edges=114_615_892, d_feat=602, seed=0):
    return make_cora_like(n_nodes, n_edges, d_feat, 41, seed)


def make_molecules(n_graphs=128, nodes_per=30, edges_per=64, n_species=16, seed=0):
    rng = np.random.default_rng(seed)
    N = n_graphs * nodes_per
    pos = rng.normal(size=(N, 3)).astype(np.float32) * 2.0
    species = rng.integers(1, n_species, N).astype(np.int32)
    edges = []
    for g in range(n_graphs):
        base = g * nodes_per
        s = rng.integers(0, nodes_per, edges_per)
        d = (s + rng.integers(1, nodes_per, edges_per)) % nodes_per  # no loops
        edges.append(np.stack([s + base, d + base], axis=1))
    edges = np.concatenate(edges).astype(np.int32)
    batch_seg = np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per)
    energy = rng.normal(size=(n_graphs,)).astype(np.float32)
    return dict(
        pos=pos, species=species, edges=edges, batch_seg=batch_seg,
        n_graphs=n_graphs, energy=energy,
        nodes=np.eye(n_species, dtype=np.float32)[species],
    )


# ---------------------------------------------------------------------------
# Neighbor sampler (GraphSAGE-style fanout sampling, host side)
# ---------------------------------------------------------------------------


@dataclass
class CSRGraph:
    indptr: np.ndarray  # int64[N+1]
    indices: np.ndarray  # int32[E]

    @classmethod
    def from_edges(cls, edges: np.ndarray, n_nodes: int) -> "CSRGraph":
        dst = edges[:, 1].astype(np.int64)
        order = np.argsort(dst, kind="stable")
        sorted_dst = dst[order]
        indptr = np.searchsorted(sorted_dst, np.arange(n_nodes + 1))
        return cls(indptr=indptr, indices=edges[order, 0].astype(np.int32))


class NeighborSampler:
    """Uniform fanout sampling producing padded, relabeled subgraphs."""

    def __init__(self, edges: np.ndarray, n_nodes: int, seed: int = 0):
        self.csr = CSRGraph.from_edges(edges, n_nodes)
        self.rng = np.random.default_rng(seed)
        self.n_nodes = n_nodes

    def sample_neighbors(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """(B,) -> (B, fanout) sampled in-neighbors, -1 padded."""
        out = np.full((len(nodes), fanout), -1, dtype=np.int32)
        for i, v in enumerate(nodes):
            lo, hi = self.csr.indptr[v], self.csr.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = self.rng.integers(lo, hi, fanout) if deg > fanout else \
                np.concatenate([np.arange(lo, hi), self.rng.integers(lo, hi, fanout - deg)])
            out[i] = self.csr.indices[take[:fanout]]
        return out

    def sample_block(self, seeds: np.ndarray, fanouts):
        """k-hop sampled subgraph: returns (node_ids, edges_local, layers).

        node_ids: all touched global node ids (seeds first), edges_local:
        (E', 2) in local indices padded to the static budget implied by
        ``fanouts``, layers: per-hop frontier sizes (static).
        """
        frontier = np.asarray(seeds, dtype=np.int32)
        all_nodes = [frontier]
        all_edges = []
        id_of = {int(v): i for i, v in enumerate(frontier)}
        for fanout in fanouts:
            nbrs = self.sample_neighbors(frontier, fanout)  # (B, fanout)
            srcs, dsts = [], []
            next_frontier = []
            for i, v in enumerate(frontier):
                for u in nbrs[i]:
                    if u < 0:
                        srcs.append(-1)
                        dsts.append(-1)
                        continue
                    if int(u) not in id_of:
                        id_of[int(u)] = len(id_of)
                        next_frontier.append(u)
                    srcs.append(id_of[int(u)])
                    dsts.append(id_of[int(v)])
            all_edges.append(np.stack([np.array(srcs), np.array(dsts)], axis=1))
            frontier = np.array(next_frontier, dtype=np.int32) if next_frontier else frontier[:0]
            all_nodes.append(frontier)
        node_ids = np.concatenate(all_nodes) if len(all_nodes) else seeds
        edges_local = np.concatenate(all_edges).astype(np.int32)
        return np.array([id_for for id_for in id_of.keys()], dtype=np.int32), edges_local

    def padded_block(self, seeds: np.ndarray, fanouts, node_budget: int, edge_budget: int,
                     features: np.ndarray, labels: np.ndarray | None = None):
        """Fixed-shape training block for the minibatch_lg cell."""
        node_ids, edges_local = self.sample_block(seeds, fanouts)
        node_ids = node_ids[:node_budget]
        nodes = np.zeros((node_budget, features.shape[1]), np.float32)
        nodes[: len(node_ids)] = features[node_ids]
        e = np.full((edge_budget, 2), -1, np.int32)
        keep = edges_local[(edges_local[:, 0] < node_budget) & (edges_local[:, 1] < node_budget)
                           & (edges_local[:, 0] >= 0)]
        e[: min(len(keep), edge_budget)] = keep[:edge_budget]
        block = dict(nodes=nodes, edges=e)
        if labels is not None:
            lb = np.zeros((node_budget,), np.int32)
            lb[: len(node_ids)] = labels[node_ids]
            mask = np.zeros((node_budget,), np.float32)
            mask[: len(seeds)] = 1.0  # loss on seed nodes only
            block["labels"] = lb
            block["train_mask"] = mask
        return block


def block_shape_for(batch_nodes: int, fanouts) -> tuple:
    """Static (node_budget, edge_budget) implied by a fanout schedule."""
    nodes = batch_nodes
    total_nodes = batch_nodes
    edges = 0
    for f in fanouts:
        edges += nodes * f
        nodes = nodes * f
        total_nodes += nodes
    return total_nodes, edges


def graph_to_device(graph: dict, device=None) -> dict:
    """``graph``'s arrays as tensors on ``device`` (None: CUDA, which must
    exist).  Integer arrays (edges, species, labels, batch_seg) become
    int64, the index type of ``index_add`` and ``scatter_reduce``, once
    here rather than in every layer; entries that are not arrays (such as
    ``n_graphs``) are dropped."""
    device = resolve_device(device)
    out = {}
    for k, v in graph.items():
        if isinstance(v, torch.Tensor):
            t = v
        elif isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v))
        else:
            continue
        dtype = torch.int64 if not (t.is_floating_point()
                                    or t.dtype == torch.bool) else None
        out[k] = t.to(device=device, dtype=dtype)
    return out
