"""The assigned input-shape grids, one per architecture family."""
from __future__ import annotations

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": dict(
        kind="train", n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7,
        task="cls", shard_nodes=False, edge_chunks=1,
    ),
    "minibatch_lg": dict(
        kind="train", batch_nodes=1024, fanouts=(15, 10), d_feat=602,
        n_classes=41, task="cls", shard_nodes=True, edge_chunks=8,
        src_nodes=232_965, src_edges=114_615_892,
    ),
    "ogb_products": dict(
        kind="train", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
        n_classes=47, task="cls", shard_nodes=True, edge_chunks=64,
    ),
    "molecule": dict(
        kind="train", n_nodes=30, n_edges=64, batch=128, d_feat=16,
        n_classes=1, task="reg", shard_nodes=False, edge_chunks=1,
    ),
}

