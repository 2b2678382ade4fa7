"""Train GAT on a synthetic Cora with LiteMat-encoded semantic edges, on the
PyTorch port.

The GNN-family tie-in: edges carry LiteMat property ids, and the training
graph is restricted to a *semantic neighborhood* — all edges whose type is
subsumed by a query property — with one interval compare instead of a
set-membership filter.

    PYTHONPATH=src python examples/train_gnn_torch.py [--steps 200]
    PYTHONPATH=src python examples/train_gnn_torch.py --device cpu

It runs on CUDA, which must exist, unless ``--device`` names another
device.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.tbox import Ontology, build_tbox
from repro_torch.data.graphs import graph_to_device, make_cora_like
from repro_torch.device import resolve_device
from repro_torch.launch.cells import make_gnn_train_step
from repro_torch.models.gnn import gat


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # a tiny edge-type ontology: cites <= relatedTo, refutes <= relatedTo
    onto = Ontology(
        concepts=["Paper"], properties=["relatedTo", "cites", "refutes", "sameVenue"],
        subprop=[("cites", "relatedTo"), ("refutes", "relatedTo")],
    )
    tbox = build_tbox(onto)
    penc = tbox.properties

    g = make_cora_like(n_nodes=args.nodes, n_edges=args.nodes * 5, d_feat=64, seed=0)
    rng = np.random.default_rng(0)
    names = ["cites", "refutes", "sameVenue"]
    etype = np.array([penc.id_of(names[i]) for i in rng.integers(0, 3, len(g["edges"]))],
                     dtype=np.int32)

    # semantic neighborhood: one interval compare selects cites+refutes edges
    (lo, hi), _ = penc.interval_of("relatedTo")
    keep = (etype >= lo) & (etype < hi)
    print(f"semantic filter relatedTo: kept {keep.sum()}/{len(etype)} edges "
          f"(interval [{lo},{hi}) — no per-subproperty scan)")
    g["edges"] = g["edges"][keep]

    gt = graph_to_device(g, device)
    cfg = gat.GATConfig(d_in=64, d_hidden=8, n_heads=8)
    params = gat.init_params(cfg, device=device, seed=0)
    step = make_gnn_train_step("gat", cfg, "cls", lr=0.5)

    for i in range(args.steps):
        params, loss = step(params, gt)
        if i % 25 == 0 or i == args.steps - 1:
            with torch.no_grad():
                logits = gat.forward(params, gt, cfg)
            acc = float((logits.argmax(-1) == gt["labels"]).float().mean())
            print(f"step {i:>4}: loss={float(loss):.4f} acc={acc:.3f}")


if __name__ == "__main__":
    main()
