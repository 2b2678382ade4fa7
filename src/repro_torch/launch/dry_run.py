"""Dry runs: each cell's step on meta DTensors over a fake process group.

    PYTHONPATH=src python -m repro_torch.launch.dry_run [--cells SET]

``analyze_step`` of every cell of a set, one JSON line a cell: the
per-rank FLOPs and their ratio to ``model_flops / n_devices``, the HBM
bytes, the collective bytes by kind and the seconds the run took.  It
runs on the host (meta tensors, a fake group of the mesh's size in this
one process): nothing is computed and no card is touched.  Sets:

  * ``reference``: olmoe-1b-7b train_4k on the (2, 2, 2) ('pod', 'data',
    'model') mesh (the reference's own mini dry run);
  * ``production``: every LM's train_4k and every GNN cell on the (16, 16)
    ('data', 'model') mesh, and deepseek-v2-236b train_4k on (2, 16, 16);
  * ``all``: both;
  * ``chip``: both, and olmoe-1b-7b train_4k at a global batch of 4 on a
    (2, 2) mesh, the four-card run of ``launch/sharded_smoke.py``.

``--batch B`` (and ``--seq S``) cuts every LM train cell's global batch
(and sequence); ``--arch`` / ``--shape`` / ``--mesh`` name one cell
instead of a set, ``--reduced`` takes its arch's reduced config.
"""
from __future__ import annotations

import argparse
import json
import time

REFERENCE = [("olmoe-1b-7b", "train_4k", (2, 2, 2), None)]
LM_TRAIN = ["olmo-1b", "gemma-2b", "gemma3-12b", "olmoe-1b-7b",
            "deepseek-v2-236b"]
GNN = ["gat-cora", "gatedgcn", "schnet", "equiformer-v2"]
GNN_SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
PRODUCTION = ([(a, "train_4k", (16, 16), None) for a in LM_TRAIN]
              + [(a, s, (16, 16), None) for a in GNN for s in GNN_SHAPES]
              + [("deepseek-v2-236b", "train_4k", (2, 16, 16), None)])
# what ``launch/sharded_smoke.py`` runs on four cards: its prediction
FOUR_CARDS = [("olmoe-1b-7b", "train_4k", (2, 2), 4)]
SETS = {"reference": REFERENCE, "production": PRODUCTION,
        "all": REFERENCE + PRODUCTION,
        "chip": REFERENCE + FOUR_CARDS + PRODUCTION}


def axis_names(shape) -> tuple:
    return ("pod", "data", "model")[-len(shape):] if len(shape) > 1 \
        else ("data",)


def with_batch(cell, batch: int, seq: int | None = None):
    """An LM train cell with its global batch cut to ``batch`` (and its
    sequence to ``seq``)."""
    import dataclasses

    from repro_torch.launch.cells import sds

    if cell.family != "lm" or cell.kind != "train":
        return cell
    params, opt, b = cell.abstract_args
    S = seq or b["tokens"].shape[1]
    b = {k: sds((batch, S), t.dtype) for k, t in b.items()}
    flops = cell.model_flops / cell.meta["tokens"] * batch * S
    return dataclasses.replace(
        cell, abstract_args=(params, opt, b), model_flops=flops,
        meta={**cell.meta, "tokens": batch * S})


def dry_run(arch: str, shape_id: str, mesh_shape, batch=None, seq=None,
            reduced: bool = False) -> dict:
    """One cell's ``analyze_step`` on a fake group of the mesh's size
    (an LM train cell's batch and sequence cut to ``batch`` and ``seq``,
    its arch's reduced config with ``reduced``)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import cells as cells_lib
    from repro_torch.launch.hlo_analysis import analyze_step, fake_group
    from repro_torch.launch.mesh import make_mesh

    n = 1
    for s in mesh_shape:
        n *= s
    with fake_group(n):
        mesh = make_mesh(mesh_shape, axis_names(mesh_shape), "cuda")
        t0 = time.perf_counter()
        if reduced:
            mod = get_arch(arch)
            cell = cells_lib._lm_cell(
                mod, shape_id, mesh,
                dataclasses.asdict(mod.reduced_config()))
        else:
            cell = cells_lib.build_cell(arch, shape_id, mesh)
        if batch:
            cell = with_batch(cell, batch, seq)
        a = analyze_step(cell, mesh)
        a["build_seconds"] = time.perf_counter() - t0 - a["seconds"]
    return {"arch": arch, "shape": shape_id, "mesh": list(mesh_shape),
            "devices": n, "model_flops": cell.model_flops,
            "flops_ratio": a["flops"] / (cell.model_flops / n),
            "meta": cell.meta, **a}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", choices=sorted(SETS), default="all")
    ap.add_argument("--arch")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="16,16")
    ap.add_argument("--batch", type=int)
    ap.add_argument("--seq", type=int)
    ap.add_argument("--reduced", action="store_true",
                    help="the LM arch's reduced config")
    args = ap.parse_args(argv)
    cells = ([(args.arch, args.shape,
               tuple(int(x) for x in args.mesh.split(",")), None)]
             if args.arch else SETS[args.cells])
    for arch, shape_id, mesh_shape, batch in cells:
        print(json.dumps({"dry_run": dry_run(
            arch, shape_id, mesh_shape, batch or args.batch, args.seq,
            args.reduced)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
