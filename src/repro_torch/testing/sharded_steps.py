"""The sharded train steps against the unsharded ones, on a real group.

    PYTHONPATH=src python -m repro_torch.testing.sharded_steps [--world 4]

starts ``--world`` gloo processes on the CPU, each on a (2, world/2)
('data', 'model') mesh, and runs one step of each case both ways from the
same weights and batch: the cell's step on DTensors placed by the cell's
specs (``cells.place``), and the port's unsharded step on plain tensors.
Cases: reduced olmo-1b (AdamW), reduced olmoe-1b-7b (AdamW, the expert
exchange's all-to-all, capacity factor 1 so assignments drop), reduced
GatedGCN on a graph with its node rows split (SGD).  Each rank checks the
placement order first (an ``arange`` split over ('pod', 'data') on a
mesh with those names).  Rank 0 prints one JSON line: the largest
relative error (max |a - b| over max |b|, a leaf at a time) of the loss,
the updated parameters and, for AdamW, the first moments (the gradients'
tenth) of each case.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

SEED = 0
LM_BATCH, LM_SEQ = 4, 32
GNN_NODES, GNN_EDGES = 64, 256


def _weights(template, rng) -> dict:
    """Numpy leaves for the meta tree ``template`` (the reference's
    layout), N(0, 0.1) a leaf."""
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda t: (rng.standard_normal(tuple(t.shape)) * 0.1)
                    .astype(np.float32), template)


def _rel(a, b) -> float:
    a = a.full_tensor() if hasattr(a, "full_tensor") else a
    b = b.full_tensor() if hasattr(b, "full_tensor") else b
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _tree_rel(a, b) -> float:
    from repro_torch.utils.tree import tree_leaves

    return max(_rel(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _copy(tree):
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda t: t.clone(), tree)


def lm_case(arch: str, mesh, **overrides) -> dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import cells
    from repro_torch.launch import shardings as shd
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    cfg = dataclasses.replace(get_arch(arch).reduced_config(), **overrides)
    rng = np.random.default_rng(SEED)
    params = lm.params_from_reference(
        _weights(lm.init_params(cfg, device="meta"), rng), cfg, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in TokenStream(
        cfg.vocab, LM_BATCH, LM_SEQ, seed=1).batch_at(0).items()}
    # AdamW's first update is g / (|g| + eps): with the default eps a
    # gradient near zero turns its float32 summation order into an update
    # of either sign; eps = 1e-3 keeps the update a smooth function of g
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=1, eps=1e-3)
    step = lm.make_train_step(cfg, opt_cfg)

    p0, o0, m0 = step(_copy(params), init_opt_state(params), batch)
    pspecs = shd.lm_param_specs(params, mesh)
    specs = (pspecs, shd.opt_state_specs(pspecs), shd.lm_batch_spec(mesh))
    args = cells.place((params, init_opt_state(params), batch), specs, mesh)
    p1, o1, m1 = cells._sharded(step)(*args)
    return {"loss": _rel(m1["loss"], m0["loss"]),
            "params": _tree_rel(p1, p0), "mu": _tree_rel(o1["mu"], o0["mu"])}


def gnn_case(mesh) -> dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import cells
    from repro_torch.launch import shardings as shd
    from repro_torch.models.gnn import gatedgcn

    cfg = get_arch("gatedgcn").reduced_config(d_feat=32, n_classes=5)
    rng = np.random.default_rng(SEED)
    params = gatedgcn.params_from_reference(
        _weights(gatedgcn.init_params(cfg, device="meta"), rng), cfg, "cpu")
    edges = rng.integers(0, GNN_NODES, (GNN_EDGES, 2))
    edges[-9:] = -1  # padding rows
    graph = {
        "nodes": torch.as_tensor(rng.standard_normal((GNN_NODES, 32)),
                                 dtype=torch.float32),
        "edges": torch.as_tensor(edges, dtype=torch.int64),
        "labels": torch.as_tensor(rng.integers(0, 5, GNN_NODES)),
        "train_mask": torch.as_tensor(rng.random(GNN_NODES) < 0.5,
                                      dtype=torch.float32),
    }
    step = cells.make_gnn_train_step("gatedgcn", cfg, "cls", lr=0.1)
    specs = (shd.replicated(params, mesh),
             shd.gnn_graph_specs(graph, mesh, shard_nodes=True))
    p0, l0 = step(params, graph)
    p1, l1 = step(*cells.place((params, graph), specs, mesh))
    return {"loss": _rel(l1, l0), "params": _tree_rel(p1, p0)}


def placement_order() -> bool:
    """An arange split over ('pod', 'data') lands pod-major."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import shardings as shd

    world = dist.get_world_size()
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("pod", "data"))
    full = torch.arange(4 * world)
    t = distribute_tensor(full, mesh,
                          shd.placements((("pod", "data"),), mesh),
                          src_data_rank=None)
    pod, data = mesh.get_coordinate()
    i = pod * (world // 2) + data
    return torch.equal(t.to_local(), full[4 * i:4 * (i + 1)])


def _rank(rank: int, world: int, port: int, out: dict) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, world // 2),
                                mesh_dim_names=("data", "model"))
        res = {"placement_order": placement_order(),
               "olmo-1b": lm_case("olmo-1b", mesh),
               "olmoe-1b-7b": lm_case("olmoe-1b-7b", mesh,
                                      capacity_factor=1.0),
               "gatedgcn": gnn_case(mesh)}
        if rank == 0:
            out.update(res)
            print(json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args(argv)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.multiprocessing.spawn(_rank, args=(args.world, _free_port(), {}),
                                nprocs=args.world)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
