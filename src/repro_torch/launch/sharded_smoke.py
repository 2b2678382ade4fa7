"""Sharded training across processes: a cell's step on a real group.

    PYTHONPATH=src python -m repro_torch.launch.sharded_smoke --world 4 \\
        [--block block.npz] [--device cpu]

starts ``--world`` processes, one card each (``--device cpu``: gloo on
the host), joined by ``distributed/runtime.py``'s group, on a
(2, world/2) ('data', 'model') mesh.  Each prints nothing; process 0
prints one JSON line a step of the run:

* ``olmoe``: olmoe-1b-7b ``train_4k`` (the full config unless
  ``--reduced``) at a global batch of ``--batch`` (sequence kept), seed-0
  weights made whole on every process and placed by the cell's specs.
  Process 0 first takes the loss of the whole model on its card (one
  forward, no gradient), for the sharded first step's loss to equal.
  Step 1 runs under ``hlo_analysis.StepCounter`` (its FLOPs and
  collective bytes a rank, to hold against the dry run's), steps 2 to
  ``--steps`` are timed (the group synced around each), one more step
  runs under ``torch.profiler`` (its device time by kernel, NCCL's
  share).  Peak GiB a process.
* ``gatedgcn``: with ``--block`` (a padded ``minibatch_lg`` block as
  ``np.savez`` wrote it), GatedGCN at its full config on the block, node
  rows split (``shard_nodes=True``), ``--gnn-steps`` SGD steps from seed-0
  weights: the losses.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

ARCH = "olmoe-1b-7b"
TIMEOUT_S = 600.0  # a collective waiting past this fails the run


def _emit(step: str, **fields) -> None:
    print(json.dumps({"step": step, **fields}), flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()


def _peak_gib(dev) -> float | None:
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2**30


def _gather(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _nccl_share(fn, dev) -> dict:
    """One call of ``fn`` under torch.profiler: the device time of every
    kernel, and the share of it in NCCL's kernels.  The profiler also
    lists each NCCL collective as an ``nccl:`` range on the device with
    its kernel's time: those are left out, or NCCL would count twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        fn()
        _sync(dev)
    ks = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
          and not e.key.startswith("nccl:")]
    busy = sum(ms for _, ms in ks)
    nccl = sum(ms for k, ms in ks if "nccl" in k.lower())
    top = sorted(ks, key=lambda kv: -kv[1])[:8]
    return {"device_ms": busy, "nccl_ms": nccl,
            "nccl_share": nccl / busy if busy else None,
            "top_kernels_ms": [[k[:80], ms] for k, ms in top]}


def run_lm(args, rank: int, mesh, dev) -> None:
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import cells
    from repro_torch.launch.dry_run import with_batch
    from repro_torch.launch.hlo_analysis import StepCounter
    from repro_torch.models import lm

    mod = get_arch(ARCH)
    over = dataclasses.asdict(mod.reduced_config()) if args.reduced else None
    cell = with_batch(cells._lm_cell(mod, "train_4k", mesh, over),
                      args.batch, args.seq)
    cfg = cells._apply_overrides(mod.full_config(), over)
    S = cell.abstract_args[2]["tokens"].shape[1]
    stream = TokenStream(cfg.vocab, args.batch, S, seed=1)

    def batch_at(i):
        return {k: torch.as_tensor(v).to(dev)
                for k, v in stream.batch_at(i).items()}

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_params(cfg, device=dev, seed=0)
    whole = None
    if rank == 0:  # the unsharded model's loss on the first batch
        t = time.perf_counter()
        with torch.no_grad():
            whole = float(lm.loss_fn(params, batch_at(0), cfg)[0])
        whole_s = time.perf_counter() - t
    from repro_torch.train.optimizer import init_opt_state

    params_s = cells.place(params, cell.in_specs[0], mesh)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    state = {"p": params_s, "o": init_opt_state(params_s)}
    batches = [cells.place(batch_at(i), cell.in_specs[2], mesh)
               for i in range(args.steps + 1)]

    def step(i):
        state["p"], state["o"], m = cell.fn(state["p"], state["o"],
                                            batches[i])
        return m

    _sync(dev)
    t = time.perf_counter()
    with StepCounter() as counter:
        m = step(0)
    first = float(m["loss"])
    _sync(dev)
    counted_s = time.perf_counter() - t
    counts = counter.result()
    losses, ms = [first], []
    for i in range(1, args.steps):
        _sync(dev)
        t = time.perf_counter()
        m = step(i)
        losses.append(float(m["loss"]))
        _sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    prof = _nccl_share(lambda: step(args.steps), dev)
    peaks = _gather(_peak_gib(dev))
    if rank == 0:
        _emit("olmoe", arch=cfg.name, mesh=list(mesh.mesh.shape),
              batch=args.batch, seq=S, params=cfg.param_count(),
              model_flops=cell.model_flops, losses=losses,
              finite=all(math.isfinite(x) for x in losses),
              whole_model_loss=whole, whole_model_s=whole_s,
              first_loss_rel_diff=abs(first - whole) / abs(whole),
              counted=counts, counted_step_s=counted_s, step_ms=ms,
              step_ms_median=float(np.median(ms)) if ms else None,
              peak_gib_per_process=peaks, profile_one_step=prof)


def run_gnn(args, rank: int, mesh, dev) -> None:
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.data.graphs import graph_to_device
    from repro_torch.launch import cells
    from repro_torch.launch import shardings as shd
    from repro_torch.models.gnn import gatedgcn

    shp = GNN_SHAPES["minibatch_lg"]
    block = dict(np.load(args.block))
    graph = graph_to_device(block, dev)
    cfg = get_arch("gatedgcn").full_config(
        d_feat=shp["d_feat"], n_classes=shp["n_classes"],
        edge_chunks=shp["edge_chunks"])
    params = gatedgcn.init_params(cfg, device=dev, seed=0)
    specs = (shd.replicated(params, mesh),
             shd.gnn_graph_specs(graph, mesh, shard_nodes=True))
    p, g = cells.place((params, graph), specs, mesh)
    del params, graph
    step = cells.make_gnn_train_step("gatedgcn", cfg, shp["task"])
    losses, ms = [], []
    for _ in range(args.gnn_steps):
        _sync(dev)
        t = time.perf_counter()
        p, loss = step(p, g)
        losses.append(float(loss))
        _sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    peaks = _gather(_peak_gib(dev))
    if rank == 0:
        _emit("gatedgcn", nodes=int(block["nodes"].shape[0]),
              edge_slots=int(block["edges"].shape[0]), losses=losses,
              step_ms=ms, peak_gib_per_process=peaks)


def _rank(rank: int, args, port: int) -> None:
    from repro_torch.distributed import runtime
    from repro_torch.launch.mesh import make_mesh

    rt = runtime.initialize(coordinator=f"127.0.0.1:{port}",
                            num_processes=args.world, process_id=rank,
                            device=args.device, timeout_s=TIMEOUT_S)
    dev = rt.devices[0]
    try:
        mesh = make_mesh((2, args.world // 2), ("data", "model"), dev.type)
        run_lm(args, rank, mesh, dev)
        if args.block:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            run_gnn(args, rank, mesh, dev)
    finally:
        runtime.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu for gloo on the host (default: a card each)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--block", default=None)
    ap.add_argument("--gnn-steps", type=int, default=2)
    args = ap.parse_args(argv)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.multiprocessing.spawn(_rank, args=(args, _free_port()),
                                nprocs=args.world)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
