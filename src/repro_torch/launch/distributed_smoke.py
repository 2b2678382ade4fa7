"""Multi-process smoke: each process a replica of the sharded store on its
own devices, checked, with one collective and the fleet's telemetry.

    python -m repro_torch.launch.distributed_smoke --process-id 0 \\
        --num-processes 2 --device cpu --n-shards 4 --metrics-dir out &
    python -m repro_torch.launch.distributed_smoke --process-id 1 \\
        --num-processes 2 --device cpu --n-shards 4 --metrics-dir out

or, without ``--process-id``, from ``torchrun``'s environment:

    torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.distributed_smoke --device cpu --n-shards 4

Without ``--device cpu`` every process needs CUDA and owns
``--local-devices`` cards (distributed/runtime.py: NCCL when no card is
shared, gloo when processes share one).  Each process, in order:

  1. joins the group and checks the topology: the world's size and its
     own devices;
  2. ``all_reduce_check``: its count of local devices, summed over the
     world;
  3. builds a ``ShardedKB`` of LUBM-``--universities`` (``--seed``) over its
     own devices and runs Q4 through the repartition combine: the combine
     taken, nothing re-uploaded, the rows equal to a single
     ``KnowledgeBase`` of the same data; with ``--answers-dir`` it builds no
     single store and writes Q1–Q4's rows in litemat, full and rewrite
     (indexed) and in litemat's scans to ``answers-proc{rank}.npz`` there
     for its caller to check;
  4. ingests LUBM-1 (seed 11) in two parts through the sharded dictionary
     encode (forced on where the process has fewer devices than shards),
     Q1–Q4 equal in fingerprint space to a host-encode control;
  5. with ``--queries N``: after a barrier, process 0 alone runs N queries
     (Q1–Q4 in litemat, indexed, round robin) on the sharded store between
     two barriers, then every process runs N at once: wall time, q/s and
     kernel launches per device;
  6. with ``--metrics-dir``: the fleet export (``runtime.export_fleet``);
     process 0 checks that ``shard/combine_runs`` in ``fleet.json`` is the
     sum over the processes and above 0, and that every process's
     histograms are in it.

Each step prints one JSON line carrying ``rank``; a failed check raises,
and the process exits non-zero.  The last line is ``{"step": "done",
...}`` with the process's kernel launches and peak memory per card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
from repro_torch.core.shard import ShardedKB, ShardedQueryEngine
from repro_torch.core.tbox import build_tbox
from repro_torch.distributed import runtime
from repro_torch.kernels import build
from repro_torch.obs.metrics import REGISTRY
from repro_torch.rdf.generator import generate_lubm
from repro_torch.utils import pair64

# the runs whose answers ``--answers-dir`` keeps: three modes indexed, and
# litemat's scans (the fused interval scan, K2)
ANSWER_RUNS = (("litemat", True), ("full", True), ("rewrite", True),
               ("litemat", False))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"distributed smoke: {what}")


def emit(rank: int, step: str, **fields) -> None:
    print(json.dumps({"rank": rank, "step": step, **fields}), flush=True)


def select_of(patterns) -> tuple:
    """The patterns' variables in order of first use."""
    return tuple(dict.fromkeys(
        v for p in patterns for v in (p.s, p.p, p.o)
        if isinstance(v, str) and v.startswith("?")))


def answers_key(q: str, mode: str, use_index: bool = True) -> str:
    return f"{q}_{mode}" + ("" if use_index else "_scan")


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _launches() -> dict:
    """Kernel launches so far, per device: {"cuda:i": {wrapper: n}}."""
    out = {}
    for (name, index), n in sorted(build.DEVICE_LAUNCHES.items()):
        out.setdefault(f"cuda:{index}", {})[name] = n
    return out


def _since(before: dict) -> dict:
    return {d: {k: n - before.get(d, {}).get(k, 0) for k, n in per.items()
                if n > before.get(d, {}).get(k, 0)}
            for d, per in _launches().items()}


def _fp_answers(kb, patterns) -> set:
    """Litemat answers as rows of term fingerprints (ids differ between
    the sharded and the host encode)."""
    rows, _ = kb.query(patterns, select=select_of(patterns), mode="litemat")
    if rows.size == 0:
        return set()
    hi, lo, hit = kb.kb.table.extract_fp(torch.as_tensor(
        rows.reshape(-1).astype(np.int32), device=kb.device))
    require(bool(hit.all()), "an answer id is not in the dictionary")
    fps = pair64.combine_np(hi.cpu().numpy(), lo.cpu().numpy())
    return {tuple(r) for r in fps.reshape(rows.shape).tolist()}


def step_store(args, rank: int, devices: list) -> ShardedKB:
    """Step 3: the sharded store over this process's devices, Q4 through
    the repartition combine, the answers checked or written."""
    t0 = time.perf_counter()
    raw = generate_lubm(args.universities, seed=args.seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    S = ShardedKB.build(raw, n_shards=args.n_shards or len(devices))
    _sync(devices)
    build_s = time.perf_counter() - t0
    require(S.devices == devices[:S.n_shards],
            f"the store sits on {S.devices}, not on {devices}")
    S.track_ledger()  # per-shard hbm_bytes gauges ride the metrics export

    q4 = PAPER_QUERIES["Q4"]
    sel4 = select_of(q4)
    rep = ShardedQueryEngine(skb=S, use_repartition_join=True)
    uploads = REGISTRY.counter("device/transfer_bytes", src="combine_upload")
    up0 = uploads.value
    got, _ = rep.run(q4, select=sel4)
    require(rep.cache_stats["repartition_runs"] >= 1,
            f"Q4 did not take the repartition: {rep.cache_stats}")
    require(uploads.value == up0, f"the repartition re-uploaded "
                                  f"{uploads.value - up0} B")
    out = {"devices": [str(d) for d in S.devices],
           "shard_devices": [str(d) for d in S.shard_devices()],
           "n_shards": S.n_shards, "raw_triples": int(raw.s.shape[0]),
           "generate_s": gen_s, "build_s": build_s,
           "q4_rows": int(got.shape[0]),
           "cache_stats": dict(rep.cache_stats)}
    if args.answers_dir:
        t0 = time.perf_counter()
        rows, counts = {}, {}
        for mode, use_index in ANSWER_RUNS:
            for q, pats in PAPER_QUERIES.items():
                r, _ = S.query(pats, select=select_of(pats), mode=mode,
                               use_index=use_index)
                key = answers_key(q, mode, use_index)
                rows[key] = r
                counts[key] = int(r.shape[0])
        require(np.array_equal(rows[answers_key("Q4", "litemat")], got),
                "Q4 through the repartition differs from the host fold")
        path = Path(args.answers_dir) / f"answers-proc{rank}.npz"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **rows)
        out.update(answers=str(path), counts=counts,
                   answers_s=time.perf_counter() - t0)
    else:
        K = KnowledgeBase.build(raw, device=devices[0])
        want, _ = K.query(q4, select=sel4, mode="litemat")
        require(np.array_equal(got, want),
                f"Q4 through the repartition: {got.shape[0]} rows, the "
                f"single store {want.shape[0]}")
        del K
    emit(rank, "store", **out)
    return S


def step_ingest(args, rank: int, devices: list) -> None:
    """Step 4: the sharded-encode ingest against a host-encode control."""
    t0 = time.perf_counter()
    pool = generate_lubm(1, seed=11)
    half = pool.s.shape[0] // 2
    parts = [(pool.s[:half], pool.p[:half], pool.o[:half]),
             (pool.s[half:], pool.p[half:], pool.o[half:])]
    n_shards = args.n_shards or len(devices)
    forced = not len(devices) >= n_shards > 1  # the automatic rule is off
    SI = ShardedKB.ingest(iter(parts), onto=pool.onto, n_shards=n_shards,
                          use_sharded_encode=True if forced else None)
    require(SI._sharded_encode_on(), "the ingest took the host encode")
    require(SI.ingest_report.ok, f"ingest failed: {SI.ingest_report.failed}")
    ctrl = ShardedKB.empty(build_tbox(pool.onto), n_shards=n_shards)
    for part in parts:
        ctrl.insert(part, auto_compact=False)
    counts = {}
    for q, pats in PAPER_QUERIES.items():
        a = _fp_answers(SI, pats)
        require(a == _fp_answers(ctrl, pats),
                f"{q}: the sharded encode's answers differ from the host "
                f"encode's")
        counts[q] = len(a)
    require(counts["Q1"] > 0, "Q1 found nothing")
    emit(rank, "sharded_encode", forced=forced, answers=counts,
         seconds=time.perf_counter() - t0)


def run_queries(S: ShardedKB, n: int, devices: list) -> dict:
    """``n`` queries, Q1–Q4 in litemat (indexed) round robin: wall time,
    q/s, the process's CPU seconds (all its threads) and the kernel
    launches per device they made."""
    queries = list(PAPER_QUERIES.values())
    before = _launches()
    _sync(devices)
    t0, c0 = time.perf_counter(), time.process_time()
    for i in range(n):
        S.query(queries[i % len(queries)])
    _sync(devices)
    wall, cpu = time.perf_counter() - t0, time.process_time() - c0
    return {"queries": n, "wall_s": wall, "qps": n / wall, "cpu_s": cpu,
            "launches_by_device": _since(before)}


def step_throughput(args, rank: int, S: ShardedKB, devices: list) -> None:
    """Step 5: process 0 alone between two barriers, then every process."""
    runtime.barrier()
    if rank == 0:
        emit(rank, "queries_alone", **run_queries(S, args.queries, devices))
    runtime.barrier()
    emit(rank, "queries_together", **run_queries(S, args.queries, devices))
    runtime.barrier()


def step_fleet(args, rank: int) -> None:
    """Step 6: the fleet export and, on process 0, the reference's
    checks of the aggregate."""
    fleet, snaps = runtime.export_fleet(args.metrics_dir)
    if fleet is None:
        emit(rank, "fleet_export", path=str(
            Path(args.metrics_dir) / f"metrics-proc{rank}.json"))
        return
    key = "shard/combine_runs"

    def runs(snap) -> int:
        return sum(e["value"] for e in snap["counters"] if e["name"] == key)

    per_proc = [runs(s) for s in snaps]
    require(runs(fleet) == sum(per_proc) and per_proc[0] > 0,
            f"{key}: fleet {runs(fleet)}, processes {per_proc}")
    hists = {(e["name"], tuple(sorted(e["labels"].items())))
             for e in fleet["histograms"]}
    for s in snaps:
        for e in s["histograms"]:
            k = (e["name"], tuple(sorted(e["labels"].items())))
            require(k in hists, f"histogram {k} missing from the fleet")
    emit(rank, "fleet", path=str(Path(args.metrics_dir) / "fleet.json"),
         processes=len(snaps), combine_runs=per_proc,
         fleet_combine_runs=runs(fleet),
         histograms=len(fleet["histograms"]))


def run(args) -> None:
    t_start = time.perf_counter()
    rt = runtime.initialize(
        coordinator=args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id, local_devices=args.local_devices,
        device=args.device, timeout_s=args.timeout_s)
    rank, devices = rt.process_id, runtime.local_devices()
    if devices[0].type == "cuda":
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    require(runtime.process_count() == rt.num_processes
            and runtime.process_index() == rt.process_id,
            f"the group has {runtime.process_count()} processes")
    want = (1 if devices[0].type == "cpu" else
            min(args.local_devices, torch.cuda.device_count()))
    require(len(devices) == want,
            f"{len(devices)} local devices, want {want}")
    emit(rank, "topology", world=rt.num_processes, backend=rt.backend,
         local_devices=[str(d) for d in devices])
    emit(rank, "collective", sum=runtime.all_reduce_check(),
         want=rt.num_processes * len(devices))
    S = step_store(args, rank, devices)
    step_ingest(args, rank, devices)
    if args.queries:
        step_throughput(args, rank, S, devices)
    if args.metrics_dir:
        step_fleet(args, rank)
    peaks = ({str(d): torch.cuda.max_memory_allocated(d) / 2**30
              for d in devices} if devices[0].type == "cuda" else None)
    emit(rank, "done", ok=True, launches_by_device=_launches(),
         peak_gib_by_device=peaks, seconds=time.perf_counter() - t_start)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (default: MASTER_ADDR and "
                         "MASTER_PORT)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="default: WORLD_SIZE")
    ap.add_argument("--process-id", type=int, default=None,
                    help="default: RANK (torchrun)")
    ap.add_argument("--local-devices", type=int, default=1,
                    help="cards each process owns")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the group on the CPU (gloo)")
    ap.add_argument("--timeout-s", type=float, default=60.0,
                    help="the group's collective and rendezvous timeout")
    ap.add_argument("--universities", type=int, default=1)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--n-shards", type=int, default=None,
                    help="default: one per local device")
    ap.add_argument("--answers-dir", default="",
                    help="write Q1–Q4's rows here, build no single store")
    ap.add_argument("--queries", type=int, default=0,
                    help="queries in each throughput loop (0: none)")
    ap.add_argument("--metrics-dir", default="",
                    help="export per-process mergeable metrics snapshots "
                         "here; process 0 aggregates them into fleet.json")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        run(args)
    finally:
        runtime.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
