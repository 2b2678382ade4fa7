"""Serving launcher: batched LiteMat query serving (the paper's workload).

``PYTHONPATH=src python -m repro_torch.launch.serve --universities 2
--requests 1024`` builds a LUBM-style KB, encodes + lite-materializes it on
the GPU, then serves batches of parameterized class/member queries through
the batched plans, reporting throughput and p50/p99 latencies.
``--device cpu`` runs the plain versions on the CPU instead.

``--concurrent`` switches to the snapshot-isolated request runtime
(serving/runtime.py): N submitter threads drive Q1–Q4 through the bounded
admission queue while a writer thread streams 64-row inserts, and the
report adds shed/deadline/stale counts on top of the latency percentiles.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
from repro_torch.core.shard import is_sharded
from repro_torch.rdf.generator import generate_lubm
from repro_torch.serving.engine import QueryServer, ShardedQueryServer
from repro_torch.serving.runtime import ServingRuntime

CLASSES = ["Professor", "Student", "Faculty", "Person", "Course",
           "Publication", "Organization", "Department", "Chair",
           "GraduateStudent"]
PROPS = ["memberOf", "worksFor", "degreeFrom", "takesCourse", "advisor"]


def _sync(K) -> None:
    if K.device.type == "cuda":
        torch.cuda.synchronize(K.device)


def insert_stream(rt, raw, seed: int, stop: threading.Event,
                  rows: int = 64, pause_s: float = 0.01) -> threading.Thread:
    """Start a writer thread inserting ``rows``-row slices of ``raw`` into
    the runtime's store until ``stop`` is set; returns the thread."""
    s, p, o = np.asarray(raw.s), np.asarray(raw.p), np.asarray(raw.o)

    def writer():
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            i = int(rng.integers(0, max(s.shape[0] - rows, 1)))
            rt.insert((s[i:i + rows], p[i:i + rows], o[i:i + rows]),
                      auto_compact=False)
            if stop.wait(pause_s):
                return

    w = threading.Thread(target=writer, name="insert-stream", daemon=True)
    w.start()
    return w


def run_concurrent(K, raw, args, queries=None) -> dict:
    """Mixed workload through the snapshot-isolated runtime, with a writer
    inserting 64-row slices of ``raw`` meanwhile (none when ``raw`` is
    None); returns the outcomes, the runtime, its stats and its latency
    summary."""
    queries = list(queries or PAPER_QUERIES.values())
    rt = ServingRuntime(
        K, modes=("litemat",), n_workers=args.workers,
        max_queue=args.max_queue, default_deadline_s=args.deadline_s)
    with rt:
        rt.registry.prewarm(queries)
        stop = threading.Event()
        w = (None if raw is None
             else insert_stream(rt, raw, args.seed + 1, stop))
        try:
            futs = [rt.submit(queries[i % len(queries)])
                    for i in range(args.requests)]
            outs = [f.result() for f in futs]
        finally:
            stop.set()
            if w is not None:
                w.join()
    n_ok = sum(o.ok for o in outs)
    lat = rt.latency_stats()
    print(f"concurrent: {n_ok}/{len(outs)} ok "
          f"p50={lat.get('p50_ms', 0):.2f}ms p99={lat.get('p99_ms', 0):.2f}ms "
          f"stats={rt.stats}")
    return {"outcomes": outs, "stats": rt.stats, "latency": lat,
            "runtime": rt}


def serve_batches(K, requests: int, batch: int, seed: int) -> dict:
    """The QueryServer loop: ``requests`` requests in batches of ``batch``,
    alternating ``class_members`` and ``class_prop_join`` batches over
    ``CLASSES`` x ``PROPS``.  Returns the requests with their answers, the
    throughput and the per-request p50/p99 (each batch's time over its
    size).  One request of each kind runs before the clock starts: it
    builds the server's views (the type index, the sorted property view).
    A sharded store is served by ``ShardedQueryServer``."""
    srv = (ShardedQueryServer if is_sharded(K) else QueryServer)(K)
    srv.class_members(CLASSES[:1])
    srv.class_prop_join(CLASSES[:1], PROPS[:1])
    rng = np.random.default_rng(seed)
    lat, served, log = [], 0, []
    t0 = time.perf_counter()
    while served < requests:
        b = min(batch, requests - served)
        names = [CLASSES[i] for i in rng.integers(0, len(CLASSES), b)]
        t1 = time.perf_counter()
        if served % (2 * batch) < batch:
            props = None
            counts, _ = srv.class_members(names)
        else:
            props = [PROPS[i] for i in rng.integers(0, len(PROPS), b)]
            counts, _ = srv.class_prop_join(names, props)
        lat.append((time.perf_counter() - t1) / b)
        log.append((names, props, counts))
        served += b
    wall = time.perf_counter() - t0
    lat_ms = np.array(lat) * 1000
    return {"served": served, "wall_s": wall, "qps": served / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)), "log": log}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--universities", type=int, default=1)
    ap.add_argument("--requests", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--concurrent", action="store_true",
                    help="drive the snapshot-isolated request runtime "
                         "(readers + background update stream)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--deadline-s", type=float, default=None)
    args = ap.parse_args()

    print(f"generating LUBM-like KB ({args.universities} universities)...")
    raw = generate_lubm(args.universities, seed=args.seed)
    t0 = time.time()
    K = KnowledgeBase.build(raw, device=args.device)
    _sync(K)
    print(f"encoded+materialized {raw.n_triples:,} triples in "
          f"{time.time() - t0:.1f}s (sizes: {K.sizes()})")

    if args.concurrent:
        run_concurrent(K, raw, args)
        return
    out = serve_batches(K, args.requests, args.batch, args.seed)
    print(f"served {out['served']} queries in {out['wall_s']:.2f}s -> "
          f"{out['qps']:,.0f} q/s; per-query p50={out['p50_ms']:.2f}ms "
          f"p99={out['p99_ms']:.2f}ms (amortized)")


if __name__ == "__main__":
    main()
