#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA.  It imports only
``repro_torch`` (never JAX or ``repro``).  Phases, each printing one JSON
line:

  1. device   — the card's name, count, and ``nvidia-smi``'s name and
                power limit (printed raw on a line of its own);
  2. build    — compiles every kernel under src/repro_torch/kernels/csrc;
  3. lubm1    — ``KnowledgeBase.build`` of LUBM-1 (seed 0): store sizes and
                Q1–Q4 answer counts in litemat and full, indexed and scan,
                against the reference's published numbers;
  4. lubm100  — LUBM-100 (seed 0): build with per-stage seconds and peak
                device memory; Q1–Q4 in litemat and full, indexed answers
                equal to scan answers, Q4's INL through the merge-path
                kernel, median of 5 warm runs per query;
  5. kernels  — each kernel against its plain version on the card at the
                main path's shapes and on edge cases (exact equality), its
                time beside its bound, its plain version's and one PyTorch
                call's; then the ``{"kernels": [...]}`` line with the launch
                counts of the main path (phases 3 and 4: every counter is
                zeroed just before phase 3 and read just after phase 4).

Any failed check raises, so the script exits non-zero; the last line,
printed only when everything passed, is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak bandwidth

# the reference's numbers for LUBM-1, seed 0 (BENCH_queries.json, table6)
LUBM1_SIZES = {"original": 136826, "lite": 137457, "full": 189936}
LUBM1_COUNTS = {"Q1": 726, "Q2": 13340, "Q3": 726, "Q4": 24}
LUBM_FULL = 100  # universities of the full-size run


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` from CUDA events over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def peak_gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return kind, count


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    regs = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for name, log in build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(build.SOURCES), "ptxas": regs})


def _counters():
    from repro_torch.kernels import merge_sorted, ops, pair_search, stream_compact

    return {
        "compact_tiles": stream_compact.compact_tiles,
        "masked_interval_tiles": stream_compact.masked_interval_tiles,
        "pair_search": pair_search.pair_search,
        "merge_path": merge_sorted.merge_path,
    }, ops.pass_counters


def read_counts() -> dict:
    wrappers, passes = _counters()
    out = {name: fn.launches for name, fn in wrappers.items()}
    out.update({f"pass/{k}": v for k, v in passes.items()})
    return out


def zero_counts() -> None:
    from repro_torch.kernels import ops

    for fn in _counters()[0].values():
        fn.launches = 0
    ops.reset_pass_counters()


def _all_queries(kb, expect=None):
    """Q1–Q4 in litemat and full, indexed and scan; indexed must equal scan."""
    import numpy as np
    from repro_torch.core.engine import PAPER_QUERIES

    counts = {}
    for mode in ("litemat", "full"):
        for q, pats in PAPER_QUERIES.items():
            rows_i, _ = kb.query(pats, mode=mode, use_index=True)
            rows_s, _ = kb.query(pats, mode=mode, use_index=False)
            require(np.array_equal(rows_i, rows_s),
                    f"{q}/{mode}: indexed answers differ from scan answers")
            require(rows_i.dtype == np.int32, f"{q}/{mode}: answers not int32")
            counts[f"{q}/{mode}"] = int(rows_i.shape[0])
            if expect is not None:
                require(rows_i.shape[0] == expect[q],
                        f"{q}/{mode}: {rows_i.shape[0]} answers, "
                        f"reference {expect[q]}")
    return counts


def phase_lubm1():
    import torch
    from repro_torch.core.engine import KnowledgeBase
    from repro_torch.rdf.generator import generate_lubm

    before = read_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kb = KnowledgeBase.build(generate_lubm(1, seed=0))
    build_s = time.perf_counter() - t0
    sizes = kb.sizes()
    require(sizes == LUBM1_SIZES, f"LUBM-1 sizes {sizes} != {LUBM1_SIZES}")
    counts = _all_queries(kb, LUBM1_COUNTS)
    after = read_counts()
    for k in ("compact_tiles", "masked_interval_tiles", "pair_search"):
        require(after[k] > before[k], f"LUBM-1 queries never launched {k}")
    emit({"phase": "lubm1", "seed": 0, "sizes": sizes, "answers": counts,
          "build_s": build_s, "peak_gib": peak_gib(),
          "launches": {k: after[k] - before[k] for k in after}})
    return kb


def phase_lubm100():
    import torch
    from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
    from repro_torch.obs import trace
    from repro_torch.rdf.generator import generate_lubm

    t0 = time.perf_counter()
    raw = generate_lubm(LUBM_FULL, seed=0)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    tracer = trace.Tracer()
    tr = tracer.new_trace("build")
    root = tracer.start_root(tr, "build")
    t0 = time.perf_counter()
    with trace.activate(root):
        kb = KnowledgeBase.build(raw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tracer.finish_trace(tr)
    stages = {s.name: s.duration_s for s in tr.spans[1:]}
    build_peak = peak_gib()
    sizes = kb.sizes()
    emit({"phase": "lubm100_build", "universities": LUBM_FULL, "seed": 0,
          "raw_triples": raw.n_triples, "generate_s": gen_s,
          "build_s": build_s, "stage_s": stages, "peak_gib": build_peak,
          "sizes": sizes, "lite_stats": kb.lite_stats,
          "full_stats": kb.full_stats})
    del raw

    torch.cuda.reset_peak_memory_stats()
    before = read_counts()
    t0 = time.perf_counter()
    counts = _all_queries(kb)  # cold: index builds and first runs included
    cold_s = time.perf_counter() - t0
    after = read_counts()
    require(after["merge_path"] > before["merge_path"]
            and after["pass/merge_partitioned"] > before["pass/merge_partitioned"],
            "LUBM-100 Q4 never took the partitioned merge path")
    plans, medians = {}, {}
    for mode in ("litemat", "full"):
        for use_index in (True, False):
            eng = kb.engine(mode, use_index)
            for q, pats in PAPER_QUERIES.items():
                key = f"{q}/{mode}/{'index' if use_index else 'scan'}"
                if use_index:
                    plans[key] = [(p["strategy"], p["store"])
                                  for p in eng.explain(pats)["patterns"]]
                times = []
                for _ in range(5):
                    t = time.perf_counter()
                    eng.run(pats)  # returns host arrays: waits for the device
                    times.append(time.perf_counter() - t)
                medians[key] = statistics.median(times) * 1e3
    for mode in ("litemat", "full"):
        require(("inl", "pso") in plans[f"Q4/{mode}/index"],
                f"LUBM-100 Q4/{mode} did not plan an INL probe")
    require(kb.lite_spo.shape[0] > (1 << 20),
            "LUBM-100 store must exceed INL_RESIDENT_MAX rows")
    emit({"phase": "lubm100_queries", "answers": counts, "cold_s": cold_s,
          "plans": plans, "median_ms": medians, "peak_gib": peak_gib(),
          "launches": {k: after[k] - before[k] for k in after},
          "profile": {f"{q}/litemat/index": _profile(
              lambda pats=PAPER_QUERIES[q]: kb.query(pats)) for q in ("Q2", "Q4")}})
    return kb


def _profile(fn, runs: int = 5) -> dict:
    """Device busy share and top kernels over ``runs`` calls (torch.profiler).

    The share is the summed self time of device kernels over the wall time
    of the window; ``None`` when the profiler reports no device time.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = sorted(((e.key, e.self_device_time_total)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), key=lambda d: -d[1])
    busy_us = sum(us for _, us in dev)
    return {"wall_ms_per_run": wall_us / runs / 1e3,
            "device_busy_share": busy_us / wall_us if busy_us else None,
            "top_device_ms_per_run": [(k, us / runs / 1e3) for k, us in dev[:6]]}


def _max_abs_err(outs_a, outs_b) -> int:
    """Largest |a - b| over paired integer outputs (shapes must match)."""
    err = 0
    for a, b in zip(outs_a, outs_b):
        require(a.shape == b.shape and a.dtype == b.dtype,
                f"shape/dtype mismatch {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def _exact(name: str, outs_a, outs_b) -> int:
    err = _max_abs_err(outs_a, outs_b)
    require(err == 0, f"{name}: kernel differs from its plain version "
                      f"(max abs err {err})")
    return err


def _row(name, source, replaces, launches, err, kernel, plain, library,
         bytes_moved):
    ms = time_ms(kernel)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": time_ms(plain),
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None if library is None else time_ms(library)}


def _inl_probes(eng, pats):
    """The (qhi, qlo) probe batch the engine's INL step builds for ``pats``.

    The bound values of the plan's first pattern fill its capacity, the
    rest are invalid rows (qhi INVALID, qlo 0), once per probed pid — as
    ``core/query.py::_eval_inl`` lays them out.
    """
    import torch

    ex = eng.explain(pats)["patterns"]
    first = ex[0]
    inl = next(p for p in ex if p["strategy"] == "inl")
    bound = eng.run([pats[first["pattern_index"]]])[0][:, 0]
    pids = eng._inl_pids(eng._prepare(pats)[inl["pattern_index"]][1][1])
    cap, k, dev = first["cap"], bound.shape[0], eng.device
    vals = torch.zeros(cap, dtype=torch.int32, device=dev)
    vals[:k] = torch.as_tensor(bound, device=dev)
    valid = (torch.arange(cap, device=dev) < k).repeat(len(pids))
    pid = torch.tensor(pids, dtype=torch.int32, device=dev)
    qhi = torch.where(valid, pid.repeat_interleave(cap), 2**31 - 1)
    return qhi, vals.repeat(len(pids))


def phase_kernels(kb1, kb100, launches):
    import torch
    from repro_torch.core.engine import PAPER_QUERIES
    from repro_torch.core.index import key_cols
    from repro_torch.kernels import merge_sorted as ms
    from repro_torch.kernels import ops
    from repro_torch.kernels import pair_search as ps
    from repro_torch.kernels import stream_compact as sc
    from repro_torch.utils.pair64 import pair_key

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    src = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    rows = []
    edge_checks = 0

    # -- K1 at its largest main-path call: Q2's DISTINCT keep mask at
    # LUBM-100 (join_cap slots, 512-row tiles, the answers' rows set) --
    eng = kb100.engine("litemat")
    ex = eng.explain(PAPER_QUERIES["Q2"])
    cap, n_ans = ex["join_cap"], ex["n_result_rows"]
    keep = torch.arange(cap, device=dev) < n_ans
    nb1 = sc.n_tiles(cap, 512)
    err = _exact("compact_tiles", sc.compact_tiles(keep, 512),
                 sc.compact_tiles_plain(keep, 512))
    rows.append(_row(
        "compact_tiles", src + "stream_compact.cu", ref + "stream_compact.py:208",
        launches["compact_tiles"], err,
        lambda: sc.compact_tiles(keep, 512),
        lambda: sc.compact_tiles_plain(keep, 512),
        lambda: torch.nonzero(keep), cap + 4 * nb1 * 512 + 4 * nb1))

    # -- K2 at the LUBM-100 lite store (Q1's fused scan), and K1 over a mask
    # of the same store, as a non-fused scan would give it --
    lite = kb100.lite_spo
    n = lite.shape[0]
    block = ops.auto_block(n)
    nb = sc.n_tiles(n, block)
    out_bytes = 4 * nb * block + 4 * nb
    q1 = eng._prepare(PAPER_QUERIES["Q1"])[0][1]  # (s, p, o) Terms of Q1
    q2 = eng._prepare(PAPER_QUERIES["Q2"])[0][1]
    mask = (lite[:, 1] >= q2[1].lo) & (lite[:, 1] < q2[1].hi)  # memberOf run
    _exact("compact_tiles store", sc.compact_tiles(mask, block),
           sc.compact_tiles_plain(mask, block))
    store_scan = _row(
        "compact_tiles (store-size mask)", src + "stream_compact.cu",
        ref + "stream_compact.py:208", 0, 0,
        lambda: sc.compact_tiles(mask, block),
        lambda: sc.compact_tiles_plain(mask, block),
        lambda: torch.nonzero(mask), n + out_bytes)
    params = (q1[1].lo, q1[1].hi, q1[2].lo, q1[2].hi)  # Professor types
    p, o = lite[:, 1], lite[:, 2]
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    err = _exact("masked_interval_tiles",
                 sc.masked_interval_tiles(p, o, alive, params, block),
                 sc.masked_interval_tiles_plain(p, o, alive, params, block))
    rows.append(_row(
        "masked_interval_tiles", src + "stream_compact.cu",
        ref + "stream_compact.py:250", launches["masked_interval_tiles"], err,
        lambda: sc.masked_interval_tiles(p, o, alive, params, block),
        lambda: sc.masked_interval_tiles_plain(p, o, alive, params, block),
        None, 9 * n + out_bytes))
    for m, blk in ((0, 512), (3 * 512 + 17, 512), (5 * 4096 + 1, 4096)):
        pm, om = p[:m], o[:m]
        for am in (torch.ones(m, dtype=torch.bool, device=dev),
                   torch.zeros(m, dtype=torch.bool, device=dev),
                   torch.rand(m, generator=gen, device=dev) < 0.5):
            _exact("compact_tiles edge", sc.compact_tiles(am, blk),
                   sc.compact_tiles_plain(am, blk))
            for prm in (params, (-2**31, 2**31 - 1, -2**31, 2**31 - 1)):
                _exact("masked_interval_tiles edge",
                       sc.masked_interval_tiles(pm, om, am, prm, blk),
                       sc.masked_interval_tiles_plain(pm, om, am, prm, blk))
                edge_checks += 1
            edge_checks += 1

    # -- K3 at LUBM-1's PSO store (<= INL_RESIDENT_MAX): Q3's probe batch --
    eng1 = kb1.engine("litemat")
    pso = eng1.view.dev("pso").base
    prim, sec = key_cols("pso")
    t_hi, t_lo = pso[:, prim], pso[:, sec]
    qhi, qlo = _inl_probes(eng1, PAPER_QUERIES["Q3"])
    err = _exact("pair_search", [ps.pair_search(t_hi, t_lo, qhi, qlo)],
                 [ps.pair_search_plain(t_hi, t_lo, qhi, qlo)])
    T, Q = t_hi.shape[0], qhi.shape[0]
    tkey, qkey = pair_key(t_hi, t_lo), pair_key(qhi, qlo)
    rows.append(_row(
        "pair_search", src + "pair_search.cu", ref + "pair_search.py:51",
        launches["pair_search"], err,
        lambda: ps.pair_search(t_hi, t_lo, qhi, qlo),
        lambda: ps.pair_search_plain(t_hi, t_lo, qhi, qlo),
        lambda: torch.searchsorted(tkey, qkey),
        12 * Q + 8 * min(T, Q * (math.ceil(math.log2(T)) + 1))))
    for th, tl, qh, ql in ((t_hi[:1], t_lo[:1], qhi, qlo),
                           (t_hi, t_lo, qhi[:1], qlo[:1]),
                           (t_hi, t_lo, torch.full_like(qhi, -1), qlo),
                           (t_hi, t_lo, torch.full_like(qhi, 2**31 - 1), qlo)):
        _exact("pair_search edge", [ps.pair_search(th, tl, qh, ql)],
               [ps.pair_search_plain(th, tl, qh, ql)])
        edge_checks += 1
    empty = t_hi[:0]
    require(torch.equal(ops.pair_search(empty, empty, qhi, qlo),
                        torch.zeros_like(qhi)), "empty table must give zeros")

    # -- K6 at the LUBM-100 PSO store: Q4's windowed probe run vs the table --
    pso = eng.view.dev("pso").base
    b_hi, b_lo = pso[:, prim], pso[:, sec]
    a_hi, a_lo = _inl_probes(eng, PAPER_QUERIES["Q4"])
    perm = torch.sort(pair_key(a_hi, a_lo), stable=True).indices
    pad = max(1024 - a_hi.shape[0], 0)
    fill = torch.full((pad,), 2**31 - 1, dtype=torch.int32, device=dev)
    a_hi, a_lo = torch.cat([a_hi[perm], fill]), torch.cat([a_lo[perm], fill])
    err = _exact("merge_path", [ms.merge_path(a_hi, a_lo, b_hi, b_lo)],
                 [ms.merge_path_plain(a_hi, a_lo, b_hi, b_lo)])
    na, mb = a_hi.shape[0], b_hi.shape[0]
    akey, bkey = pair_key(a_hi, a_lo), pair_key(b_hi, b_lo)
    rows.append(_row(
        "merge_path", src + "merge_path.cu", ref + "merge_sorted.py:251",
        launches["merge_path"], err,
        lambda: ms.merge_path(a_hi, a_lo, b_hi, b_lo),
        lambda: ms.merge_path_plain(a_hi, a_lo, b_hi, b_lo),
        lambda: torch.sort(torch.cat([akey, bkey]), stable=True).indices,
        12 * (na + mb)))
    # ties across runs: A holds exact copies of table keys
    tie = torch.randint(0, mb, (4096,), generator=gen, device=dev).sort().values
    for th, tl in ((b_hi[tie], b_lo[tie]), (b_hi[:1], b_lo[:1]),
                   (b_hi[:5000], b_lo[:5000])):
        _exact("merge_path edge", [ms.merge_path(th, tl, b_hi, b_lo)],
               [ms.merge_path_plain(th, tl, b_hi, b_lo)])
        _exact("merge_path edge", [ms.merge_path(b_hi, b_lo, th, tl)],
               [ms.merge_path_plain(b_hi, b_lo, th, tl)])
        edge_checks += 2

    # -- the resident branch (a run shorter than block, the TPU's K5) --
    r_hi, r_lo = a_hi[:1000].contiguous(), a_lo[:1000].contiguous()
    err5 = _exact("merge_path resident", [ms.merge_path(r_hi, r_lo, b_hi, b_lo)],
                  [ms.merge_path_plain(r_hi, r_lo, b_hi, b_lo)])
    rkey = pair_key(r_hi, r_lo)
    resident = _row(
        "merge_path (resident branch)", src + "merge_path.cu",
        ref + "merge_sorted.py:111", 0, err5,
        lambda: ms.merge_path(r_hi, r_lo, b_hi, b_lo),
        lambda: ms.merge_path_plain(r_hi, r_lo, b_hi, b_lo),
        lambda: torch.sort(torch.cat([rkey, bkey]), stable=True).indices,
        12 * (1000 + mb))
    emit({"phase": "kernels", "edge_checks": edge_checks,
          "shapes": {"compact_mask": cap, "compact_answers": n_ans,
                     "scan_rows": n, "scan_block": block,
                     "pair_search_table": T, "pair_search_queries": Q,
                     "merge_a": na, "merge_b": mb},
          "resident_branch": resident, "store_size_compaction": store_scan,
          "peak_gib": peak_gib()})
    for r in rows:
        require(r["launches"] > 0, f"{r['name']} never launched on the main path")
    emit({"kernels": rows})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core.engine  # noqa: F401  (fails outside a checkout)

    kind, count = phase_device()
    phase_build()
    zero_counts()
    kb1 = phase_lubm1()
    kb100 = phase_lubm100()
    launches = read_counts()
    phase_kernels(kb1, kb100, launches)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
