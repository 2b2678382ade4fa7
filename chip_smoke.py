#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --lm-spread N   # only the LM serving checks'
                                          # readings over N x N seeds

Run from the repository root on a machine with a CUDA device, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA.  It imports only
``repro_torch`` (never JAX or ``repro``).  Phases, each printing one JSON
line:

  1. device   — the card's name, count, and ``nvidia-smi``'s name and
                power limit (printed raw on a line of its own);
  2. build    — compiles every kernel under src/repro_torch/kernels/csrc;
  3. lubm1    — ``KnowledgeBase.build`` of LUBM-1 (seed 0): store sizes and
                Q1–Q4 answer counts in litemat and full, indexed and scan,
                and in rewrite mode (equal to litemat's and full's), against
                the reference's published numbers;
     quickstart — examples/quickstart_torch.py on the card (bernd and
                hubert in all three modes), and the N-Triples parser:
                LUBM-1's 136,826 written lines parsed back (timed, the
                same triples) and built on the card;
  4. lubm100  — LUBM-100 (seed 0): build with per-stage seconds and peak
                device memory; Q1–Q4 in litemat and full, indexed answers
                equal to scan answers, Q4's INL through the merge-path
                kernel, median of 5 warm runs per query;
  5. lubm100_rewrite — Q1–Q4 in rewrite mode at LUBM-100 (the member-
                compaction kernel over the raw store), answer sets equal to
                litemat's; cold time, medians of 5 warm runs, a profile;
     lubm100_sharded — the store in 8 shards on the card (``ShardedKB``,
                built from the same raw triples while the single store is
                still the fresh build): Q1–Q4 in litemat, full and rewrite,
                indexed and scan, equal row for row to the single store's
                with the same ``select``, Q4 through the host fold and the
                repartition combine; warm medians beside the single
                store's; the sharded QueryServer loop (256 requests in
                batches of 32, counts equal to the QueryServer's); pinned
                sharded ``query_batch`` of the type family in litemat,
                scan and rewrite (batched K1, K2, K4); the runtime, every
                outcome ok; one ledger sample with every device sync an
                error, every shard present; the live phase's insert, delete
                and compaction, rows on their subject's shard and Q1–Q4
                equal to a scratch build after each; the store freed;
     lubm100_sharded_devices — the device path: the store in shards
                over every card (8 shards sharing the one card, the
                sharded encode forced on; with several cards a shard per
                card, the automatic rule), its ``devices`` and
                ``shard_devices``: Q1–Q4 in litemat, full and rewrite
                (indexed, and scan in litemat) equal row for row to the
                single store's; Q4 through the device repartition equal to
                the host fold, nothing re-uploaded; warm medians of the
                device path beside the single store's and of Q4 through
                both combines, each card's busy share of Q4 through each;
                each card's launches in those queries (K1, K2, K4 and K5
                or K6 on every card in use); the sharded server against
                the QueryServer; the runtime's workers, every outcome ok;
                the 1% batch's host and sharded encodes timed, alternated,
                on copies of the dictionary; a 1% insert through the
                sharded dictionary encode, Q1–Q4 equal in term space to a
                scratch build; each card's peak memory; with two cards or
                more the sharded path's kernels against their plain
                versions on the last card; the store freed;
     lubm100_multiprocess — the multi-process runtime: two fresh
                interpreters of ``repro_torch.launch.distributed_smoke``
                (two processes sharing ``cuda:0`` under gloo on one card;
                two cards each under NCCL on four), each holding LUBM-100
                in 8 shards over its own cards: the topology and the
                all_reduce, Q4 through the repartition, Q1–Q4 in litemat,
                full and rewrite (and litemat's scans) equal row for row
                to the single store's,
                a sharded-encode ingest against its host-encode control,
                each child's launches of K1, K2, K4 and K5 or K6 on each of
                its cards (from what it prints: the parent's counters do
                not see the children), 200 queries by process 0 alone and
                by every process at once (q/s each, the fleet's over
                process 0 alone), each child's peak memory, and the
                validated ``fleet.json``; a child that fails or outlives
                its timeout fails the phase;
  6. lubm100_live — the live store at LUBM-100: a 1% insert of a disjoint
                university, a 0.1% delete, device compaction held bit for
                bit against host compaction, compact(), then a small insert
                whose fold takes the merge's resident branch; after each
                step Q1–Q4 in all three modes equal, in term space, a
                KnowledgeBase built from scratch on the same triples;
  7. lubm100_kernel_api — the kernels.ops entry points no query path calls,
                on LUBM-100's own data: ``pair_search`` (K3's single
                search; the INL step takes its range entry) over the PSO
                store's 11.7M strided key rows with Q4's INL probes, held
                against the windowed search; ``interval_filter`` (K9)
                and ``interval_compact`` (K8) over the lite store's p/o
                columns with Q1's Professor bounds, held against
                ``masked_interval_compact`` with every row alive;
                ``_dual_masked_compact_both`` (K7) over the raw view after
                a 64-row insert (base + delta), held against K4's streams;
                ``closure_expand`` (K11) on the full materializer's
                step-3 inputs, held against closure.py's gather; and
                ``msc_select`` (K10) on the distinct (instance, concept)
                candidates grouped by instance, held against the sort-based
                MSC of materialize.py;
  8. lubm100_serving — serving at LUBM-100 on the live store: the
                QueryServer loop of launch/serve.py (1,024 requests in
                batches of 128, class members and class-property joins;
                every distinct count equal to the engine's answer count;
                q/s, p50 and p99 per request); ``run_batch`` of three
                parameterized same-signature families in litemat (indexed
                and scan) and rewrite, every member's rows equal to its solo
                run, groups of two or more formed, the batch's wall time and
                launches beside the same members run solo; the runtime
                (launch/serve.py ``--concurrent``: 2 workers, the paper
                queries and the families, a 64-row insert stream), every
                outcome ok and no batch fallen back to solo runs; a pinned
                version unchanged across an insert and a compaction, a
                fresh pin equal to the live store;
     lubm100_telemetry — telemetry on the live store: one ledger sample
                of the store and a runtime's snapshots under
                ``torch.cuda.set_sync_debug_mode("error")`` (base at least
                the three stores, total under ``memory_allocated``, the
                store's live triples, a second sample equal); the SLO loop
                driven by hand (ok -> page under injected faults -> ok,
                the knobs lowered and restored, valid ``slo_transition``
                traces); the rollup thread every 0.05 s under the insert
                stream (every outcome ok, no tick error in 20 ticks or
                more); trace and metrics exports under build/telemetry/,
                valid alone and aggregated;
  9. kernels  — each kernel against its plain version on the card at the
                main path's shapes and on edge cases (exact equality), its
                time beside its bound, its plain version's and one PyTorch
                call's: event time (back to back, and behind a sleep
                kernel), profiler device time and host time per call, and
                for K1–K4 and K7 the ``kernels.ops``-level call (``ops_ms``;
                K1's, K2's, K4's and K7's must be one launch and, in the
                profiler, one kernel beside its memset); the batched K1, K2
                and K4 (one launch for a group's members; K2 and K4 run
                ``compact_lookback_group``, whose ``ptxas`` lines the rows
                carry, and their rows give ``store_reads``: the CTAs the
                launch ran, read back from its ticket, over its tiles) at
                the serving phase's shapes, K2 also at 16 members (nested
                in its row), beside the same members as solo calls, and on
                the batched edges of ``testing/kernel_edges.py``; then
                the ``{"kernels": [...]}`` line with the launch
                counts of the main path: every counter is zeroed just
                before each of phases 3–8 and read just after it (a
                ``window`` line each, with the launches per card), and the
                line sums the ten windows.
                The scratch builds the checks compare against run with the
                counters set back, so only the main path's launches count.
 10. lm       — the LM family, after the LUBM stores are freed (its own
                window, in which no hand-written kernel may launch):
                olmo-1b at full width and depth (bf16, remat, naive
                attention) trained by ``TrainLoop`` for 6 steps of 2 x
                4,096 tokens (losses and grad norms finite, parameters
                changed; step ms, tokens/s, the model-FLOP share of the
                H100's dense bf16 peak, peak memory, a profile of one
                step), prefilled at 4 x 4,096 (naive and blockwise, held
                to each other) and decoded 32 greedy steps (the first
                against a fresh forward over 4,097 tokens; ms a step
                beside the bytes bound; the device's busy share of an
                unprofiled step); the five LM archs' reduced configs
                (float32) on the card against their CPU runs on the same
                carried weights (each weight's AdamW update held to the
                CPU's); the resume contract (3 steps,
                a checkpoint, 3 more, equal bit for bit to 6 steps under
                deterministic algorithms); ``python -m
                repro_torch.launch.train`` as a child (exit 0, checkpoints
                valid, the last logged loss below the first).
  11. gnn      — the GNN family, after the LM (its own window, in which no
                hand-written kernel may launch): EquiformerV2 at full width
                (12 layers, C 128, l_max 6, m_max 2, 8 heads) on the
                molecule shape (128 molecules of 30 atoms and 64 edges),
                5 SGD steps at lr 1e-6 (losses finite; every weight moved
                but the |m| > 0 SO(2) weights of the first and last
                layers, which get no gradient; step ms, peak memory, the
                model-FLOP share of the float32 peak with TF32 off, a
                profile of one step), its forward on the first 4
                molecules against the CPU's on the same weights, the
                mrestrict variant (restricted rotation and bf16 edges)
                against the full rotation, and the variants' step ms;
                SchNet on the molecule shape; GAT and GatedGCN on
                full_graph_sm (Cora's shape; GAT then 100 steps at lr 0.5,
                its loss below 0.9 of the first) and on a minibatch_lg
                block (1,024 seeds, fanouts 15 and 10) that the port's
                NeighborSampler draws from a reddit-like source graph
                with its edges cut to a tenth; the four reduced archs
                against their CPU runs (forward, loss, each weight's SGD
                update); examples/train_gnn_torch.py as a child (exit 0,
                the last logged loss below the first).

Any failed check raises, so the script exits non-zero; the last line,
printed only when everything passed, is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
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


_SLEEP_CYCLES_PER_MS = []


def _sleep_cycles_per_ms() -> float:
    """``torch.cuda._sleep`` cycles per ms of device time, measured once."""
    import torch

    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10**7)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(1e7 / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def event_ms(fn, iters: int = 20, warmup: int = 3, tries: int = 4) -> float:
    """Device time per call of ``fn`` from CUDA events around calls
    enqueued behind a sleep kernel: the device starts the calls only once
    the host has enqueued all of them, so it runs them back to back and the
    events time the device work, not the host's launch cost.  The sleep
    lasts twice the measured enqueue time (1 ms at least).  The start event
    must still be pending after the last call is enqueued, the proof that
    the sleep covered them; if not, the sleep grows and the calls are cut
    to a quarter (the card holds only so many pending launches: a call of
    many small kernels fills its queue and the host waits).  ``fn`` must
    not wait for the device."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    cover_ms = max(1.0, 2e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(tries):
        torch.cuda._sleep(int(cover_ms * _sleep_cycles_per_ms()))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        cover_ms *= 2
        iters = max(1, iters // 4)
    raise AssertionError(f"no sleep covered the calls' enqueue in {tries} "
                         f"tries")


def host_us(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean host time of one call of ``fn``, in µs: ``time.perf_counter``
    around ``iters`` calls with no synchronize between them (what the
    caller's thread pays to enqueue the work)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / iters * 1e6


def device_split(fn, iters: int = 20, tries: int = 3) -> dict:
    """Device time per call of ``fn``, in ms, by kernel (or memset) name:
    torch.profiler's self device time over ``iters`` calls; empty when the
    profiler reports no device time.  The profiler now and then drops
    device events: a window in which some name ran a number of times that
    is not a multiple of ``iters`` (or nothing ran) is profiled again, up
    to ``tries`` windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    split = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        split = {e.key[:80]: e.self_device_time_total / iters / 1e3
                 for e in events}
        if events and all(e.count % iters == 0 for e in events):
            break
    return split


def device_ms(fn, iters: int = 20):
    """Device time per call of ``fn``: every kernel and memset the calls
    launch, summed; ``None`` when the profiler reports no device time."""
    return sum(device_split(fn, iters).values()) or None


def _median_ms(fn, runs: int = 5) -> float:
    """Median host time of ``runs`` calls of ``fn``, in ms."""
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()  # returns host arrays: waits for the device
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def peak_gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def nvidia_smi() -> str:
    """The cards' name and power limit as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase_device():
    import torch

    smi = nvidia_smi()
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
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(build.SOURCES), "ptxas": regs})


def ptxas_lines(log: str, *keys: str) -> dict:
    """``nvcc -Xptxas -v``'s lines on registers and spills
    (``build.BUILD_LOG``) of each kernel whose mangled name holds every one
    of ``keys``: {name: [lines]}."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            if all(k in name for k in keys):
                out[name] = []
            else:
                name = None
        elif name and ("registers" in ln or "spill" in ln):
            out[name].append(ln.strip())
    return out


def _store_reads(take, streams: int, n: int) -> float:
    """The reads of the store that the batched K2 or K4 launch which wrote
    ``take`` made: the CTAs it ran (its ticket, read back) over its tiles
    of 8,192 rows, each CTA reading one tile's rows once."""
    from repro_torch.kernels import stream_compact as sc

    return sc.launched_ctas(take, streams) / max(1, -(-n // 8192))


def _counters():
    from repro_torch.kernels import (
        closure_expand, interval_filter, merge_sorted, msc_select, ops,
        pair_search, stream_compact,
    )

    return {
        "compact_mask": stream_compact.compact_mask,
        "masked_interval_compact": stream_compact.masked_interval_compact,
        "pair_search": pair_search.pair_search,
        "pair_range": pair_search.pair_range,
        "member_compact": stream_compact.member_compact,
        "compact_mask_batched": stream_compact.compact_mask_batched,
        "masked_interval_compact_batched":
            stream_compact.masked_interval_compact_batched,
        "member_compact_batched": stream_compact.member_compact_batched,
        "merge_path_resident": merge_sorted.merge_path_resident,
        "merge_path": merge_sorted.merge_path,
        "dual_compact": stream_compact.dual_compact,
        "interval_tiles": stream_compact.interval_tiles,
        "interval_filter": interval_filter.interval_filter,
        "msc_select": msc_select.msc_select,
        "closure_expand": closure_expand.closure_expand,
    }, ops.pass_counters


def read_counts() -> dict:
    wrappers, passes = _counters()
    out = {name: fn.launches for name, fn in wrappers.items()}
    out.update({f"pass/{k}": v for k, v in passes.items()})
    return out


def zero_counts() -> None:
    from repro_torch.kernels import build, ops

    for fn in _counters()[0].values():
        fn.launches = 0
    ops.reset_pass_counters()
    build.DEVICE_LAUNCHES.clear()


def device_counts() -> dict:
    """The launches since the counters were last zeroed, per device:
    {device index: {wrapper: launches}}."""
    from repro_torch.kernels import build

    out = {}
    for (name, index), n in sorted(build.DEVICE_LAUNCHES.items()):
        out.setdefault(index, {})[name] = n
    return out


def drive(total: dict, phase, *args, need=()):
    """Run one main-path phase in its own launch window: every counter is
    zeroed just before it and read just after; the window is printed,
    each counter in ``need`` must have moved in it, and it is added to
    ``total``.  Returns the phase's result."""
    zero_counts()
    out = phase(*args)
    window = read_counts()
    emit({"window": phase.__name__, "launches": window,
          "by_device": device_counts()})
    for k in need:
        require(window[k] > 0, f"{phase.__name__} never launched {k}")
    for k, v in window.items():
        total[k] = total.get(k, 0) + v
    return out


@contextlib.contextmanager
def uncounted():
    """Set every counter back to its value on entry when the block ends:
    what a check runs on the side is no launch of the main path."""
    from repro_torch.kernels import build

    saved = read_counts()
    saved_devices = dict(build.DEVICE_LAUNCHES)
    yield
    wrappers, passes = _counters()
    for name, fn in wrappers.items():
        fn.launches = saved[name]
    for k in passes:
        passes[k] = saved[f"pass/{k}"]
    build.DEVICE_LAUNCHES.clear()
    build.DEVICE_LAUNCHES.update(saved_devices)


def _one_launch(name: str, fn, counter: str, kind,
                kernel: str = "compact_lookback") -> dict:
    """Require that the ``kernels.ops`` call ``fn`` launches ``counter``'s
    kernel once (one ``kind`` pass, unless ``kind`` is None: an entry point
    without a pass counter) and that the profiler sees that one kernel,
    whose name holds ``kernel``, and its memsets on the device, nothing
    after it; returns the call's device time by name."""
    got = launches_of(fn)
    want = {counter: 1} if kind is None else {counter: 1, f"pass/{kind}": 1}
    require(got == want,
            f"{name}: one ops call launched {got}, not one {counter}")
    split = device_split(fn)
    kernels = [k for k in split if not k.startswith("Memset")]
    require(len(kernels) == 1 and kernel in kernels[0],
            f"{name}: one ops call ran {sorted(split)} on the device")
    return split


def launches_of(fn) -> dict:
    """The launches one call makes, read inside the current window."""
    before = read_counts()
    fn()
    after = read_counts()
    return {k: after[k] - before[k] for k in after if after[k] > before[k]}


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
    from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
    from repro_torch.rdf.generator import generate_lubm

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kb = KnowledgeBase.build(generate_lubm(1, seed=0))
    build_s = time.perf_counter() - t0
    sizes = kb.sizes()
    require(sizes == LUBM1_SIZES, f"LUBM-1 sizes {sizes} != {LUBM1_SIZES}")
    counts = _all_queries(kb, LUBM1_COUNTS)
    for q, pats in PAPER_QUERIES.items():  # the paper's completeness check
        got = kb.answers(pats, mode="rewrite")
        require(len(got) == LUBM1_COUNTS[q],
                f"{q}/rewrite: {len(got)} answers, reference {LUBM1_COUNTS[q]}")
        for mode in ("litemat", "full"):
            require(got == kb.answers(pats, mode=mode),
                    f"{q}: rewrite answers differ from {mode}'s")
        counts[f"{q}/rewrite"] = len(got)
    emit({"phase": "lubm1", "seed": 0, "sizes": sizes, "answers": counts,
          "build_s": build_s, "peak_gib": peak_gib()})
    return kb


def phase_quickstart():
    """examples/quickstart_torch.py on the card, and the N-Triples parser
    at LUBM-1: the writer's text parsed back, timed, and built."""
    import importlib.util

    import torch
    from repro_torch.core.engine import KnowledgeBase
    from repro_torch.rdf.generator import generate_lubm
    from repro_torch.rdf.parser import parse_ntriples, write_ntriples

    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    t0 = time.perf_counter()
    answers = qs.run(verbose=False)
    example_s = time.perf_counter() - t0
    for mode, names in answers.items():
        require(names == ["<http://ex/bernd>", "<http://ex/hubert>"],
                f"quickstart {mode}: {names}, expected bernd and hubert")

    text = write_ntriples(generate_lubm(1, seed=0, keep_strings=True))
    t0 = time.perf_counter()
    ds, onto = parse_ntriples(text)
    parse_s = time.perf_counter() - t0
    require(ds.n_triples == LUBM1_SIZES["original"],
            f"parsed {ds.n_triples} triples, wrote "
            f"{LUBM1_SIZES['original']}")
    # the writer renders the parsed triples back in order: the same set
    require(write_ntriples(ds) == text,
            "the parsed triples differ from the written ones")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kb = KnowledgeBase.build(ds)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(kb.device.type == "cuda", "the parsed store is not on the card")
    emit({"phase": "quickstart", "answers": answers, "example_s": example_s,
          "lines": text.count("\n"), "parse_s": parse_s,
          "ontology": onto.stats(), "build_s": build_s, "sizes": kb.sizes()})


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

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counts = _all_queries(kb)  # cold: index builds and first runs included
    cold_s = time.perf_counter() - t0
    plans, medians = {}, {}
    for mode in ("litemat", "full"):
        for use_index in (True, False):
            eng = kb.engine(mode, use_index)
            for q, pats in PAPER_QUERIES.items():
                key = f"{q}/{mode}/{'index' if use_index else 'scan'}"
                if use_index:
                    plans[key] = [(p["strategy"], p["store"])
                                  for p in eng.explain(pats)["patterns"]]
                medians[key] = _median_ms(lambda: eng.run(pats))
    for mode in ("litemat", "full"):
        require(("inl", "pso") in plans[f"Q4/{mode}/index"],
                f"LUBM-100 Q4/{mode} did not plan an INL probe")
    require(kb.lite_spo.shape[0] > (1 << 20),
            "LUBM-100 store must exceed INL_RESIDENT_MAX rows")
    emit({"phase": "lubm100_queries", "answers": counts, "cold_s": cold_s,
          "plans": plans, "median_ms": medians, "peak_gib": peak_gib(),
          "profile": {f"{q}/litemat/index": _profile(
              lambda pats=PAPER_QUERIES[q]: kb.query(pats)) for q in ("Q2", "Q4")}})
    return kb, raw


def phase_lubm100_rewrite(kb):
    """Q1–Q4 in rewrite mode over the LUBM-100 raw store."""
    import torch
    from repro_torch.core.engine import PAPER_QUERIES

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    answers = {}
    for q, pats in PAPER_QUERIES.items():  # cold: raw-store scans first run
        got = kb.answers(pats, mode="rewrite")
        require(got == kb.answers(pats, mode="litemat"),
                f"LUBM-100 {q}: rewrite answers differ from litemat's")
        answers[q] = len(got)
    cold_s = time.perf_counter() - t0
    eng = kb.engine("rewrite")
    plans, medians = {}, {}
    for q, pats in PAPER_QUERIES.items():
        plans[q] = [(p["strategy"], p["store"], p["estimated_rows"],
                     p["observed_rows"]) for p in eng.explain(pats)["patterns"]]
        medians[q] = _median_ms(lambda: eng.run(pats))
    emit({"phase": "lubm100_rewrite", "answers": answers, "cold_s": cold_s,
          "plans": plans, "median_ms": medians, "peak_gib": peak_gib(),
          "profile": {f"{q}/rewrite": _profile(
              lambda pats=PAPER_QUERIES[q]: eng.run(pats)) for q in ("Q1", "Q4")}})


def _term_answers(kb, modes=("litemat", "full", "rewrite")) -> dict:
    """Q1–Q4 answers per mode as sorted fingerprint rows (term space: ids
    differ between two builds of the same triples, fingerprints do not).
    Columns are put in variable-name order: a query's default projection
    follows its plan's join order, which depends on the store's counts."""
    import numpy as np
    import torch
    from repro_torch.core.engine import PAPER_QUERIES
    from repro_torch.utils import pair64

    out = {}
    for mode in modes:
        for q, pats in PAPER_QUERIES.items():
            rows, sel = kb.query(pats, mode=mode)
            rows = np.ascontiguousarray(rows[:, np.argsort(sel)])
            ids = torch.as_tensor(rows.reshape(-1), device=kb.device)
            hi, lo, hit = kb.kb.table.extract_fp(ids)
            require(bool(hit.all()), f"{q}/{mode}: an answer id is not in "
                                     f"the dictionary")
            fps = pair64.combine_np(hi.cpu().numpy(), lo.cpu().numpy())
            fps = fps.reshape(rows.shape)
            order = np.lexsort(fps.T[::-1]) if fps.size else np.arange(0)
            out[f"{q}/{mode}"] = fps[order]
    return out


def _same_answers(kb, raw_cols, onto, what: str) -> dict:
    """Hold ``kb``'s answers against a scratch build of ``raw_cols``."""
    import numpy as np
    import torch
    from repro_torch.core.engine import KnowledgeBase
    from repro_torch.rdf.generator import RawDataset

    got = _term_answers(kb)
    with uncounted():  # the scratch build is the check's, not the main path
        scratch = KnowledgeBase.build(RawDataset(*raw_cols, onto=onto))
        want = _term_answers(scratch)
        del scratch
        torch.cuda.empty_cache()
    for key in want:
        require(np.array_equal(got[key], want[key]),
                f"{what} {key}: {got[key].shape[0]} answers, scratch build "
                f"{want[key].shape[0]}")
    return {k: int(v.shape[0]) for k, v in got.items()}


def _drop_triples(cols, gone_cols):
    """``cols`` without every copy of the triples in ``gone_cols`` — what
    ``delete`` removes (all copies of each triple)."""
    import numpy as np

    gone = set(zip(*(c.tolist() for c in gone_cols)))
    cand = np.flatnonzero(np.isin(cols[0], gone_cols[0]))
    rows = zip(*(c[cand].tolist() for c in cols))
    drop = [i for i, t in zip(cand.tolist(), rows) if t in gone]
    keep = np.ones(cols[0].shape[0], dtype=bool)
    keep[drop] = False
    return tuple(c[keep] for c in cols)


def _q4_plan(eng) -> list:
    """Q4's plan on ``eng``: (strategy, store, estimated, observed rows)."""
    from repro_torch.core.engine import PAPER_QUERIES

    return [(p["strategy"], p["store"], p["estimated_rows"], p["observed_rows"])
            for p in eng.explain(PAPER_QUERIES["Q4"])["patterns"]]


def phase_lubm100_live(kb, raw):
    """The live store at LUBM-100, with the reference bench's traffic."""
    import numpy as np
    import torch
    from repro_torch.core.delta import compact_view
    from repro_torch.core.engine import PAPER_QUERIES
    from repro_torch.core.query import QueryEngine
    from repro_torch.rdf.generator import RawDataset, generate_lubm

    torch.cuda.reset_peak_memory_stats()
    base = (raw.s, raw.p, raw.o)
    chunk = raw.n_triples // 100  # 1% of a disjoint university
    pool = generate_lubm(1, seed=7, univ_offset=1)
    batch = tuple(c[:chunk] for c in (pool.s, pool.p, pool.o))
    out = {"insert_rows": chunk}
    stats0 = {m: dict(kb.dev_cache(m).stats) for m in ("litemat", "full",
                                                       "rewrite")}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    # the overlay's own kernels: K4 (rewrite's type scan) and K3's range
    # entry (Q4's INL probe) launch on the delta bucket beside the base, so
    # one query makes more launches than it made on the base alone
    probes = {"Q1/rewrite": (lambda: kb.query(PAPER_QUERIES["Q1"],
                                              mode="rewrite"), "member_compact"),
              "Q4/litemat": (lambda: kb.query(PAPER_QUERIES["Q4"]),
                             "pair_range")}
    on_base = {q: launches_of(fn) for q, (fn, _) in probes.items()}

    # 1. insert, then serve each mode (its lazy flush) and query
    out["insert"], out["insert_s"] = timed(
        lambda: kb.insert(RawDataset(*batch, onto=raw.onto),
                          auto_compact=False))
    for mode in ("litemat", "full", "rewrite"):
        _, out[f"flush_{mode}_s"] = timed(lambda m=mode: kb.warm_device(m))
    out["transfer_rows_after_insert"] = {
        m: {k: kb.dev_cache(m).stats[k] - stats0[m][k]
            for k in ("upload_delta_rows", "upload_alive_rows",
                      "upload_base_alive_rows", "delta_allocs")}
        for m in stats0}
    for m, st in out["transfer_rows_after_insert"].items():
        require(st["upload_base_alive_rows"] == 0
                and st["upload_delta_rows"] <= 8 * 4 * chunk,
                f"{m}: the insert's device refresh is not O(delta): {st}")
    out["delta_ratio_after_insert"] = kb.delta_ratio
    on_overlay = {q: launches_of(fn) for q, (fn, _) in probes.items()}
    out["launches_base_vs_overlay"] = {q: [on_base[q], on_overlay[q]]
                                       for q in probes}
    for q, (_, k) in probes.items():
        require(on_overlay[q].get(k, 0) > on_base[q].get(k, 0),
                f"{q} never launched {k} on the delta bucket")
    grown = tuple(np.concatenate([b, d]) for b, d in zip(base, batch))
    out["answers_after_insert"] = _same_answers(kb, grown, raw.onto,
                                                "after insert")
    out["q4_plan_after_insert"] = _q4_plan(kb.engine("litemat"))

    # 2. delete 0.1% of the base, by stride
    n_del = raw.n_triples // 1000
    idx = np.arange(0, raw.n_triples, raw.n_triples // n_del)[:n_del]
    out["delete"], out["delete_s"] = timed(
        lambda: kb.delete(tuple(c[idx] for c in base), auto_compact=False))
    require(out["delete"]["n_deleted"] >= n_del, f"delete: {out['delete']}")
    out["delta_ratio_after_delete"] = kb.delta_ratio
    live = _drop_triples(grown, tuple(c[idx] for c in base))
    out["answers_after_delete"] = _same_answers(kb, live, raw.onto,
                                                "after delete")
    out["q4_plan_after_delete"] = _q4_plan(kb.engine("litemat"))

    # 3. device compaction == host compaction, bit for bit; then compact()
    for mode in ("rewrite", "litemat", "full"):
        v = kb.view(mode)
        (h_rows, h_idx), out[f"compact_host_{mode}_s"] = timed(
            lambda v=v: compact_view(v, device=False))
        (d_rows, d_idx), out[f"compact_device_{mode}_s"] = timed(
            lambda v=v: compact_view(v, device=True))
        require(torch.equal(h_rows, d_rows)
                and np.array_equal(h_idx._h, d_idx._h),
                f"{mode}: device compaction differs from host compaction")
        del h_rows, h_idx, d_rows, d_idx
    out["compact"], out["compact_s"] = timed(kb.compact)
    out["answers_after_compact"] = _same_answers(kb, live, raw.onto,
                                                 "after compact")
    out["q4_plan_after_compact"] = _q4_plan(kb.engine("litemat"))

    # 4. a small insert: its fold merges a delta bucket under the merge
    # block (1,024 rows), the branch a store taking few writes folds through
    small = tuple(c[chunk:chunk + 64] for c in (pool.s, pool.p, pool.o))
    kb.insert(RawDataset(*small, onto=raw.onto), auto_compact=False)
    out["small_delta_cap"] = int(kb.view("full").delta_cap)
    out["small_compact"], out["small_compact_s"] = timed(kb.compact)
    live = tuple(np.concatenate([c, d]) for c, d in zip(live, small))
    out["answers_after_small_compact"] = _same_answers(
        kb, live, raw.onto, "after the small compaction")

    # Q4 on the live store: the plan the KB's engine keeps after this
    # traffic and its cost, beside the plan a fresh engine would start from
    kept = kb.engine("litemat")
    out["q4_plan_kept"] = _q4_plan(kept)
    out["q4_median_ms_kept"] = _median_ms(lambda: kept.run(PAPER_QUERIES["Q4"]))
    out["q4_plan_fresh"] = _q4_plan(QueryEngine(
        kb=kb.kb, spo=kb.lite_spo, mode="litemat", dtb=kb.dtb,
        view=kb.view("litemat")))
    out["peak_gib"] = peak_gib()
    emit({"phase": "lubm100_live", **out})
    return out["small_delta_cap"]


def _pattern_vars(pats) -> tuple:
    """A query's variables in order of appearance: the select both the
    sharded and the single store answer in the same row order."""
    return tuple(dict.fromkeys(v for p in pats for v in (p.s, p.p, p.o)
                               if isinstance(v, str) and v.startswith("?")))


SHARDS = 8  # shards of a sharded store on one card


def phase_lubm100_sharded(kb, raw):
    """The sharded store at LUBM-100: 8 shards on the one card, held row
    for row against the single store ``kb`` (the fresh build of ``raw``);
    the sharded store is freed before the next phase."""
    import gc

    import torch

    out = _sharded_checks(kb, raw)
    gc.collect()  # the store and its engines refer to each other
    torch.cuda.empty_cache()
    emit({"phase": "lubm100_sharded", **out})


def _sharded_checks(kb, raw) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.engine import PAPER_QUERIES
    from repro_torch.core.shard import ShardedKB, assert_partitioned
    from repro_torch.core.snapshot import SnapshotRegistry
    from repro_torch.launch.serve import serve_batches
    from repro_torch.obs.ledger import LEDGER
    from repro_torch.rdf.generator import RawDataset, generate_lubm
    from repro_torch.serving.engine import QueryServer
    from repro_torch.serving.runtime import ServingRuntime

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    S = ShardedKB.build(raw, n_shards=SHARDS)
    torch.cuda.synchronize()
    out = {"n_shards": SHARDS, "build_s": time.perf_counter() - t0,
           "build_peak_gib": peak_gib(), "sizes": S.sizes(),
           "shard_rows": [K.sizes() for K in S.shards]}
    require(S.sizes()["original"] == kb.sizes()["original"],
            "the shards do not hold the raw store")

    # 1. Q1–Q4 x three modes x indexed/scan: row for row the single
    # store's, same select; Q4 through the repartition combine too
    t0 = time.perf_counter()
    answers = {}
    for mode in ("litemat", "full", "rewrite"):
        for use_index in (True, False):
            for q, pats in PAPER_QUERIES.items():
                key = f"{q}/{mode}/{'index' if use_index else 'scan'}"
                sel = _pattern_vars(pats)
                with uncounted():  # the single store is the check's
                    want, _ = kb.query(pats, select=sel, mode=mode,
                                       use_index=use_index)
                got, _ = S.query(pats, select=sel, mode=mode,
                                 use_index=use_index)
                require(np.array_equal(got, want),
                        f"sharded {key}: {got.shape[0]} rows, the single "
                        f"store {want.shape[0]}")
                answers[key] = int(got.shape[0])
        eng = S.engine(mode)
        eng.use_repartition_join = True
        q4 = PAPER_QUERIES["Q4"]
        host, _ = S.query(q4, select=_pattern_vars(q4), mode=mode)
        got, _ = eng.run(q4, select=_pattern_vars(q4))
        require(np.array_equal(got, host) and eng.cache_stats[
                "repartition_runs"] > 0 and eng.cache_stats[
                "exchange_faults"] == 0,
                f"Q4/{mode}: the repartition combine differs from the "
                f"host fold")
        eng.use_repartition_join = False
    out["answers"] = answers
    out["cold_s"] = time.perf_counter() - t0

    # 2. medians of 5 warm runs beside the single store's
    medians = {}
    for mode, use_index in (("litemat", True), ("litemat", False),
                            ("rewrite", True)):
        tag = f"{mode}/{'index' if use_index else 'scan'}"
        with uncounted():
            one = kb.engine(mode, use_index)
        sharded = S.engine(mode, use_index)
        for q, pats in PAPER_QUERIES.items():
            sel = _pattern_vars(pats)
            with uncounted():
                single = _median_ms(lambda: one.run(pats, select=sel))
            medians[f"{q}/{tag}"] = {
                "single": single,
                "sharded": _median_ms(lambda: sharded.run(pats, select=sel))}
    eng = S.engine("litemat")
    eng.use_repartition_join = True
    q4 = PAPER_QUERIES["Q4"]
    medians["Q4/litemat/index"]["sharded_repartition"] = _median_ms(
        lambda: eng.run(q4, select=_pattern_vars(q4)))
    eng.use_repartition_join = False
    out["median_ms"] = medians
    with uncounted():
        single = launches_of(lambda: kb.query(q4, select=_pattern_vars(q4)))
    out["launches_q4"] = {
        "single": single,
        "sharded": launches_of(lambda: S.query(q4, select=_pattern_vars(q4)))}
    require(any(out["launches_q4"]["sharded"].get(k, 0) for k in (
        "merge_path", "merge_path_resident")),
        f"the sharded Q4 never launched the merge-path kernel: "
        f"{out['launches_q4']['sharded']}")
    out["profile"] = {"Q4/litemat/index": _profile(
        lambda: S.query(q4, select=_pattern_vars(q4)))}

    # 3. the sharded QueryServer loop: counts equal the single store's
    srv = serve_batches(S, requests=256, batch=32, seed=0)
    with uncounted():  # the single store's server is the check's
        one = QueryServer(kb)
        for names, props, counts in srv["log"]:
            want = (one.class_members(names)[0] if props is None
                    else one.class_prop_join(names, props)[0])
            require(np.array_equal(counts, want),
                    "ShardedQueryServer counts differ from the "
                    "QueryServer's")
    out["query_server"] = {k: srv[k] for k in ("served", "wall_s", "qps",
                                                "p50_ms", "p99_ms")}

    # 4. pinned sharded snapshots' query_batch: each member's groups ride
    # one run_batch per shard (batched K1, K2 and K4 in litemat, scan and
    # rewrite), rows equal to the single store's
    batch = {}
    reqs = [(q, ("?x",)) for q in serving_families()["type"]]
    for mode, use_index in SERVING_MODES:
        tag = f"{mode}/{'index' if use_index else 'scan'}"
        reg = SnapshotRegistry(S, modes=(mode,), use_index=use_index)
        with reg.pin() as pin:
            got = pin.query_batch(reqs)
            for (pats, sel), (rows, _) in zip(reqs, got):
                with uncounted():
                    want, _ = kb.query(pats, select=sel, mode=mode,
                                       use_index=use_index)
                require(np.array_equal(rows, want),
                        f"sharded query_batch {tag} {pats[0].o}: rows "
                        f"differ from the single store's")
            batch[tag] = {
                "members": len(reqs),
                "batch_ms": _median_ms(lambda: pin.query_batch(reqs),
                                       runs=3),
                "solo_ms": _median_ms(lambda: [pin.query(p, select=sel)
                                               for p, sel in reqs], runs=3)}
    out["query_batch"] = batch

    # 5. the runtime over the sharded store: every outcome ok
    rt = ServingRuntime(S, modes=("litemat",), n_workers=2)
    with rt:
        outs = [rt.submit(q) for q in PAPER_QUERIES.values()]
        outs = [f.result() for f in outs]
        member = rt.class_members(["Professor", "Department"])
    bad = [o.status for o in outs + [member] if not o.ok]
    require(not bad, f"sharded runtime outcomes not ok: {bad}")
    for o, (q, pats) in zip(outs, PAPER_QUERIES.items()):
        require(len(o.answers) == answers[f"{q}/litemat/index"],
                f"sharded runtime {q}: {len(o.answers)} answers")
    out["runtime"] = {"stats": rt.stats, "latency": rt.latency_stats(),
                      "server": type(rt._server).__name__}

    # 6. one ledger sample with every device sync an error: every shard
    S.track_ledger()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        sample = LEDGER.sample()
        sample_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    shards = sample["shards"]
    for i in range(SHARDS):
        rec = shards.get(str(i), {})
        require(rec.get("components", {}).get("base", 0) > 0
                and rec.get("triples", 0) > 0,
                f"the ledger misses shard {i}: {rec}")
    require("stack" in shards, "the ledger misses the sharded store")
    out["ledger"] = {"sample_ms": sample_ms,
                     "bytes": {k: v["total"] for k, v in shards.items()},
                     "triples": {k: v["triples"] for k, v in shards.items()}}

    # 7. the live sharded store: the live phase's insert, delete and
    # compaction; after each, rows on their subject's shard and Q1–Q4 equal
    # to a scratch single build of the same triples
    base = (raw.s, raw.p, raw.o)
    chunk = raw.n_triples // 100
    pool = generate_lubm(1, seed=7, univ_offset=1)
    batch = tuple(c[:chunk] for c in (pool.s, pool.p, pool.o))

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    out["insert"], out["insert_s"] = timed(
        lambda: S.insert(RawDataset(*batch, onto=raw.onto),
                         auto_compact=False))
    assert_partitioned(S)
    grown = tuple(np.concatenate([b, d]) for b, d in zip(base, batch))
    out["answers_after_insert"] = _same_answers(S, grown, raw.onto,
                                                "sharded, after insert")
    n_del = raw.n_triples // 1000
    idx = np.arange(0, raw.n_triples, raw.n_triples // n_del)[:n_del]
    out["delete"], out["delete_s"] = timed(
        lambda: S.delete(tuple(c[idx] for c in base), auto_compact=False))
    require(out["delete"]["n_deleted"] >= n_del, f"delete: {out['delete']}")
    assert_partitioned(S)
    live = _drop_triples(grown, tuple(c[idx] for c in base))
    out["answers_after_delete"] = _same_answers(S, live, raw.onto,
                                                "sharded, after delete")
    out["compact"], out["compact_s"] = timed(S.compact)
    assert_partitioned(S)
    out["answers_after_compact"] = _same_answers(S, live, raw.onto,
                                                 "sharded, after compact")
    window = read_counts()
    require(window["merge_path"] + window["merge_path_resident"] > 0,
            "the sharded phase never launched the merge-path kernel")
    out["peak_gib"] = peak_gib()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase_lubm100_sharded_devices(kb, raw):
    """The device path at LUBM-100: the store in shards over every card
    (8 shards sharing the one card; a shard per card with several),
    held row for row against the single store ``kb`` (the fresh build of
    ``raw``); the sharded store is freed before the next phase."""
    import gc

    import torch

    out = _sharded_device_checks(kb, raw)
    gc.collect()  # the store and its engines refer to each other
    for d in _cards():
        with torch.cuda.device(d):
            torch.cuda.empty_cache()
    emit({"phase": "lubm100_sharded_devices", **out})


def _cards() -> list:
    """Every visible card, with its index."""
    import torch

    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _profile_devices(fn, runs: int = 5) -> dict:
    """Each device's busy share over ``runs`` calls of ``fn``: the summed
    self time of the device events the profiler gives that device, over
    the wall time of the window; ``None`` for a device with no time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for d in _cards():
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        for d in _cards():
            torch.cuda.synchronize(d)
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            d = f"cuda:{e.device_index}"
            busy[d] = busy.get(d, 0.0) + e.self_device_time_total
    return {"wall_ms_per_run": wall_us / runs / 1e3,
            "device_busy_share": {d: us / wall_us for d, us in
                                  sorted(busy.items())} or None}


def _sharded_device_checks(kb, raw) -> dict:
    import copy

    import numpy as np
    import torch
    from repro_torch.core.engine import PAPER_QUERIES
    from repro_torch.core.shard import (
        ShardedKB, ShardedQueryEngine, assert_partitioned,
    )
    from repro_torch.core.update import encode_delta
    from repro_torch.launch.serve import CLASSES, PROPS
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.rdf.generator import RawDataset, generate_lubm
    from repro_torch.serving.engine import QueryServer, ShardedQueryServer
    from repro_torch.serving.runtime import ServingRuntime
    from repro_torch.testing.kernel_edges import sharded_path_edges

    devices = _cards()
    count = len(devices)
    forced = count == 1  # 8 shards share the card; the encode is forced
    n_shards = SHARDS if forced else count

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    t_phase = time.perf_counter()
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    S = ShardedKB.build(raw, n_shards=n_shards, devices=devices)
    sync()
    out = {"devices": [str(d) for d in S.devices],
           "shard_devices": [str(d) for d in S.shard_devices()],
           "n_shards": n_shards, "forced": forced,
           "build_s": time.perf_counter() - t0,
           "shard_rows": [K.sizes()["original"] for K in S.shards]}
    require(S.sizes()["original"] == kb.sizes()["original"],
            "the shards do not hold the raw store")
    require(all(K.kb.spo.device == d
                for K, d in zip(S.shards, S.shard_devices())),
            "a shard's store is not on its device")

    # 1. Q1–Q4 through the device path in three modes, indexed (and scan
    # in litemat): row for row the single store's, same select
    t0 = time.perf_counter()
    answers = {}
    for mode, use_index in (("litemat", True), ("full", True),
                            ("rewrite", True), ("litemat", False)):
        eng = S.engine(mode, use_index)
        for q, pats in PAPER_QUERIES.items():
            key = f"{q}/{mode}/{'index' if use_index else 'scan'}"
            sel = _pattern_vars(pats)
            with uncounted():  # the single store is the check's
                want, _ = kb.query(pats, select=sel, mode=mode,
                                   use_index=use_index)
            got, _ = eng.run(pats, select=sel)
            require(np.array_equal(got, want),
                    f"device path {key}: {got.shape[0]} rows, the single "
                    f"store {want.shape[0]}")
            answers[key] = int(got.shape[0])
    out["answers"] = answers
    out["cold_s"] = time.perf_counter() - t0

    # 2. Q4 through the device repartition: the host fold's rows, nothing
    # re-uploaded, the group runs and the repartition counted
    q4 = PAPER_QUERIES["Q4"]
    sel4 = _pattern_vars(q4)
    rep = ShardedQueryEngine(skb=S, use_repartition_join=True)
    fold = ShardedQueryEngine(skb=S)
    uploads = REGISTRY.counter("device/transfer_bytes", src="combine_upload")
    stats0, up0 = dict(rep.cache_stats), uploads.value
    got, _ = rep.run(q4, select=sel4)
    uploaded = uploads.value - up0
    require(uploaded == 0, f"Q4 through the device repartition uploaded "
                           f"{uploaded} B")
    host, _ = fold.run(q4, select=sel4)
    require(np.array_equal(got, host), "Q4: the device repartition differs "
                                       "from the host fold")
    require(rep.cache_stats["group_runs"] > stats0["group_runs"]
            and rep.cache_stats["repartition_runs"]
            > stats0["repartition_runs"]
            and rep.cache_stats["exchange_faults"] == 0,
            f"Q4 did not take the device repartition: {rep.cache_stats}")
    out["q4"] = {"rows": int(got.shape[0]), "combine_upload_bytes": uploaded,
                 "cache_stats": dict(rep.cache_stats)}

    # 3. warm medians: the device path against the single store, in the
    # same run (the single store uncounted); Q4 through both combines
    medians = {}
    for q, pats in PAPER_QUERIES.items():
        sel = _pattern_vars(pats)
        eng = S.engine("litemat")
        with uncounted():
            one = _median_ms(lambda: kb.query(pats, select=sel))
        medians[f"{q}/litemat/index"] = {
            "device": _median_ms(lambda: eng.run(pats, select=sel)),
            "single": one}
    medians["Q4/litemat/index"]["device_repartition"] = _median_ms(
        lambda: rep.run(q4, select=sel4))
    out["median_ms"] = medians
    out["profile_q4"] = {
        "host_fold": _profile_devices(lambda: fold.run(q4, select=sel4)),
        "repartition": _profile_devices(lambda: rep.run(q4, select=sel4))}
    # every card in use launched K1, K2, K4 and K5 or K6 in the queries
    # above: only the device path has run since the counts were zeroed
    launches = device_counts()
    for d in S.devices:
        mine = launches.get(d.index, {})
        for k in ("compact_mask", "masked_interval_compact",
                  "member_compact"):
            require(mine.get(k, 0) > 0, f"{d} never launched {k}")
        require(mine.get("merge_path", 0) + mine.get(
            "merge_path_resident", 0) > 0, f"{d} never launched K5 or K6")
    out["query_launches_by_device"] = {f"cuda:{i}": v
                                       for i, v in launches.items()}

    # 4. the sharded server on the device path: the QueryServer's counts
    srv = ShardedQueryServer(S)
    names = [CLASSES[i % len(CLASSES)] for i in range(32)]
    props = [PROPS[i % len(PROPS)] for i in range(32)]
    with uncounted():
        one = QueryServer(kb)
        want = (one.class_members(names)[0],
                one.class_prop_join(names, props)[0])
    got = (srv.class_members(names)[0], srv.class_prop_join(names, props)[0])
    require(all(np.array_equal(g, w) for g, w in zip(got, want)),
            "the sharded server's device path differs from the QueryServer")

    # 5. the runtime's workers over the store: every outcome ok
    rt = ServingRuntime(S, modes=("litemat",), n_workers=2)
    with rt:
        outs = [f.result() for f in [rt.submit(p)
                                     for p in PAPER_QUERIES.values()]]
    bad = [o.status for o in outs if not o.ok]
    require(not bad, f"runtime outcomes not ok: {bad}")
    for o, q in zip(outs, PAPER_QUERIES):
        require(len(o.answers) == answers[f"{q}/litemat/index"],
                f"runtime {q}: {len(o.answers)} answers")

    # 6. the 1% batch's encode both ways on copies of the dictionary,
    # alternated: the host encode and the sharded encode
    pool = generate_lubm(1, seed=7, univ_offset=1)
    batch = tuple(c[:raw.n_triples // 100] for c in (pool.s, pool.p, pool.o))
    dyn = S._dyn
    enc_s = {"host": [], "sharded": []}
    for _ in range(3):
        for path in enc_s:
            S._dyn = copy.deepcopy(dyn)
            sync()
            t0 = time.perf_counter()
            if path == "host":
                encode_delta(S._dyn, *batch)
            else:
                S._encode_sharded(*batch)
            sync()
            enc_s[path].append(time.perf_counter() - t0)
    S._dyn = dyn
    out["encode_s"] = enc_s

    # 7. a 1% insert through the sharded dictionary encode: rows on their
    # subject's shard, and Q1–Q4 in three modes equal, in term space, to a
    # scratch single build (the host encode) of the same triples
    S.use_sharded_encode = True if forced else None
    require(S._sharded_encode_on(), "the sharded encode is off")
    encodes = REGISTRY.counter("shard/encode_runs", path="sharded")
    enc0 = encodes.value
    sync()
    t0 = time.perf_counter()
    out["insert"] = S.insert(RawDataset(*batch, onto=raw.onto),
                             auto_compact=False)
    sync()
    out["insert_s"] = time.perf_counter() - t0
    require(encodes.value == enc0 + 1, "the insert took the host encode")
    require(out["insert"]["n_new_terms"] > 0, "the insert added no term")
    assert_partitioned(S)
    grown = tuple(np.concatenate([b, d]) for b, d in
                  zip((raw.s, raw.p, raw.o), batch))
    out["answers_after_insert"] = _same_answers(
        S, grown, raw.onto, "sharded encode, after insert")
    out["peak_gib_by_device"] = {
        str(d): torch.cuda.max_memory_allocated(d) / 2**30 for d in devices}

    # 8. with two cards or more, the sharded path's kernels against their
    # plain versions on the last card, the thread's device the first
    if count > 1:
        last = devices[-1]
        torch.cuda.set_device(0)
        with uncounted():
            n_edges, names = 0, set()
            for name, run, plain in sharded_path_edges(last):
                _exact(f"{name} on {last}", run(), plain())
                n_edges, names = n_edges + 1, names | {name}
        require(torch.cuda.current_device() == 0,
                "a launch left the thread on another card")
        out["edges_on_last_device"] = {"device": str(last), "cases": n_edges,
                                       "kernels": sorted(names)}
    out["seconds"] = time.perf_counter() - t_phase
    return out


MULTIPROCESS = 2  # processes of the multi-process phase
MULTIPROCESS_QUERIES = 200  # queries in each of its throughput loops
MULTIPROCESS_TIMEOUT_S = 420  # its children are killed past this


def _child_steps(log: Path) -> dict:
    """A child's JSON lines by step."""
    return {d["step"]: d for d in (json.loads(ln) for ln in
                                   log.read_text().splitlines()
                                   if ln.startswith("{"))}


def _run_children(cmd: list, work: Path) -> list:
    """Start ``MULTIPROCESS`` fresh interpreters of ``cmd`` (process r
    with ``--process-id r``), each writing ``proc{r}.log`` under ``work``;
    wait until all have ended, one has failed, or ``MULTIPROCESS_TIMEOUT_S``
    has passed; kill any still running, and require that every one exited
    0.  Returns each child's steps."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs, logs = [], []
    try:
        for r in range(MULTIPROCESS):
            logs.append(open(work / f"proc{r}.log", "w"))
            procs.append(subprocess.Popen(
                [*cmd, "--process-id", str(r)], env=env, cwd=ROOT,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + MULTIPROCESS_TIMEOUT_S
        while (any(p.poll() is None for p in procs)
               and not any(p.returncode for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        tail = (work / f"proc{r}.log").read_text()[-4000:]
        require(p.returncode == 0,
                f"process {r} exited {p.returncode} (killed at the "
                f"{MULTIPROCESS_TIMEOUT_S} s timeout if negative):\n{tail}")
    return [_child_steps(work / f"proc{r}.log") for r in range(len(procs))]


def phase_lubm100_multiprocess(kb, raw):
    """The multi-process runtime at LUBM-100: two fresh interpreters of
    ``repro_torch.launch.distributed_smoke`` (the parent's CUDA is already
    initialized, so no fork), sharing ``cuda:0`` under gloo on one card,
    or with two cards each under NCCL on four.  Each holds the store in 8
    shards over its own cards; its Q1–Q4 in three modes (and litemat's
    scans) equal ``kb``'s
    (the fresh build of ``raw``) row for row; its launches per card, its
    throughput alone and beside the other, its peak memory and the fleet
    snapshot are read from what it writes."""
    import shutil
    import socket

    import numpy as np
    import torch
    from repro_torch.core.engine import PAPER_QUERIES
    from repro_torch.launch.distributed_smoke import ANSWER_RUNS, answers_key
    from repro_torch.obs.export import validate_metrics_snapshot

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    k = max(1, count // MULTIPROCESS)
    backend = "nccl" if MULTIPROCESS * k <= count else "gloo"
    work = ROOT / "build" / "multiprocess"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    steps = _run_children(
        [sys.executable, "-m", "repro_torch.launch.distributed_smoke",
         "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(MULTIPROCESS), "--local-devices", str(k),
         "--universities", str(LUBM_FULL), "--seed", "0",
         "--n-shards", str(SHARDS), "--answers-dir", str(work),
         "--metrics-dir", str(work / "metrics"),
         "--queries", str(MULTIPROCESS_QUERIES), "--timeout-s", "300"],
        work)
    children_s = time.perf_counter() - t_phase

    # topology, the collective, each store on its own cards
    owned = []
    for r, st in enumerate(steps):
        topo, store = st["topology"], st["store"]
        mine = topo["local_devices"]
        require(topo["backend"] == backend and topo["world"] == MULTIPROCESS,
                f"process {r}: {topo}, want {backend}")
        require(mine == [f"cuda:{(r * k + j) % count}" for j in range(k)],
                f"process {r} owns {mine}")
        require(st["collective"]["sum"] == MULTIPROCESS * k,
                f"process {r}: all_reduce summed {st['collective']}")
        require(set(store["shard_devices"]) == set(mine)
                and store["n_shards"] == SHARDS,
                f"process {r}'s shards sit on {store['shard_devices']}")
        require(store["raw_triples"] == raw.n_triples,
                f"process {r} built {store['raw_triples']} triples")
        require(store["cache_stats"]["repartition_runs"] >= 1,
                f"process {r}: Q4 took no repartition")
        require(st["sharded_encode"]["answers"]["Q1"] > 0,
                f"process {r}: the sharded-encode ingest found no Q1")
        owned.append(mine)

    # every child's Q1–Q4 in three modes, indexed, and in litemat's
    # scans: the single store's rows
    answers = {}
    files = [np.load(work / f"answers-proc{r}.npz")
             for r in range(MULTIPROCESS)]
    try:
        for mode, use_index in ANSWER_RUNS:
            for q, pats in PAPER_QUERIES.items():
                key = answers_key(q, mode, use_index)
                with uncounted():  # the single store is the check's
                    want, _ = kb.query(pats, select=_pattern_vars(pats),
                                       mode=mode, use_index=use_index)
                for r, f in enumerate(files):
                    got = f[key]
                    require(np.array_equal(got, want),
                            f"process {r} {key}: {got.shape[0]} rows, "
                            f"the single store {want.shape[0]}")
                answers[key] = int(want.shape[0])
    finally:
        for f in files:
            f.close()

    # every child launched K1, K2, K4 and K5 or K6 on each of its cards
    for r, (st, mine) in enumerate(zip(steps, owned)):
        got = st["done"]["launches_by_device"]
        for d in mine:
            per = got.get(d, {})
            for name in ("compact_mask", "masked_interval_compact",
                         "member_compact"):
                require(per.get(name, 0) > 0,
                        f"process {r} never launched {name} on {d}")
            require(per.get("merge_path", 0)
                    + per.get("merge_path_resident", 0) > 0,
                    f"process {r} never launched K5 or K6 on {d}")

    # throughput: process 0 alone, then every process at once
    alone = steps[0]["queries_alone"]
    together = [st["queries_together"] for st in steps]
    fleet_qps = (sum(t["queries"] for t in together)
                 / max(t["wall_s"] for t in together))

    # the fleet snapshot process 0 aggregated
    fleet = json.loads((work / "metrics" / "fleet.json").read_text())
    errors = validate_metrics_snapshot(fleet)
    require(not errors, f"fleet.json: {errors}")
    emit({"phase": "lubm100_multiprocess",
          "processes": MULTIPROCESS, "backend": backend,
          "local_devices": owned, "answers": answers,
          "child_seconds": [st["done"]["seconds"] for st in steps],
          "child_build_s": [st["store"]["build_s"] for st in steps],
          "child_generate_s": [st["store"]["generate_s"] for st in steps],
          "q4_cache_stats": [st["store"]["cache_stats"] for st in steps],
          "launches_by_process": [st["done"]["launches_by_device"]
                                  for st in steps],
          "qps_alone": alone["qps"],
          "qps_together": [t["qps"] for t in together],
          "cpu_s_alone": alone["cpu_s"],
          "cpu_s_together": [t["cpu_s"] for t in together],
          "fleet_qps": fleet_qps, "fleet_over_alone": fleet_qps
          / alone["qps"],
          "query_launches_alone": alone["launches_by_device"],
          "query_launches_together": [t["launches_by_device"]
                                      for t in together],
          "peak_gib_by_process": [st["done"]["peak_gib_by_device"]
                                  for st in steps],
          "fleet": {"processes": fleet["processes"],
                    "combine_runs": steps[0]["fleet"]["combine_runs"],
                    "fleet_combine_runs":
                        steps[0]["fleet"]["fleet_combine_runs"]},
          "children_s": children_s,
          "seconds": time.perf_counter() - t_phase})


def msc_groups(inst, conc, dtb):
    """K10's input from candidate (instance, concept) pairs: the distinct
    pairs grouped by instance, -1 padded to the largest group.  Returns
    (pairs int64 (inst << 31 | concept), each pair's group and rank in it,
    conc int32[G, K], bounds int32[G, K])."""
    import torch
    from repro_torch.core.materialize import INVALID, concept_bounds

    pairs = torch.unique((inst.long() << 31) | conc.long())
    u_inst, u_conc = (pairs >> 31).int(), (pairs & INVALID).int()
    first = torch.ones_like(u_inst, dtype=torch.bool)
    first[1:] = u_inst[1:] != u_inst[:-1]
    gid = torch.cumsum(first, 0) - 1
    starts = torch.nonzero(first).squeeze(1)
    rank = torch.arange(pairs.shape[0], device=pairs.device) - starts[gid]
    G, K = int(starts.shape[0]), int(rank.max()) + 1
    conc_g = torch.full((G, K), -1, dtype=torch.int32, device=pairs.device)
    bounds_g = torch.full_like(conc_g, -1)
    conc_g[gid, rank] = u_conc
    bounds_g[gid, rank] = concept_bounds(dtb, u_conc)[0]
    return pairs, gid, rank, conc_g, bounds_g


def phase_lubm100_kernel_api(kb):
    """K7–K11 through their ``kernels.ops`` entry points on LUBM-100 data;
    returns the inputs the kernel rows time them on."""
    import torch
    from repro_torch.core.engine import PAPER_QUERIES
    from repro_torch.core.index import key_cols, pow2_bucket
    from repro_torch.core.materialize import (
        INVALID, _search, candidate_types,
    )
    from repro_torch.core.materialize import msc_select as msc_sorted
    from repro_torch.core.query import (
        QueryEngine, _dual_masked_compact_both, _stitch_compact,
    )
    from repro_torch.kernels import ops
    from repro_torch.kernels.stream_compact import member_masks
    from repro_torch.rdf.generator import RawDataset, generate_lubm

    t0 = time.perf_counter()
    out, inputs = {}, {}

    # K3's single search (ops.pair_search; the INL step takes the range
    # entry) on LUBM-100's PSO key planes, 11.7M strided rows, with Q4's
    # INL probes, held against the windowed search the INL step runs on a
    # table this large.  A fresh engine plans Q4's INL, as phase_kernels'
    with uncounted():  # the probes' set-up and the check are not the path
        fresh = QueryEngine(kb=kb.kb, spo=kb.lite_spo, mode="litemat",
                            dtb=kb.dtb, view=kb.view("litemat"))
        qhi, qlo = _inl_probes(fresh, PAPER_QUERIES["Q4"])
        prim, sec = key_cols("pso")
        pso = fresh.view.dev("pso").base
        want = ops.pair_search_windowed(pso[:, prim], pso[:, sec], qhi, qlo)
    got = ops.pair_search(pso[:, prim], pso[:, sec], qhi, qlo)
    require(torch.equal(got, want),
            "pair_search differs from pair_search_windowed on LUBM-100")
    out["pair_search"] = {"table": int(pso.shape[0]),
                          "queries": int(qhi.shape[0])}

    # K9 and K8 over the lite store's p/o columns, with the bounds of Q1's
    # (?x rdf:type Professor) from the port's TBox intervals
    lite = kb.lite_spo
    n = lite.shape[0]
    p, o = lite[:, 1], lite[:, 2]
    q1 = kb.engine("litemat")._prepare(PAPER_QUERIES["Q1"])[0][1]
    params = (q1[1].lo, q1[1].hi, q1[2].lo, q1[2].hi)
    block = ops.auto_block(n)
    mask = ops.interval_filter(p, o, params)
    n_hit = int(mask.sum())
    cap = pow2_bucket(n_hit)
    take, ok, total = ops.interval_compact(p, o, params, cap, block=block)
    with uncounted():
        w_take, _, w_total = ops.masked_interval_compact(
            p, o, torch.ones(n, dtype=torch.bool, device=kb.device), params,
            cap, block=block)
    require(torch.equal(take, w_take) and int(total) == int(w_total),
            "interval_compact differs from masked_interval_compact with "
            "every row alive")
    require(int(total) == n_hit and torch.equal(
        take[ok].long(), torch.nonzero(mask).squeeze(1)),
        "interval_filter's mask differs from interval_compact's take")
    out["interval"] = {"rows": n, "params": params, "matches": n_hit,
                       "cap": cap, "block": block}
    inputs["interval"] = (p, o, params, block)

    # K7 through _dual_masked_compact_both over the raw view: base + the
    # delta of a 64-row insert, with the member masks of Q1's Professor
    pool = generate_lubm(1, seed=7, univ_offset=1)
    kb.insert(RawDataset(*(c[-64:] for c in (pool.s, pool.p, pool.o)),
                         onto=pool.onto), auto_compact=False)
    ds = kb.view("rewrite").dev("scan")
    require(ds.delta is not None, "the 64-row insert left no delta bucket")
    tid, mem, dom, rng, has_dom, has_rng = _rewrite_sets(
        kb.engine("rewrite"), PAPER_QUERIES["Q1"])
    require(has_rng, "Q1's Professor has no range branch")
    ms_b, mo_b = member_masks(ds.base[:, 0], ds.base[:, 1], ds.base[:, 2],
                              ds.base_alive, tid, mem, dom, rng, has_dom,
                              has_rng)
    ms_d, mo_d = member_masks(ds.delta[:, 0], ds.delta[:, 1], ds.delta[:, 2],
                              ds.delta_alive, tid, mem, dom, rng, has_dom,
                              has_rng)
    cap7 = pow2_bucket(max(int(ms_b.sum() + ms_d.sum()),
                           int(mo_b.sum() + mo_d.sum())))
    got = _dual_masked_compact_both(ds, ms_b, mo_b, ms_d, mo_d, cap7)
    base_n = ds.base.shape[0]
    with uncounted():
        k4_b = ops.rewrite_member_compact(
            ds.base, ds.base_alive, tid, mem, dom, rng, cap7, has_dom,
            has_rng, block=ops.auto_block(base_n))
        k4_d = ops.rewrite_member_compact(
            ds.delta, ds.delta_alive, tid, mem, dom, rng, cap7, has_dom,
            has_rng, block=ops.auto_block(ds.delta.shape[0]))
    want = (_stitch_compact(k4_b[0], k4_b[2], k4_d[0], k4_d[2], base_n, cap7),
            _stitch_compact(k4_b[3], k4_b[5], k4_d[3], k4_d[5], base_n, cap7))
    for stream, g3, w3 in zip(("subject", "object"), got, want):
        require(all(torch.equal(g, w) for g, w in zip(g3, w3)),
                f"_dual_masked_compact_both's {stream} stream differs from "
                f"K4's")
    out["dual"] = {"base_rows": base_n, "delta_rows": int(ds.delta.shape[0]),
                   "subject": int(got[0][2]), "object": int(got[1][2]),
                   "cap": cap7}
    inputs["dual"] = (ms_b, mo_b, cap7)

    # K11 on the full materializer's step-3 inputs: every candidate type of
    # the raw store, the sorted concept ids and their ancestor rows
    dtb = kb.dtb
    inst, conc, explicit = candidate_types(kb.kb.spo, dtb)
    cvalid = inst != INVALID
    c_inst, c_conc = inst[cvalid], conc[cvalid]
    anc = ops.closure_expand(c_conc, dtb.concept_sorted_ids,
                             dtb.concept_ancestors)
    cpos, chit = _search(dtb.concept_sorted_ids, c_conc)
    require(torch.equal(anc, torch.where(chit[:, None],
                                         dtb.concept_ancestors[cpos], -1)),
            "closure_expand differs from closure.py's ancestor gather")
    out["closure"] = {"candidates": int(c_conc.shape[0]),
                      "concepts": int(dtb.concept_sorted_ids.shape[0]),
                      "depth": int(dtb.concept_ancestors.shape[1]),
                      "known": int(chit.sum())}
    inputs["closure"] = (c_conc, dtb.concept_sorted_ids, dtb.concept_ancestors)
    del anc, cpos, chit

    # K10 on the distinct (instance, concept) candidates, grouped by
    # instance and -1 padded to the largest group
    pairs, gid, rank, conc_g, bounds_g = msc_groups(c_inst, c_conc, dtb)
    G, K = conc_g.shape
    keep = ops.msc_select(conc_g, bounds_g)
    kept = pairs[keep[gid, rank]]
    inst_s, conc_s, keep_s = msc_sorted(inst, conc, explicit, dtb)[:3]
    kept_sorted = (inst_s[keep_s].long() << 31) | conc_s[keep_s].long()
    spills = int((dtb.concept_spill_lo < dtb.concept_spill_hi).sum())
    out["msc"] = {"groups": G, "K": K, "slots": G * K,
                  "pairs": int(pairs.shape[0]),
                  "padding_share": 1 - pairs.shape[0] / (G * K),
                  "kept": int(kept.shape[0]),
                  "kept_sorted": int(kept_sorted.shape[0]),
                  "spill_intervals": spills}
    if spills == 0:  # without spills both MSCs keep the same pairs
        require(torch.equal(kept, kept_sorted),
                f"msc_select keeps {kept.shape[0]} pairs, the sort-based MSC "
                f"{kept_sorted.shape[0]}")
    else:  # K10 has no spill test: it may keep more than the sort-based MSC
        out["msc"]["differs"] = "the pairs kept" if not torch.equal(
            kept, kept_sorted) else "nothing"
    inputs["msc"] = (conc_g, bounds_g)
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "lubm100_kernel_api", **out})
    return inputs


SERVING_CLASSES_Q4 = ["Chair", "Dean", "FullProfessor", "AssociateProfessor",
                      "AssistantProfessor", "Lecturer"]
# launch/serve.py's ten classes and six more of the LUBM TBox: a batch of
# the runtime's max_batch (16) ``(?x rdf:type C)`` requests
SERVING_CLASSES_16 = ["FullProfessor", "AssociateProfessor",
                      "AssistantProfessor", "Lecturer",
                      "UndergraduateStudent", "University"]


def serving_families():
    """The parameterized same-signature request families of the serving
    phase: ``(?x rdf:type C)`` and ``(?x rdf:type C) (?x memberOf ?y)``
    over launch/serve.py's classes, and the Q4 shape over professors."""
    from repro_torch.core.query import Pattern
    from repro_torch.launch.serve import CLASSES

    return {
        "type": [[Pattern("?x", "rdf:type", c)] for c in CLASSES],
        "type_member": [[Pattern("?x", "rdf:type", c),
                         Pattern("?x", "memberOf", "?y")] for c in CLASSES],
        "q4": [[Pattern("?x", "rdf:type", c),
                Pattern("?y", "rdf:type", "Department"),
                Pattern("?x", "worksFor", "?y")] for c in SERVING_CLASSES_Q4],
    }


SERVING_MODES = (("litemat", True), ("litemat", False), ("rewrite", True))


def _batch_size_max(mode: str) -> float:
    from repro_torch.obs.metrics import REGISTRY

    return REGISTRY.histogram("query/batch_size", mode=mode).summary().get(
        "max", 0)


def phase_lubm100_serving(kb, raw):
    """Serving at LUBM-100: the QueryServer loop, ``run_batch`` on
    parameterized same-signature families in litemat (indexed and scan)
    and rewrite, and the snapshot-isolated runtime under an insert stream."""
    import argparse

    import numpy as np
    import torch
    from repro_torch.core.engine import PAPER_QUERIES
    from repro_torch.core.query import Pattern
    from repro_torch.core.snapshot import SnapshotRegistry
    from repro_torch.kernels import stream_compact as sc
    from repro_torch.launch.serve import run_concurrent, serve_batches

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {}

    # -- 1. the QueryServer loop: launch/serve.py's traffic; every distinct
    # count equals the solo engine's answer count --
    srv = serve_batches(kb, requests=1024, batch=128, seed=0)
    expect = {}
    for names, props, counts in srv["log"]:
        for i, c in enumerate(names):
            key = (c, None if props is None else props[i])
            if key not in expect:
                pats = [Pattern("?x", "rdf:type", c)]
                if key[1] is not None:
                    pats.append(Pattern("?x", key[1], "?y"))
                expect[key] = int(kb.query(pats, select=("?x",))[0].shape[0])
            require(int(counts[i]) == expect[key],
                    f"QueryServer {key}: {int(counts[i])} distinct, the "
                    f"engine answers {expect[key]}")
    out["query_server"] = {k: srv[k] for k in ("served", "wall_s", "qps",
                                                "p50_ms", "p99_ms")}
    out["query_server"]["checked_keys"] = len(expect)

    # -- 2. run_batch on same-signature families: batched == solo, groups
    # of two or more in every mode, and the batch's wall and launches
    # beside the same members run solo --
    fams = serving_families()
    batch = {}
    for mode, use_index in SERVING_MODES:
        tag = f"{mode}/{'index' if use_index else 'scan'}"
        reg = SnapshotRegistry(kb, modes=(mode,), use_index=use_index)
        max0 = _batch_size_max(mode)
        with reg.pin() as pin:
            eng = pin.snapshot.engine(mode)
            for fam, qs in fams.items():
                reqs = [(q, None) for q in qs]
                got = pin.query_batch(reqs, mode=mode)
                for q, (rows, _) in zip(qs, got):
                    want, _ = pin.query(q, mode=mode)
                    require(np.array_equal(rows, want),
                            f"run_batch {tag} {fam} {q[0].o}: batched rows "
                            f"differ from the solo run's")
                groups = sorted(k[-1] for k in eng._exec_cache
                                if isinstance(k, tuple) and k[0] == "bexec")
                torch.cuda.synchronize()
                solo_launch = launches_of(lambda: [pin.query(q, mode=mode)
                                                   for q in qs])
                batch_launch = launches_of(
                    lambda: pin.query_batch(reqs, mode=mode))
                batch[f"{tag}/{fam}"] = {
                    "members": len(qs), "answers": [int(r.shape[0])
                                                    for r, _ in got],
                    "batch_ms": _median_ms(
                        lambda: pin.query_batch(reqs, mode=mode), runs=3),
                    "solo_ms": _median_ms(
                        lambda: [pin.query(q, mode=mode) for q in qs], runs=3),
                    "batch_launches": batch_launch,
                    "solo_launches": solo_launch}
            batch[f"{tag}/bexec_groups"] = groups
        require(_batch_size_max(mode) >= 2 and _batch_size_max(mode) >= max0,
                f"run_batch {tag}: no group of two or more members formed")
    out["run_batch"] = batch

    # -- 3. the runtime: 2 workers, the paper queries and the families,
    # a background 64-row insert stream; every outcome ok, no batch fell
    # back to solo.  128 requests: an outcome's answers are a Python set
    # of row tuples (the reference's contract), and the families' large
    # classes answer a million rows each, ~0.5 s of host time a request
    # (scripts/serving_diag.py) --
    queries = list(PAPER_QUERIES.values()) + [q for qs in fams.values()
                                              for q in qs]
    args = argparse.Namespace(workers=2, max_queue=136, deadline_s=None,
                              requests=128, seed=0)
    b0 = sc.compact_mask_batched.launches
    conc = run_concurrent(kb, raw, args, queries=queries)
    rt = conc["runtime"]
    bad = [o.status for o in conc["outcomes"] if not o.ok]
    require(not bad, f"runtime outcomes not ok: {sorted(set(bad))}")
    fallback = {r: rt.metrics.counter_value("serving/batch_fallback",
                                            reason=r)
                for r in ("batch_error", "member_fault")}
    require(sum(fallback.values()) == 0,
            f"the runtime fell back to solo runs: {fallback}")
    require(sc.compact_mask_batched.launches > b0,
            "the runtime's batches launched no batched kernel")
    out["runtime"] = {"stats": conc["stats"], "latency": conc["latency"],
                      "batch_fallback": fallback,
                      "batched_k1_launches":
                          sc.compact_mask_batched.launches - b0,
                      "versions": len({o.version for o in conc["outcomes"]})}

    # -- 4. isolation: a pinned version answers as before an insert and a
    # compaction; a fresh pin answers as the live store --
    reg = rt.registry
    paper = list(PAPER_QUERIES.values())
    s, p, o = np.asarray(raw.s), np.asarray(raw.p), np.asarray(raw.o)
    with reg.pin() as pinned:
        before = [pinned.query(q)[0] for q in paper]
        rt.insert((s[:64], p[:64], o[:64]), auto_compact=False)
        rt.compact()
        for q, rows in zip(paper, before):
            require(np.array_equal(pinned.query(q)[0], rows),
                    "a pinned version's answers moved across an insert "
                    "and a compaction")
        with reg.pin() as fresh:
            require(fresh.version == kb.version != pinned.version,
                    "a fresh pin is not at the live version")
            for q in paper:
                require(np.array_equal(fresh.query(q)[0], kb.query(q)[0]),
                        "a fresh pin's answers differ from the live KB's")
    out["isolation"] = {"pinned_version": pinned.version,
                        "live_version": kb.version}
    out["seconds"] = time.perf_counter() - t_phase
    out["peak_gib"] = peak_gib()
    emit({"phase": "lubm100_serving", **out})


def phase_lubm100_telemetry(kb, raw):
    """Telemetry at LUBM-100 on the live store: the device-memory ledger
    (sampled under the sync-debug mode "error"), the SLO loop driven by
    hand (ok -> page -> ok), the rollup thread live under the insert
    stream, and the trace and metrics exports."""
    import threading

    import torch
    from repro_torch.launch.serve import insert_stream
    from repro_torch.obs.aggregate import aggregate
    from repro_torch.obs.export import (export_mergeable_metrics,
                                        export_traces,
                                        validate_metrics_snapshot,
                                        validate_trace)
    from repro_torch.obs.ledger import LEDGER
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.runtime import ServingRuntime
    from repro_torch.testing import faults

    t_phase = time.perf_counter()
    out = {}
    q4s = serving_families()["q4"]
    q4 = q4s[0]

    # -- 1. the ledger: the store and the runtime's snapshots; a sample is
    # metadata only, so it runs with every device sync an error --
    tracer = Tracer()
    rt = ServingRuntime(kb, max_queue=32, tracer=tracer)
    mon = rt.enable_slo_control(interval_s=60.0, fast_window=2,
                                slow_window=4, min_events=4)
    rt.start()
    try:
        require(rt.serve(q4).ok, "the warm-up Q4 request failed")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            s1 = LEDGER.sample()
            sample_ms = (time.perf_counter() - t0) * 1e3
            s2 = LEDGER.sample()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        allocated = torch.cuda.memory_allocated()
        comps = s1["shards"]["0"]["components"]
        stores = sum(t.nbytes for t in (kb.kb.spo, kb.lite_spo, kb.full_spo))
        require(comps["base"] >= stores,
                f"ledger base {comps['base']} B < the three stores' "
                f"{stores} B")
        require(s1["total_bytes"] <= allocated,
                f"ledger total {s1['total_bytes']} B > memory_allocated "
                f"{allocated} B")
        require(s1["shards"]["0"]["triples"] == kb.n_live_triples(),
                "ledger triples differ from the store's live triples")
        require(s2["total_bytes"] == s1["total_bytes"],
                "a second ledger sample gave other bytes")
        out["ledger"] = {
            "hbm_bytes": {sh: r["components"]
                          for sh, r in s1["shards"].items()},
            "live_triples": REGISTRY.gauge_value("store/live_triples",
                                                 shard="0"),
            "bytes_per_triple": REGISTRY.gauge_value(
                "store/bytes_per_triple"),
            "total_bytes": s1["total_bytes"], "stores_bytes": stores,
            "memory_allocated": allocated,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "sample_ms": sample_ms, "sync_debug_mode": "error"}

        # -- 2. the SLO loop by hand: healthy, injected overload (every
        # execute faults, 10 ms deadlines), healthy again --
        tick = rt._slo_rollup.tick
        b0, w0 = rt.admission_bound, rt.batch_window_s
        legs, burns = {}, {}
        t0 = time.perf_counter()
        for _ in range(12):
            require(rt.serve(q4).ok, "a healthy Q4 request failed")
        tick(); tick()
        require(mon.state == "ok", f"healthy traffic left SLO {mon.state}")
        legs["ok_s"] = time.perf_counter() - t0
        burns["ok"] = mon.detail
        t0 = time.perf_counter()
        with faults.inject() as inj:
            inj.arm("serving.execute", times=0)
            for _ in range(4):
                for _ in range(10):
                    rt.serve(q4, deadline_s=0.01)
                tick()
        legs["page_s"] = time.perf_counter() - t0
        burns["page"] = mon.detail
        require(mon.state == "page", f"overload left SLO {mon.state}")
        paged = {"admission_bound": rt.admission_bound,
                 "batch_window_s": rt.batch_window_s}
        require(rt.admission_bound < b0 and rt.batch_window_s > w0,
                f"page did not retune the knobs: {paged}")
        t0 = time.perf_counter()
        for _ in range(6):
            for _ in range(8):
                require(rt.serve(q4).ok, "a recovery Q4 request failed")
            tick()
        legs["recover_s"] = time.perf_counter() - t0
        burns["recovered"] = mon.detail
        require(mon.state == "ok", f"recovery left SLO {mon.state}")
        require(rt.admission_bound == b0 and rt.batch_window_s == w0,
                "recovery did not restore the knobs")
    finally:
        rt.stop()
    trans = [t for t in tracer.finished_traces()
             if t.root.name == "slo_transition"]
    require(len(trans) >= 2, f"{len(trans)} slo_transition traces")
    for t in trans:
        errs = validate_trace(t.to_dict())
        require(not errs, f"invalid slo_transition trace: {errs}")
    out["slo"] = {
        "transitions": [(t.root.attrs["frm"], t.root.attrs["to"],
                         t.root.attrs["admission_bound"],
                         t.root.attrs["batch_window_s"]) for t in trans],
        "knobs": {"constructed": {"admission_bound": b0,
                                  "batch_window_s": w0}, "page": paged},
        "burn": burns, "leg_s": legs}

    # -- 3. the rollup thread live: 2 workers, Q4-shaped requests in waves
    # of four while launch/serve.py's 64-row insert stream writes --
    rt2 = ServingRuntime(kb, n_workers=2)
    rt2.enable_slo_control(interval_s=0.05)
    roll = rt2._slo_rollup
    ticks = [0]
    raw_tick = roll.tick

    def counted():
        ticks[0] += 1
        return raw_tick()

    roll.tick = counted
    outcomes = []
    t0 = time.perf_counter()
    with rt2:
        stop = threading.Event()
        w = insert_stream(rt2, raw, seed=1, stop=stop)
        try:
            while ((len(outcomes) < 64 or ticks[0] < 20)
                   and time.perf_counter() - t0 < 60):
                futs = [rt2.submit(q4s[(len(outcomes) + i) % len(q4s)])
                        for i in range(4)]
                outcomes += [f.result() for f in futs]
        finally:
            stop.set()
            w.join()
        rt2.compact()  # later phases read a delta-free store, as before
    live_s = time.perf_counter() - t0
    bad = sorted({o.status for o in outcomes if not o.ok})
    require(not bad, f"rollup leg outcomes not ok: {bad}")
    tick_errors = rt2.metrics.counter_value("rollup/tick_errors")
    require(ticks[0] >= 20, f"the rollup thread ticked {ticks[0]} times")
    require(tick_errors == 0, f"rollup/tick_errors = {tick_errors}")
    out["rollup"] = {"ticks": ticks[0], "tick_errors": tick_errors,
                     "requests": len(outcomes), "seconds": live_s,
                     "updates": rt2.stats["updates"],
                     "versions": len({o.version for o in outcomes}),
                     "latency": {st: rt2.latency_stats(st)
                                 for st in sorted({o.status
                                                   for o in outcomes})},
                     "slo_state": rt2._slo_monitor.state,
                     "sizes": kb.sizes()}

    # -- 4. exports: traces and both runtimes' mergeable metrics, valid
    # alone and aggregated --
    exp = ROOT / "build" / "telemetry"
    exp.mkdir(parents=True, exist_ok=True)
    n_traces = export_traces(tracer, str(exp / "traces.json"))
    doc = json.loads((exp / "traces.json").read_text())
    errs = [e for t in doc["traces"] for e in validate_trace(t)]
    require(not errs, f"exported traces invalid: {errs[:3]}")
    snaps = [export_mergeable_metrics(r.metrics, str(exp / f"m{i}.json"),
                                      process=str(i))
             for i, r in enumerate((rt, rt2))]
    for i in range(2):
        errs = validate_metrics_snapshot(
            json.loads((exp / f"m{i}.json").read_text()))
        require(not errs, f"exported metrics m{i} invalid: {errs[:3]}")
    fleet = aggregate(snaps)
    (exp / "fleet.json").write_text(json.dumps(fleet))
    errs = validate_metrics_snapshot(fleet)
    require(not errs, f"aggregated metrics invalid: {errs[:3]}")
    out["export"] = {"dir": str(exp.relative_to(ROOT)), "traces": n_traces,
                     "histograms": [len(sn["histograms"]) for sn in snaps],
                     "fleet_schema": fleet["schema"]}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "lubm100_telemetry", **out})


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
            "top_device_ms_per_run": [(k[:120], us / runs / 1e3)
                                      for k, us in dev[:6]]}


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
         bytes_moved, ops=None, ops_library=None):
    """One kernel row: ``ms`` (CUDA events around back-to-back calls: the
    larger of the device time and the wrapper's host cost per call),
    ``event_ms`` (CUDA events around calls enqueued behind a sleep kernel:
    the device time alone), ``device_ms`` (the profiler's device time per
    call) and ``host_us`` (enqueue time per call), each for the library
    call too but ``event_ms``; ``ops_ms``
    times the ``kernels.ops``-level call the main path makes around the
    kernel, ``ops_library_ms`` the same function in library calls (K1's
    plain version is already that: ``torch.nonzero`` and a cut)."""
    split = device_split(kernel)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": time_ms(kernel), "event_ms": event_ms(kernel),
           "device_ms": sum(split.values()) or None,
           "host_us": host_us(kernel), "plain_ms": time_ms(plain),
           "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes",
           "library_ms": None if library is None else time_ms(library)}
    if len(split) > 1:  # more than one kernel, or a memset beside it
        row["device_split"] = split
    if library is not None:
        row["library_device_ms"] = device_ms(library)
        row["library_host_us"] = host_us(library)
    if ops is not None:
        row["ops_ms"] = time_ms(ops)
    if ops_library is not None:
        row["ops_library_ms"] = time_ms(ops_library)
    return row


def _entry_check_us(calls: dict, device, rounds: int = 21,
                    iters: int = 100) -> dict:
    """``build.Entry``'s device check (the thread's device read, and
    switched to the tensors' card where it differs), against the launch
    on the current stream of the tensors' device without it, as before
    launches ran under their device.  ``preamble_us``: the host µs a call
    of an entry whose C function is a no-op, each way, ``timeit`` over
    200,000 calls, 5 alternations: the check alone.  Per wrapper in
    ``calls``: ``host_us`` of ``rounds`` windows of ``iters`` calls each
    way, the order swapped every round, in this one process, with the
    median and quartiles of the per-round differences."""
    import timeit

    from repro_torch.kernels import build

    shipped = build.Entry.__call__

    def unchecked(self, device, *args):
        err = self._fn(*args, build.stream(device))
        if err:
            raise RuntimeError(f"CUDA launch of {self.symbol} failed with "
                               f"error {err}")

    def swap(fn, checked: bool):
        build.Entry.__call__ = shipped if checked else unchecked
        try:
            return fn()
        finally:
            build.Entry.__call__ = shipped

    noop = build.Entry("noop", "noop", [])
    noop._fn = lambda *args: 0
    pre = {True: [], False: []}
    for _ in range(5):
        for checked in (True, False):
            pre[checked].append(swap(lambda: timeit.timeit(
                lambda: noop(device, 1, 2), number=200_000) / 0.2, checked))
    out = {"preamble_us": {"shipped": min(pre[True]),
                           "unchecked": min(pre[False]),
                           "check": min(pre[True]) - min(pre[False])}}
    for name, fn in calls.items():
        times, diff = {True: [], False: []}, []
        for r in range(rounds):
            for checked in ((True, False) if r % 2 == 0 else (False, True)):
                times[checked].append(swap(lambda: host_us(fn, iters=iters),
                                           checked))
            diff.append(times[True][-1] - times[False][-1])
        q = statistics.quantiles(diff, n=4)
        out[name] = {"shipped_us": statistics.median(times[True]),
                     "unchecked_us": statistics.median(times[False]),
                     "check_us": statistics.median(diff),
                     "check_us_quartiles": [q[0], q[2]]}
    return out


def _searchsorted_ranges(tkey, qhi, qlo, valid):
    """``query._inl_ranges``' function in library calls: two
    ``torch.searchsorted`` over the int64 pair keys (the yardstick of the
    ops-level K3 time)."""
    import torch
    from repro_torch.utils.pair64 import pair_key

    starts = torch.searchsorted(tkey, pair_key(qhi, qlo))
    ends = torch.searchsorted(tkey, pair_key(qhi, qlo + 1))
    lens = torch.where(valid, (ends - starts).clamp(min=0), 0)
    return starts.to(torch.int32), lens.to(torch.int32)


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


def _rewrite_sets(eng, pats):
    """(tid, mem, dom, rng, has_dom, has_rng) of a rewrite type pattern."""
    sig, dyn, _ = eng._lower(*eng._prepare(pats)[0])
    return (dyn["tid"], dyn["o"], dyn["dom"], dyn["rng"], sig.extra_caps[2],
            sig.extra_caps[3])


def _plan_cap(eng, pats) -> int:
    """The capacity ``eng``'s plan gives the first pattern of ``pats``."""
    return next(e["cap"] for e in eng.explain(pats, execute=False)["patterns"]
                if e["pattern_index"] == 0)


def _id_set(ids, cap, dev):
    import torch

    out = torch.full((cap,), 2**31 - 1, dtype=torch.int32, device=dev)
    ids = torch.unique(ids.to(torch.int32))
    out[: ids.shape[0]] = ids
    return out


def _largest_group(eng, qs):
    """The plans of the largest same-signature group of ``qs`` in ``eng``."""
    groups = {}
    for q in qs:
        pl = eng._plan(q, None)
        groups.setdefault((pl[0], pl[4]), []).append(pl)
    return max(groups.values(), key=len)


def _batched_args(kb, classes=None, keys=("k1", "k2", "k4")):
    """The batched K1, K2 and K4 calls (``keys``) at the serving phase's
    shapes: the ``(?x rdf:type C)`` family's DISTINCT keep masks (litemat,
    indexed: each member's answers set), its fused scan over the lite store
    (litemat scan: each member's bounds) and its largest rewrite group's
    member sets over the raw store, each at the caps ``_batch_caps`` gives
    the group; the family over ``classes`` (default: launch/serve.py's)."""
    import torch
    from repro_torch.core.query import Pattern, QueryEngine, _stack_dyn

    qs = serving_families()["type"] if classes is None else [
        [Pattern("?x", "rdf:type", c)] for c in classes]
    dev = kb.device
    out = {}
    if "k1" in keys:
        eng = QueryEngine(kb=kb.kb, spo=kb.lite_spo, mode="litemat",
                          dtb=kb.dtb, view=kb.view("litemat"))
        plans = _largest_group(eng, qs)
        caps, join_cap = eng._batch_caps(plans)
        counts = torch.tensor([eng._run_planned(pl)[0].shape[0]
                               for pl in plans], device=dev)
        out["k1"] = (torch.arange(caps[0], device=dev)[None, :]
                     < counts[:, None], join_cap)
    for mode, key in (("litemat", "k2"), ("rewrite", "k4")):
        if key not in keys:
            continue
        eng = QueryEngine(kb=kb.kb, spo=kb._base_store(mode), mode=mode,
                          dtb=kb.dtb, view=kb.view(mode),
                          use_index=mode == "rewrite")
        plans = _largest_group(eng, qs)
        sig = plans[0][0][0]
        caps, _ = eng._batch_caps(plans)
        dyn = _stack_dyn(sig, [pl[1][0] for pl in plans], dev)
        base = eng.view.dev("scan")
        require(base.delta is None, f"{mode}: the scan view holds a delta")
        if key == "k2":
            require(sig.fused, "the type family's scan is not fused")
            out[key] = (base.base[:, 1], base.base[:, 2], base.base_alive,
                        dyn["params"], caps[0])
        else:
            out[key] = (base.base, base.base_alive, dyn["tid"], dyn["o"],
                        dyn["dom"], dyn["rng"], caps[0], *sig.extra_caps[2:])
    return out


def phase_kernels(kb1, kb100, launches, small_cap, api):
    import torch
    from repro_torch.core.engine import PAPER_QUERIES
    from repro_torch.core.index import key_cols, pow2_bucket
    from repro_torch.core.query import QueryEngine, _inl_ranges
    from repro_torch.kernels import build
    from repro_torch.kernels import closure_expand as ce
    from repro_torch.kernels import interval_filter as itf
    from repro_torch.kernels import merge_sorted as ms
    from repro_torch.kernels import msc_select as msc
    from repro_torch.kernels import ops
    from repro_torch.kernels import pair_search as ps
    from repro_torch.kernels import stream_compact as sc
    from repro_torch.testing.kernel_edges import closure_expand_edges
    from repro_torch.utils.pair64 import pair_key

    dev = kb100.device
    gen = torch.Generator(device=dev).manual_seed(0)
    src = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    rows = []
    edge_checks = 0

    # -- K1 at its largest main-path call: Q2's DISTINCT keep mask at
    # LUBM-100 (join_cap slots, the answers' rows set).  A fresh engine
    # plans as the first run of a query does: the KB's own engine keeps the
    # observations of the live phase, after which it answers Q4 by a merge
    # join (phase 6 prints the plans) --
    eng = QueryEngine(kb=kb100.kb, spo=kb100.lite_spo, mode="litemat",
                      dtb=kb100.dtb, view=kb100.view("litemat"))
    ex = eng.explain(PAPER_QUERIES["Q2"])
    cap, n_ans = ex["join_cap"], ex["n_result_rows"]
    keep = torch.arange(cap, device=dev) < n_ans
    err = _exact("compact_mask", sc.compact_mask(keep, cap),
                 sc.compact_mask_plain(keep, cap))
    rows.append(_row(
        "compact_mask", src + "stream_compact.cu", ref + "stream_compact.py:208",
        launches["compact_mask"], err,
        lambda: sc.compact_mask(keep, cap),
        lambda: sc.compact_mask_plain(keep, cap),
        lambda: torch.nonzero(keep), cap + 5 * cap + 4,
        ops=lambda: ops.compact_indices(keep, cap)))
    _one_launch("compact_indices", lambda: ops.compact_indices(keep, cap),
                "compact_mask", "compact")

    # -- K2 at the LUBM-100 lite store (Q1's fused scan), and K1 over a mask
    # of the same store, as a non-fused scan would give it --
    lite = kb100.lite_spo
    n = lite.shape[0]
    block = ops.auto_block(n)
    q1 = eng._prepare(PAPER_QUERIES["Q1"])[0][1]  # (s, p, o) Terms of Q1
    q2 = eng._prepare(PAPER_QUERIES["Q2"])[0][1]
    mask = (lite[:, 1] >= q2[1].lo) & (lite[:, 1] < q2[1].hi)  # memberOf run
    scap = pow2_bucket(int(mask.sum()))  # the cap a scan plan would give
    _exact("compact_mask store", sc.compact_mask(mask, scap),
           sc.compact_mask_plain(mask, scap))
    store_scan = _row(
        "compact_mask (store-size mask)", src + "stream_compact.cu",
        ref + "stream_compact.py:208", 0, 0,
        lambda: sc.compact_mask(mask, scap),
        lambda: sc.compact_mask_plain(mask, scap),
        lambda: torch.nonzero(mask), n + 5 * scap + 4,
        ops=lambda: ops.compact_indices(mask, scap, block=block))
    store_scan["cap"] = scap
    # K1 edges: n = 0, ragged heads of views at offsets 1-15, caps under
    # the total, every row and no row set, 2**24 + 3 rows (2,049 tiles of 8,192)
    big = torch.rand((1 << 24) + 18, generator=gen, device=dev) < 0.5
    k1_edges = [(big[:0], 16), (big[:1], 1), (big[: (1 << 24) + 3], 1 << 24),
                (big[7: (1 << 24) + 10], 1 << 24),
                (torch.ones(70_001, dtype=torch.bool, device=dev), 1 << 17),
                (torch.zeros(70_001, dtype=torch.bool, device=dev), 1 << 17),
                (mask[1:], scap), (keep[3:], cap)]
    k1_edges += [(big[k: k + 70_000 + k], 1 << 16) for k in range(1, 16)]
    k1_edges += [(big[k: k + 5], 8) for k in (3, 11)]  # head and tail meet
    for m_e, c_e in k1_edges:
        for c in (c_e, max(c_e // 3, 1)):  # a cap under the total too
            _exact("compact_mask edge", sc.compact_mask(m_e, c),
                   sc.compact_mask_plain(m_e, c))
            edge_checks += 1
    del big
    params = (q1[1].lo, q1[1].hi, q1[2].lo, q1[2].hi)  # Professor types
    p, o = lite[:, 1], lite[:, 2]
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    seng = QueryEngine(kb=kb100.kb, spo=lite, mode="litemat", dtb=kb100.dtb,
                       view=kb100.view("litemat"), use_index=False)
    kcap = _plan_cap(seng, PAPER_QUERIES["Q1"])  # the fused scan's cap
    err = _exact("masked_interval_compact",
                 sc.masked_interval_compact(p, o, alive, params, kcap),
                 sc.masked_interval_compact_plain(p, o, alive, params, kcap))

    def k2_ops():
        return ops.masked_interval_compact(p, o, alive, params, kcap,
                                           block=block)

    rows.append(_row(
        "masked_interval_compact", src + "stream_compact.cu",
        ref + "stream_compact.py:250", launches["masked_interval_compact"],
        err, lambda: sc.masked_interval_compact(p, o, alive, params, kcap),
        lambda: sc.masked_interval_compact_plain(p, o, alive, params, kcap),
        None, 13 * n + 5 * kcap + 4, ops=k2_ops))
    rows[-1]["cap"] = kcap
    rows[-1]["ops_device_split"] = _one_launch(
        "masked_interval_compact", k2_ops, "masked_interval_compact",
        "compact")
    # K2 edges: n = 0, one row, ragged tiles, the delta bucket's sizes (a
    # live tail, dead padding behind it), views at other offsets and
    # stride-1 columns, aligned or not; all, no and random rows alive;
    # every row and no row in range; caps at and under the total
    pc, oc = p.contiguous(), o.contiguous()
    views = {"store": (p, o), "store+1": (lite[1:, 1], lite[1:, 2]),
             "store s,o": (lite[:, 0], lite[:, 2]),
             "stride 1": (pc, oc), "stride 1, +1": (pc[1:], oc[1:]),
             "stride 1, +3": (pc[3:], oc[3:])}
    none_range = (params[0], params[0], params[2], params[3])
    for vname, (pv, ov) in views.items():
        sizes = (0, 1, 3 * 512 + 17, 5 * 8192 + 1, small_cap, 1 << 17)
        for m in (sizes if vname == "store" else (0, 5 * 8192 + 1, 1 << 17)):
            pm, om = pv[:m], ov[:m]
            live = torch.arange(m, device=dev) < m - m // 7  # a dead tail
            for am in (torch.ones(m, dtype=torch.bool, device=dev),
                       torch.zeros(m, dtype=torch.bool, device=dev),
                       torch.rand(m, generator=gen, device=dev) < 0.5, live):
                for prm in (params, (-2**31, 2**31 - 1, -2**31, 2**31 - 1),
                            none_range):
                    total = int(sc.masked_interval_compact_plain(
                        pm, om, am, prm, 0)[2])
                    for c in {pow2_bucket(total), max(total // 3, 1)}:
                        _exact(f"masked_interval_compact edge ({vname})",
                               sc.masked_interval_compact(pm, om, am, prm, c),
                               sc.masked_interval_compact_plain(pm, om, am,
                                                                prm, c))
                        edge_checks += 1

    # -- K3 at LUBM-1's PSO store (<= INL_RESIDENT_MAX): Q3's probe batch,
    # through both entries: the range entry the INL step calls (both
    # bounds) and the single search of ops.pair_search --
    eng1 = kb1.engine("litemat")
    pso = eng1.view.dev("pso").base
    prim, sec = key_cols("pso")
    t_hi, t_lo = pso[:, prim], pso[:, sec]
    qhi, qlo = _inl_probes(eng1, PAPER_QUERIES["Q3"])
    T, Q = t_hi.shape[0], qhi.shape[0]
    tkey, qkey = pair_key(t_hi, t_lo), pair_key(qhi, qlo)
    qkey1 = pair_key(qhi, qlo + 1)
    qvalid = qhi != 2**31 - 1
    touched = 8 * min(T, Q * (math.ceil(math.log2(T)) + 1))
    err = _exact("pair_range", ps.pair_range(t_hi, t_lo, qhi, qlo),
                 ps.pair_range_plain(t_hi, t_lo, qhi, qlo))
    rows.append(_row(
        "pair_range", src + "pair_search.cu", ref + "pair_search.py:51",
        launches["pair_range"], err,
        lambda: ps.pair_range(t_hi, t_lo, qhi, qlo),
        lambda: ps.pair_range_plain(t_hi, t_lo, qhi, qlo),
        lambda: (torch.searchsorted(tkey, qkey), torch.searchsorted(tkey, qkey1)),
        16 * Q + touched,
        ops=lambda: _inl_ranges(pso, prim, sec, qhi, qlo, qvalid),
        ops_library=lambda: _searchsorted_ranges(tkey, qhi, qlo, qvalid)))
    err = _exact("pair_search", [ps.pair_search(t_hi, t_lo, qhi, qlo)],
                 [ps.pair_search_plain(t_hi, t_lo, qhi, qlo)])
    rows.append(_row(
        "pair_search", src + "pair_search.cu", ref + "pair_search.py:51",
        launches["pair_search"], err,
        lambda: ps.pair_search(t_hi, t_lo, qhi, qlo),
        lambda: ps.pair_search_plain(t_hi, t_lo, qhi, qlo),
        lambda: torch.searchsorted(tkey, qkey), 12 * Q + touched))
    entry_check = _entry_check_us({
        "compact_mask": lambda: sc.compact_mask(keep, cap),
        "pair_search": lambda: ps.pair_search(t_hi, t_lo, qhi, qlo)},
        keep.device)
    # K3 edges: tables of 1 row, 2,048 rows (all staged), 2,049, LUBM-1's
    # 137,457 and LUBM-100's 11.7M strided; probes below and above every
    # key, on table keys (duplicates), and qlo = INT32_MAX (+ 1 wraps)
    pso100 = eng.view.dev("pso").base
    on_keys = torch.randint(0, T, (Q,), generator=gen, device=dev)
    probes = ((qhi, qlo), (qhi[:1], qlo[:1]), (torch.full_like(qhi, -1), qlo),
              (torch.full_like(qhi, 2**31 - 1), qlo),
              (t_hi[on_keys].contiguous(), t_lo[on_keys].contiguous()),
              (qhi, torch.full_like(qlo, 2**31 - 1)),
              (qhi, torch.full_like(qlo, -2**31)))
    for rows_t in (pso[:1], pso[:2048], pso[:2049], pso, pso100):
        th, tl = rows_t[:, prim], rows_t[:, sec]
        for qh, ql in probes:
            _exact("pair_range edge", ps.pair_range(th, tl, qh, ql),
                   ps.pair_range_plain(th, tl, qh, ql))
            _exact("pair_search edge", [ps.pair_search(th, tl, qh, ql)],
                   [ps.pair_search_plain(th, tl, qh, ql)])
            edge_checks += 2
    empty = t_hi[:0]
    require(torch.equal(ops.pair_search(empty, empty, qhi, qlo),
                        torch.zeros_like(qhi)), "empty table must give zeros")
    require(all(torch.equal(b, torch.zeros_like(qhi))
                for b in ops.pair_range(empty, empty, qhi, qlo)),
            "empty table must give zero ranges")

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

    # -- K5, the resident branch, as the small fold runs it: the compacted
    # full store's POS keys against a delta bucket under the block --
    pos = kb100.engine("full").view.dev("pos").base
    f_hi, f_lo = pos[:, 1], pos[:, 2]
    pick = torch.randint(0, pos.shape[0], (small_cap,), generator=gen,
                         device=dev).sort().values
    r_hi, r_lo = f_hi[pick].contiguous(), f_lo[pick].contiguous()  # ties
    err5 = _exact("merge_path_resident",
                  [ms.merge_path_resident(f_hi, f_lo, r_hi, r_lo)],
                  [ms.merge_path_plain(f_hi, f_lo, r_hi, r_lo)])
    fkey, rkey = pair_key(f_hi, f_lo), pair_key(r_hi, r_lo)
    rows.append(_row(
        "merge_path_resident", src + "merge_path.cu",
        ref + "merge_sorted.py:111", launches["merge_path_resident"], err5,
        lambda: ms.merge_path_resident(f_hi, f_lo, r_hi, r_lo),
        lambda: ms.merge_path_plain(f_hi, f_lo, r_hi, r_lo),
        lambda: torch.sort(torch.cat([fkey, rkey]), stable=True).indices,
        12 * (pos.shape[0] + small_cap)))

    # -- K4 at rewrite's real shapes: the raw store, Q4's Chair (domain
    # branch only: one stream) and Q1's Professor (domain and range: two) --
    raw_spo = kb100.kb.spo
    nr = raw_spo.shape[0]
    rblock = ops.auto_block(nr)
    ralive = torch.ones(nr, dtype=torch.bool, device=dev)
    reng = kb100.engine("rewrite")
    cols = (raw_spo[:, 0], raw_spo[:, 1], raw_spo[:, 2])

    def flat(streams):
        return [t for st in streams for t in st]

    member = {}  # streams -> row
    for streams, pats in ((1, PAPER_QUERIES["Q4"][:1]),  # Chair: domain only
                          (2, PAPER_QUERIES["Q1"])):  # Professor: both
        tid, mem, dom, rng, has_dom, has_rng = _rewrite_sets(reng, pats)
        require(has_rng == (streams == 2),
                f"{pats[0].o}: unexpected range branch {has_rng}")
        mcap = _plan_cap(reng, pats)  # the rewrite plan's cap
        args = (*cols, ralive, tid, mem, dom, rng, has_dom, has_rng, mcap)
        err = _exact("member_compact", flat(sc.member_compact(*args)),
                     flat(sc.member_compact_plain(*args)))
        set_bytes = 4 * (mem.numel() + (dom.numel() if has_dom else 0)
                         + (rng.numel() if has_rng else 0))
        k4_ops = (lambda a=(raw_spo, ralive, tid, mem, dom, rng, mcap,
                            has_dom, has_rng):
                  ops.rewrite_member_compact(*a, block=rblock))
        member[streams] = _row(
            "member_compact", src + "stream_compact.cu",
            ref + "stream_compact.py:284", launches["member_compact"], err,
            lambda a=args: sc.member_compact(*a),
            lambda a=args: sc.member_compact_plain(*a), None,
            13 * nr + set_bytes + streams * (5 * mcap + 4), ops=k4_ops)
        member[streams]["cap"] = mcap
        member[streams]["ops_device_split"] = _one_launch(
            f"rewrite_member_compact ({streams} streams)", k4_ops,
            "member_compact", "member_compact")
    rows.append(member[2])
    # K4 edges: n = 0, one row, ragged tiles, the delta bucket's sizes;
    # INVALID subjects and objects, dead rows; empty (all-padding) sets of
    # 8 and of 1 slot, a full set of 16 (the most compared member by
    # member), sets of 2,048 ids (all staged, searched) and over (searched
    # in device memory), rows that hit both branches (one set for dom and
    # rng); stride-1 columns; caps at and under each stream's total
    inv = 2**31 - 1
    big = _id_set(torch.randint(0, 2**24, (6000,), generator=gen, device=dev),
                  8192, dev)
    big_p = _id_set(torch.arange(0, 2**20, 3, device=dev), 2**19, dev)
    staged = _id_set(torch.arange(0, 2**13, 4, device=dev), 2048, dev)
    pad8 = _id_set(torch.zeros(0, device=dev), 8, dev)
    pad1 = _id_set(torch.zeros(0, device=dev), 1, dev)
    full16 = _id_set(torch.arange(0, 120, 7, device=dev)[:16], 16, dev)
    both = torch.cat([dom[dom != inv], rng[rng != inv]])
    both = _id_set(both, pow2_bucket(both.numel()), dev)
    edge_sets = ((mem, dom, rng), (pad8, pad8, pad8), (pad1, pad1, pad1),
                 (big, big_p, big_p), (mem, pad8, big_p), (staged, both, both),
                 (mem, both, both), (full16, full16, full16))
    m = 5 * 8192 + 77
    espo = raw_spo[:max(m, small_cap)].clone()
    espo[::97] = inv  # INVALID rows
    espo[5::89, 2] = inv  # INVALID objects
    ealive = torch.rand(espo.shape[0], generator=gen, device=dev) < 0.9
    e_cols = {"store": (espo[:, 0], espo[:, 1], espo[:, 2]),
              "stride 1": tuple(espo[:, k].contiguous() for k in range(3))}
    for cname, ec in e_cols.items():
        for n_e in ((0, 1, 3 * 512 + 17, small_cap, m) if cname == "store"
                    else (3 * 512 + 17, m)):
            for es in edge_sets:
                for hd in (False, True):
                    for hr in (False, True):
                        eargs = (*(c[:n_e] for c in ec), ealive[:n_e], tid,
                                 *es, hd, hr)
                        totals = [int(t[2]) for t in
                                  sc.member_compact_plain(*eargs, 0)]
                        for c in {pow2_bucket(max(totals)),
                                  max(min(totals) // 3, 1)}:
                            _exact(f"member_compact edge ({cname})",
                                   flat(sc.member_compact(*eargs, c)),
                                   flat(sc.member_compact_plain(*eargs, c)))
                            edge_checks += 1

    # -- K9 and K8 at the kernel-API phase's shapes: the lite store's p/o
    # columns with Q1's Professor bounds --
    ip, io, iprm, iblock = api["interval"]
    ni = ip.shape[0]
    nbi = sc.n_tiles(ni, iblock)
    err = _exact("interval_filter", [itf.interval_filter(ip, io, iprm)],
                 [itf.interval_filter_plain(ip, io, iprm)])
    rows.append(_row(
        "interval_filter", src + "interval_filter.cu",
        ref + "interval_filter.py:38", launches["interval_filter"], err,
        lambda: itf.interval_filter(ip, io, iprm),
        lambda: itf.interval_filter_plain(ip, io, iprm), None, 9 * ni))
    err = _exact("interval_tiles", sc.interval_tiles(ip, io, iprm, iblock),
                 sc.interval_tiles_plain(ip, io, iprm, iblock))
    rows.append(_row(
        "interval_tiles", src + "stream_compact.cu",
        ref + "stream_compact.py:226", launches["interval_tiles"], err,
        lambda: sc.interval_tiles(ip, io, iprm, iblock),
        lambda: sc.interval_tiles_plain(ip, io, iprm, iblock), None,
        8 * ni + 4 * nbi * iblock + 4 * nbi))
    full_range = (-2**31, 2**31 - 1, -2**31, 2**31 - 1)
    none_range = (iprm[0], iprm[0], iprm[2], iprm[3])
    for m, blk in ((0, 512), (1, 512), (3 * 512 + 17, 512), (5 * 4096 + 1, 4096)):
        for prm in (iprm, full_range, none_range):
            _exact("interval_filter edge", [itf.interval_filter(ip[:m], io[:m], prm)],
                   [itf.interval_filter_plain(ip[:m], io[:m], prm)])
            _exact("interval_tiles edge", sc.interval_tiles(ip[:m], io[:m], prm, blk),
                   sc.interval_tiles_plain(ip[:m], io[:m], prm, blk))
            edge_checks += 2

    # -- K7 at the raw base's Q1 member masks (the phase's largest call),
    # at the phase's cap --
    ma, mb_, cap7 = api["dual"]
    nd = ma.shape[0]
    err = _exact("dual_compact", flat(sc.dual_compact(ma, mb_, cap7)),
                 flat(sc.dual_compact_plain(ma, mb_, cap7)))

    def k7_ops():
        return ops.dual_compact_indices(ma, mb_, cap7)

    rows.append(_row(
        "dual_compact", src + "stream_compact.cu",
        ref + "stream_compact.py:310", launches["dual_compact"], err,
        lambda: sc.dual_compact(ma, mb_, cap7),
        lambda: sc.dual_compact_plain(ma, mb_, cap7),
        lambda: (torch.nonzero(ma), torch.nonzero(mb_)),
        2 * nd + 2 * (5 * cap7 + 4), ops=k7_ops))
    rows[-1]["cap"] = cap7
    rows[-1]["ops_device_split"] = _one_launch(
        "dual_compact_indices", k7_ops, "dual_compact", "dual_compact")
    # K7 edges: n = 0, n < 16, ragged tiles, all and no rows set; masks at
    # offsets from 16 bytes that differ (b read with two loads per 16 rows)
    # and agree; 2**24 + 3 rows; cap 0, caps under and over each total
    big = torch.rand((1 << 24) + 18, generator=gen, device=dev) < 0.5
    k7_edges = []
    for m in (0, 1, 7, 15, 3 * 512 + 17, 5 * 4096 + 1, 70_001):
        ones = torch.ones(m, dtype=torch.bool, device=dev)
        rand = torch.rand(m, generator=gen, device=dev) < 0.5
        k7_edges += [(ones, ~ones), (~ones, ones), (rand, ma[:m]),
                     (ma[:m], mb_[:m]), (big[1:m + 1], big[3:m + 3]),
                     (big[5:m + 5], rand), (big[2:m + 2], big[18:m + 18])]
    k7_edges += [(big[: (1 << 24) + 3], big[3: (1 << 24) + 6]),
                 (big[7: (1 << 24) + 10], big[: (1 << 24) + 3].clone())]
    for a, b in k7_edges:
        totals = [int(t[2]) for t in sc.dual_compact_plain(a, b, 0)]
        for c in {0, pow2_bucket(max(totals)), max(min(totals) // 3, 1)}:
            _exact("dual_compact edge", flat(sc.dual_compact(a, b, c)),
                   flat(sc.dual_compact_plain(a, b, c)))
            edge_checks += 1
    del big

    # -- K11 at the full materializer's step-3 inputs --
    cq, cids, canc = api["closure"]
    nq, D = cq.shape[0], canc.shape[1]
    err = _exact("closure_expand", [ce.closure_expand(cq, cids, canc)],
                 [ce.closure_expand_plain(cq, cids, canc)])
    rows.append(_row(
        "closure_expand", src + "closure_expand.cu",
        ref + "closure_expand.py:53", launches["closure_expand"], err,
        lambda: ce.closure_expand(cq, cids, canc),
        lambda: ce.closure_expand_plain(cq, cids, canc), None,
        4 * nq + 4 * D * nq + 4 * cids.numel() + 4 * canc.numel()))
    rows[-1]["ops_device_split"] = _one_launch(
        "closure_expand", lambda: ops.closure_expand(cq, cids, canc),
        "closure_expand", None, kernel="closure_expand")
    odd = cq[:1000].clone()
    odd[::3], odd[1::3] = -1, 2**31 - 1  # never concept ids: rows of -1
    for q_e in (cq[:0], odd, cq[1:], cq[3:100_003]):
        _exact("closure_expand edge", [ce.closure_expand(q_e, cids, canc)],
               [ce.closure_expand_plain(q_e, cids, canc)])
        edge_checks += 1
    # K11 edges: every template boundary of D and the generic kernel past
    # it, C past the staged ids, n % 4 tails, views off 16 bytes, extreme ids
    for q_e, ids_e, anc_e in closure_expand_edges(dev):
        _exact("closure_expand edge", [ce.closure_expand(q_e, ids_e, anc_e)],
               [ce.closure_expand_plain(q_e, ids_e, anc_e)])
        edge_checks += 1

    # -- K10 at the candidates grouped by instance --
    conc_g, bounds_g = api["msc"]
    G, K = conc_g.shape
    err = _exact("msc_select", [msc.msc_select(conc_g, bounds_g)],
                 [msc.msc_select_plain(conc_g, bounds_g)])
    rows.append(_row(
        "msc_select", src + "msc_select.cu", ref + "msc_select.py:49",
        launches["msc_select"], err,
        lambda: msc.msc_select(conc_g, bounds_g),
        lambda: msc.msc_select_plain(conc_g, bounds_g), None, 9 * G * K))
    # K10 edges: each template boundary (exact K up to 8, buckets of 16 and
    # 32), the generic kernel past them (K = 33, 300) and past its staging
    # (7,000), G = 0, partial last tiles, and views one group in (off
    # 16-byte alignment unless 4K is a multiple of 16)
    for g_e, k_e in ((0, 4), (1, 1), (1000, 1), (37, 33), (64, 33), (3, 300),
                     (0, 6), (0, 17), (300, 6), (257, 8), (129, 9),
                     (130, 16), (65, 17), (70, 32), (5, 7000)):
        ce_ = torch.randint(-1, 500, (g_e + 1, k_e), generator=gen,
                            device=dev, dtype=torch.int32)
        be_ = ce_ + torch.randint(1, 64, (g_e + 1, k_e), generator=gen,
                                  device=dev, dtype=torch.int32)
        for c_, b_ in ((ce_[:g_e].clone(), be_[:g_e].clone()),
                       (ce_[1:], be_[1:])):
            _exact("msc_select edge", [msc.msc_select(c_, b_)],
                   [msc.msc_select_plain(c_, b_)])
            edge_checks += 1
    _exact("msc_select edge", [msc.msc_select(conc_g[:1001], bounds_g[:1001])],
           [msc.msc_select_plain(conc_g[:1001], bounds_g[:1001])])
    edge_checks += 1

    # -- the batched compactions (K1, K2, K4 with a member axis) at the
    # serving phase's shapes, beside the same members as solo calls --
    from repro_torch.launch.serve import CLASSES
    from repro_torch.testing.kernel_edges import (
        compact_mask_batched_edges, masked_interval_batched_edges,
        member_batched_edges)

    bk = _batched_args(kb100)
    keep_b, cap_b = bk["k1"]
    nb1, n1 = keep_b.shape
    err = _exact("compact_mask_batched", sc.compact_mask_batched(keep_b, cap_b),
                 sc.compact_mask_batched_plain(keep_b, cap_b))
    rows.append(_row(
        "compact_mask_batched", src + "stream_compact.cu",
        ref + "stream_compact.py:208",
        launches["compact_mask_batched"], err,
        lambda: sc.compact_mask_batched(keep_b, cap_b),
        lambda: sc.compact_mask_batched_plain(keep_b, cap_b),
        lambda: torch.nonzero(keep_b), nb1 * n1 + nb1 * (5 * cap_b + 4),
        ops=lambda: ops.compact_indices_batched(keep_b, cap_b)))
    rows[-1].update(under_vmap=True, members=nb1, rows_per_member=n1,
                    cap=cap_b,
                    solo_calls_event_ms=event_ms(
                        lambda: [sc.compact_mask(m, cap_b) for m in keep_b]))
    rows[-1]["ops_device_split"] = _one_launch(
        "compact_indices_batched",
        lambda: ops.compact_indices_batched(keep_b, cap_b),
        "compact_mask_batched", "compact")

    group_log = build.BUILD_LOG.get("stream_compact", "")
    # K2 at the family's ten members, and at the runtime's max_batch (16),
    # nested in its row (the same kernel: its launches are the row's)
    k2_16 = _batched_args(kb100, CLASSES + SERVING_CLASSES_16, ("k2",))["k2"]
    require(k2_16[3].shape[0] == 16, "the 16 classes formed no one group")
    for name, k2b in (("masked_interval_compact_batched", bk["k2"]),
                      ("masked_interval_compact_batched at 16 members",
                       k2_16)):
        p2, o2, a2, prm2, cap2 = k2b
        nb2, n2 = prm2.shape[0], p2.shape[0]
        got = sc.masked_interval_compact_batched(*k2b)
        reads = _store_reads(got[0], 1, n2)
        require(reads == -(-nb2 // 16),
                f"{name}: {nb2} members read the store {reads} times")
        err = _exact(name, got, sc.masked_interval_compact_batched_plain(*k2b))
        prm_h = prm2.tolist()
        row = _row(
            name, src + "stream_compact.cu", ref + "stream_compact.py:250",
            launches["masked_interval_compact_batched"], err,
            lambda a=k2b: sc.masked_interval_compact_batched(*a),
            lambda a=k2b: sc.masked_interval_compact_batched_plain(*a), None,
            13 * n2 + 16 * nb2 + nb2 * (5 * cap2 + 4),
            ops=lambda a=k2b: ops.masked_interval_compact_batched(*a))
        row.update(
            under_vmap=True, members=nb2, rows=n2, cap=cap2,
            store_reads=reads,
            ptxas=ptxas_lines(group_log, "compact_lookback_group",
                              "IntervalGroup"),
            solo_calls_event_ms=event_ms(
                lambda a=k2b, ph=prm_h: [sc.masked_interval_compact(
                    *a[:3], b, a[4]) for b in ph]))
        row["ops_device_split"] = _one_launch(
            name, lambda a=k2b: ops.masked_interval_compact_batched(*a),
            "masked_interval_compact_batched", "compact",
            kernel="compact_lookback_group")
        if nb2 == 16:
            for k in ("route", "source", "replaces", "launches", "ptxas"):
                del row[k]
            rows[-1]["at_16_members"] = row
        else:
            rows.append(row)
    del k2_16

    spo4, a4, tid4, mem4, dom4, rng4, cap4, hd4, hr4 = bk["k4"]
    nb4, n4 = mem4.shape[0], spo4.shape[0]
    k4b = (spo4[:, 0], spo4[:, 1], spo4[:, 2], a4, tid4, mem4, dom4, rng4,
           hd4, hr4, cap4)
    got = sc.member_compact_batched(*k4b)
    streams4 = 2 if hr4 else 1
    reads4 = _store_reads(got[0][0], streams4, n4)
    require(reads4 == -(-nb4 // 16),
            f"member_compact_batched: {nb4} members read the store {reads4} "
            "times")
    err = _exact("member_compact_batched", flat(got),
                 flat(sc.member_compact_batched_plain(*k4b)))
    set_bytes4 = 4 * (mem4.numel() + (dom4.numel() if hd4 else 0)
                      + (rng4.numel() if hr4 else 0))
    k4_ops = (lambda: ops.rewrite_member_compact_batched(
        spo4, a4, tid4, mem4, dom4, rng4, cap4, hd4, hr4))
    rows.append(_row(
        "member_compact_batched", src + "stream_compact.cu",
        ref + "stream_compact.py:284",
        launches["member_compact_batched"], err,
        lambda: sc.member_compact_batched(*k4b),
        lambda: sc.member_compact_batched_plain(*k4b), None,
        13 * n4 + set_bytes4 + streams4 * nb4 * (5 * cap4 + 4), ops=k4_ops))
    rows[-1].update(
        under_vmap=True, members=nb4, rows=n4, cap=cap4, streams=streams4,
        store_reads=reads4,
        ptxas=ptxas_lines(group_log, "compact_lookback_group", "MemberGroup"),
        solo_calls_event_ms=event_ms(
            lambda: [sc.member_compact(*k4b[:5], mem4[b], dom4[b], rng4[b],
                                       hd4, hr4, cap4) for b in range(nb4)]))
    rows[-1]["ops_device_split"] = _one_launch(
        "rewrite_member_compact_batched", k4_ops, "member_compact_batched",
        "member_compact", kernel="compact_lookback_group")
    del bk, keep_b
    # batched edges (kernel_edges): B = 1, 2, 3 and the group boundaries
    # 15, 16, 17, 33; n = 0, 1, 8,191, 8,192, 8,193, 2**21 + 3; cap = 0, 1,
    # n, n + 5; members all false, all true, differing; masks off 16 bytes;
    # K2 bounds differing in every field, inverted, empty, full-range,
    # alive partly false; K4 sets past the staged 2,048, and groups whose
    # sets exceed the staging budget (some members' staged, some not)
    batched_edges = 0
    for m_e, c_e in compact_mask_batched_edges(dev):
        _exact("compact_mask_batched edge", sc.compact_mask_batched(m_e, c_e),
               sc.compact_mask_batched_plain(m_e, c_e))
        batched_edges += 1
    for a_e in masked_interval_batched_edges(dev):
        _exact("masked_interval_compact_batched edge",
               sc.masked_interval_compact_batched(*a_e),
               sc.masked_interval_compact_batched_plain(*a_e))
        batched_edges += 1
    for a_e in member_batched_edges(dev):
        _exact("member_compact_batched edge",
               flat(sc.member_compact_batched(*a_e)),
               flat(sc.member_compact_batched_plain(*a_e)))
        batched_edges += 1
    edge_checks += batched_edges

    emit({"phase": "kernels", "edge_checks": edge_checks,
          "batched_edge_checks": batched_edges,
          "shapes": {"compact_mask": cap, "compact_answers": n_ans,
                     "scan_rows": n, "scan_cap": kcap,
                     "pair_search_table": T, "pair_search_queries": Q,
                     "merge_a": na, "merge_b": mb,
                     "resident_a": int(pos.shape[0]), "resident_b": small_cap,
                     "member_rows": nr,
                     "interval_rows": ni, "interval_block": iblock,
                     "dual_rows": nd, "dual_cap": cap7,
                     "closure_queries": nq, "closure_concepts": cids.numel(),
                     "closure_depth": D, "msc_groups": G, "msc_k": K},
          "member_compact_one_stream": member[1],
          "entry_check_us": entry_check,
          "store_size_compaction": store_scan, "peak_gib": peak_gib()})
    for r in rows:
        require(r["launches"] > 0, f"{r['name']} never launched on the main path")
    emit({"kernels": rows})


# ---------------------------------------------------------------------------
# Phase 10: the LM family (no hand-written kernel on its path)
# ---------------------------------------------------------------------------

LM_ARCH = "olmo-1b"  # the largest LM whose training state fits one card
LM_BATCH, LM_SEQ, LM_STEPS = 2, 4096, 6  # train_4k's sequence, batch cut
LM_SERVE_BATCH, LM_DECODE = 4, 32
H100_BF16_FLOPS = 989.4e12  # H100 SXM dense BF16 peak
LM_LAUNCH_TIMEOUT_S = 300  # the launcher child is killed past this
GEMM_KERNEL_NAMES = ("gemm", "nvjet", "xmma", "cutlass")  # cuBLAS's kernels
# bf16 limits on norm-relative errors (``_norm_rel_err``) at olmo-1b's full
# width: the blockwise prefill against the naive one (the logits, and each
# cache layer), and the first decode's logits against a fresh forward.
# ``python3 chip_smoke.py --lm-spread 3`` (3 weight seeds x 3 prompt seeds,
# an H100 80GB HBM3 at 700 W) read 0.0171-0.0184 and 0.0158-0.0170: each
# layer's bf16 roundings differ between the paths and compound over 16
# layers.  A wrong mask, window or position is an error of order one.
LM_BLOCKWISE_LIMIT = 0.04
LM_DECODE_LIMIT = 0.04
# the reduced archs' train step: below this share of a leaf's largest
# gradient, a gradient is summation noise and so is the sign of its update
LM_GRAD_FLOOR = 1e-4


def _lm_matrix_flops(cfg, B: int, S: int) -> float:
    """The matrix products of one remat training step of a dense GQA LM
    at B x S tokens: 6 N T for the layers' weights and 2 N T more for
    remat's recompute (N the stacked layers' weights), 6 V d T for the
    tied logits, and QK^T and PV (4 B H S^2 hd a layer a pass) over the
    forward, the recompute and the backward's two passes."""
    T = B * S
    n = cfg.model_flops_per_token() / 6.0  # embedding excluded
    attn = 4 * B * cfg.n_heads * S * S * cfg.head_dim * cfg.n_layers
    return 8 * n * T + 6 * cfg.vocab * cfg.d_model * T + 4 * attn


def _lm_device():
    import torch

    return torch.device("cuda")


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _norm_rel_err(got, want) -> float:
    """||got - want|| over ||want|| (2-norms over every element), in
    float32: one rounding more in a large product moves it little."""
    import torch

    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


def _blockwise_errors(logits_b, cache_b, logits, cache) -> dict:
    """The blockwise prefill against the naive one: the logits' error, and
    each cache's largest error over its layers (each layer against its own
    scale)."""
    return {"logits": _norm_rel_err(logits_b, logits),
            **{k: max(_norm_rel_err(a, b)
                      for a, b in zip(cache_b[k], cache[k])) for k in cache}}


def _decode_errors(lg_dec, lg_full) -> dict:
    """The first decode's logits against a fresh forward's."""
    return {"norm_rel_err": _norm_rel_err(lg_dec, lg_full),
            "max_abs_err": float((lg_dec - lg_full).abs().max()),
            "rel_err": _rel_err(lg_dec, lg_full),
            "argmax_agree": float((lg_dec.argmax(-1) == lg_full.argmax(-1))
                                  .float().mean())}


class _Unsaved:
    """A checkpoint manager that keeps nothing: a full-width checkpoint of
    olmo-1b is ~14 GB, and the resume contract is checked at the reduced
    config."""

    def __init__(self):
        self.saves = []

    def latest_step(self):
        return None

    def save(self, step, tree, extra=None):
        self.saves.append(step)


def _lm_profile(fn, step_ms: float) -> dict:
    """torch.profiler over one call of ``fn``: the device time by op (self
    time of the kernels each aten op launched) and by kernel, the top
    entries, and the wall time.  The busy share is the device time over
    ``step_ms``, the wall time of an unprofiled call: the profiler's host
    tracing stretches the wall it sees."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(_lm_device())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(_lm_device())
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    ops = sorted(((e.key, e.self_device_time_total / 1e3) for e in events
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda d: -d[1])
    kernels = sorted(((e.key[:100], e.self_device_time_total / 1e3, e.count)
                      for e in events if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), key=lambda d: -d[1])
    busy = sum(ms for _, ms, _ in kernels)
    gemm = sum(ms for name, ms, _ in kernels
               if any(k in name.lower() for k in GEMM_KERNEL_NAMES))
    return {"profiled_wall_ms": wall_ms, "unprofiled_ms": step_ms,
            "device_ms": busy,
            "device_busy_share": busy / step_ms if busy else None,
            "gemm_kernels_ms": gemm,
            "kernel_launches": sum(n for _, _, n in kernels),
            "top_ops_ms": ops[:14], "top_kernels_ms": kernels[:12]}


def _lm_train_full(cfg, dev) -> tuple:
    """olmo-1b at full width and depth: ``TrainLoop`` for LM_STEPS steps
    at LM_BATCH x LM_SEQ (bf16, remat, naive attention), then one step
    profiled.  Returns (params, the phase's line)."""
    import torch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import lm
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.utils.tree import tree_items

    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, device=dev, seed=0)  # a CUDA generator
    opt = init_opt_state(params)
    before = {path: t.to("cpu", copy=True)
              for path, t in tree_items(params)}
    step_fn = lm.make_train_step(cfg)
    step_s, gnorms = [], []

    def timed(p, o, batch):
        _sync(dev)
        t = time.perf_counter()
        p, o, m = step_fn(p, o, batch)
        _sync(dev)
        step_s.append(time.perf_counter() - t)
        gnorms.append(float(m["grad_norm"]))
        return p, o, m

    stream = TokenStream(cfg.vocab, LM_BATCH, LM_SEQ, seed=1)
    ckpt = _Unsaved()
    loop = TrainLoop(timed, stream.batch_at, ckpt, ckpt_every=10**9,
                     log_every=1, device=dev)
    params, opt, last, losses = loop.run(params, opt, LM_STEPS, start_step=0)
    peak = peak_gib()
    require(last == LM_STEPS and len(losses) == LM_STEPS,
            f"trained {last} steps, want {LM_STEPS}")
    require(all(math.isfinite(x) for x in losses + gnorms),
            f"non-finite loss or grad norm: {losses} {gnorms}")
    changed = {"/".join(map(str, path)): float((t.cpu() != before[path])
                                                .float().mean())
               for path, t in tree_items(params)}
    require(all(v > 0 for v in changed.values()),
            f"a parameter never changed: {changed}")
    del before
    tokens = LM_BATCH * LM_SEQ
    med_s = statistics.median(step_s[1:])
    flops = cfg.model_flops_per_token()
    matrix = _lm_matrix_flops(cfg, LM_BATCH, LM_SEQ)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in stream.batch_at(LM_STEPS).items()}
    prof = _lm_profile(lambda: step_fn(params, opt, batch), med_s * 1e3)
    del opt, batch
    line = {"phase": "lm_train", "arch": cfg.name, "dtype": cfg.dtype,
            "remat": cfg.remat, "attn_impl": cfg.attn_impl,
            "params": cfg.param_count(), "batch": LM_BATCH, "seq": LM_SEQ,
            "steps": last, "losses": losses, "grad_norms": gnorms,
            "checkpoint_saves": ckpt.saves,
            "changed_share_by_leaf": changed, "step_ms": [s * 1e3 for s in
                                                         step_s],
            "step_ms_median_last5": med_s * 1e3,
            "tokens_per_s": tokens / med_s,
            "model_flops_per_token": flops,
            "model_tflop_per_step": flops * tokens / 1e12,
            "model_flop_share_of_bf16_peak": flops * tokens / med_s
            / H100_BF16_FLOPS,
            "matrix_tflop_per_step": matrix / 1e12,
            "matrix_bound_ms": matrix / H100_BF16_FLOPS * 1e3,
            "peak_gib": peak, "profile_one_step": prof}
    return params, line


def _timed(dev, fn, *args) -> tuple:
    """``fn(*args)`` and its wall time in ms, the card synced around it."""
    _sync(dev)
    t = time.perf_counter()
    out = fn(*args)
    _sync(dev)
    return out, (time.perf_counter() - t) * 1e3


def _lm_serve_first(cfg, params, dev, seed: int) -> dict:
    """A prompt of LM_SERVE_BATCH x LM_SEQ tokens drawn from ``seed``,
    prefilled naive and blockwise (after one warm naive prefill: cuBLAS
    picks its algorithms), then decoded one step; the blockwise prefill
    held to the naive one and the decode's logits to a fresh forward over
    LM_SEQ + 1 tokens (``_blockwise_errors``, ``_decode_errors``).  The
    checks are the caller's."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import lm

    B, S = LM_SERVE_BATCH, LM_SEQ
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        1, cfg.vocab, (B, S + 1)), dtype=torch.int32, device=dev)
    prefill = lm.make_prefill_step(cfg, max_seq=S + LM_DECODE)
    blockwise = lm.make_prefill_step(
        dataclasses.replace(cfg, attn_impl="blockwise"), max_seq=S + LM_DECODE)
    prefill(params, toks[:, :S])
    (logits_b, cache_b), blockwise_ms = _timed(dev, blockwise, params,
                                               toks[:, :S])
    (logits, cache), prefill_ms = _timed(dev, prefill, params, toks[:, :S])
    block_err = _blockwise_errors(logits_b, cache_b, logits, cache)
    del logits_b, cache_b
    (lg_dec, cache), first_ms = _timed(dev, lm.make_decode_step(cfg), params,
                                       cache, toks[:, S:], S)
    with torch.no_grad():
        x, _ = lm.forward(params, toks, cfg)
        lg_full = lm.logits_fn(x[:, S:S + 1], params["embed"])
    del x
    return {"blockwise_vs_naive": block_err,
            "decode_vs_forward": _decode_errors(lg_dec, lg_full),
            "prefill_ms": prefill_ms, "prefill_blockwise_ms": blockwise_ms,
            "decode_first_ms": first_ms, "cache": cache, "logits": lg_dec}


def _lm_serve_full(cfg, params, dev) -> dict:
    """Prefill LM_SERVE_BATCH x LM_SEQ (naive, then blockwise), then
    LM_DECODE greedy decode steps; the blockwise prefill held to the naive
    one and the first decode's logits to a fresh forward, under
    LM_BLOCKWISE_LIMIT and LM_DECODE_LIMIT."""
    import torch
    from repro_torch.models import lm
    from repro_torch.utils.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    B, S = LM_SERVE_BATCH, LM_SEQ
    first = _lm_serve_first(cfg, params, dev, seed=2)
    block_err, consistency = (first["blockwise_vs_naive"],
                              first["decode_vs_forward"])
    for what, err in block_err.items():
        require(err < LM_BLOCKWISE_LIMIT,
                f"blockwise prefill {what} off by {err:.3g} (norm-relative, "
                f"limit {LM_BLOCKWISE_LIMIT})")
    require(consistency["norm_rel_err"] < LM_DECODE_LIMIT,
            f"decode at position {S} disagrees with a fresh forward "
            f"(limit {LM_DECODE_LIMIT}): {consistency}")
    cache, lg_dec = first["cache"], first["logits"]
    prefill_ms = first["prefill_ms"]
    decode = lm.make_decode_step(cfg)
    tok = lg_dec[:, -1].argmax(-1, keepdim=True).int()
    steps_ms = []
    for pos in range(S + 1, S + LM_DECODE):
        (lg, cache), ms = _timed(dev, decode, params, cache, tok, pos)
        steps_ms.append(ms)
        tok = lg[:, -1].argmax(-1, keepdim=True).int()
    require(bool(torch.isfinite(lg).all()), "non-finite decode logits")
    dec_ms = statistics.median(steps_ms)
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    bound_ms = (weights + cache_bytes) / HBM_BYTES_PER_S * 1e3
    return {"phase": "lm_serve", "arch": cfg.name, "batch": B, "prompt": S,
            "max_seq": S + LM_DECODE, "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": B * S / prefill_ms * 1e3,
            "prefill_blockwise_ms": first["prefill_blockwise_ms"],
            "blockwise_vs_naive_norm_rel_err": block_err,
            "blockwise_limit": LM_BLOCKWISE_LIMIT,
            "decode_first_ms": first["decode_first_ms"],
            "decode_steps": len(steps_ms),
            "decode_ms_per_step_median": dec_ms,
            "decode_tokens_per_s": B / dec_ms * 1e3,
            "decode_bound_ms": bound_ms,
            "decode_bytes_per_step": weights + cache_bytes,
            "decode_vs_forward": consistency,
            "decode_limit": LM_DECODE_LIMIT,
            "decode_profile_one_step": _lm_profile(
                lambda: decode(params, cache, tok, S + LM_DECODE - 1),
                dec_ms),
            "peak_gib": peak_gib()}


def _lm_reduced_run(cfg, w, dev) -> dict:
    """One prefill, one decode and one train step (AdamW at
    ``warmup_steps=1``, so the step moves a weight by up to 3e-4, far
    above float32's resolution) of a reduced arch on ``dev`` from the
    carried weights ``w``; host tensors out, the parameters and moments
    under the reference's paths."""
    import torch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.utils.tree import tree_items

    batch = {k: torch.as_tensor(v).to(dev) for k, v in
             TokenStream(cfg.vocab, 2, 32, seed=3).batch_at(0).items()}
    p = lm.params_from_reference(w, cfg, dev)
    logits, cache = lm.make_prefill_step(cfg, max_seq=36)(p, batch["tokens"])
    nxt = batch["targets"][:, -1:]
    dlogits, cache = lm.make_decode_step(cfg)(p, cache, nxt, 32)
    p, opt, m = lm.make_train_step(cfg, AdamWConfig(warmup_steps=1))(
        p, init_opt_state(p), batch)
    out = {"logits": logits, "dlogits": dlogits,
           **{f"cache/{k}": v for k, v in cache.items()},
           **{f"metric/{k}": v for k, v in m.items()}}
    out = {k: v.detach().cpu() for k, v in out.items()}
    for name, tree in (("param", p), ("mu", opt["mu"])):
        for path, a in tree_items(lm.params_to_reference(tree)):
            out[name + "/" + "/".join(map(str, path))] = torch.from_numpy(a)
    return out


def _update_err(got, want, old, mu) -> float:
    """The card's AdamW update ``got - old`` against the CPU's
    ``want - old``: the largest error over ``1e-3 |want - old|`` plus 4
    float32 spacings of ``|old|``, over the weights whose CPU gradient
    (``mu``, its tenth) is zero or above ``LM_GRAD_FLOOR`` of the leaf's
    largest; the rest are held to two full steps, ``2 lr``.  A value of 1
    or more fails."""
    import numpy as np
    from repro_torch.train.optimizer import AdamWConfig

    old = np.asarray(old, dtype=np.float32)
    got_d = got.double().numpy() - old
    want_d = want.double().numpy() - old
    err = np.abs(got_d - want_d)
    g = np.abs(mu.numpy())
    held = (g == 0) | (g > LM_GRAD_FLOOR * g.max())
    limit = 1e-3 * np.abs(want_d) + 4 * np.spacing(np.abs(old))
    worst = float((err / limit)[held].max()) if held.any() else 0.0
    free = float(err[~held].max() / (2 * AdamWConfig().lr)) \
        if (~held).any() else 0.0
    return max(worst, free)


def _lm_reduced_archs(dev) -> dict:
    """All five LM archs at their reduced configs (float32): the card's run
    against the port's CPU run on the same carried weights and batch.
    Tolerances: logits, caches and metrics rtol=atol=1e-4; each weight's
    update by ``_update_err``; moments atol 1e-4 of the largest."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import lm
    from repro_torch.utils.tree import tree_items

    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmuls are on: float32 checks would not be float32")
    out = {}
    for arch, mod in ARCHS.items():
        if mod.FAMILY != "lm":
            continue
        cfg = mod.reduced_config()
        w = lm.params_to_reference(lm.init_params(cfg, device="cpu", seed=5))
        old = {"param/" + "/".join(map(str, path)): a
               for path, a in tree_items(w)}
        on_card, on_cpu = (_lm_reduced_run(cfg, w, d)
                           for d in (dev, torch.device("cpu")))
        errs = {}
        for k, want in on_cpu.items():
            got = on_card[k]
            group = k.split("/")[0]
            if group == "param":
                err = _update_err(got, want, old[k], on_cpu["mu" + k[5:]])
                ok, group = err < 1.0, "param_update_share_of_limit"
            else:
                err = float((got - want).abs().max()) if want.numel() else 0.0
                ok = (err <= 1e-4 * float(want.abs().max()) if group == "mu"
                      else torch.allclose(got, want, rtol=1e-4, atol=1e-4))
            require(ok, f"{arch} {k}: card and CPU differ by {err:.3g}")
            errs[group] = max(errs.get(group, 0.0), err)
        out[arch] = {"loss": float(on_card["metric/loss"]), "max_err": errs,
                     "moe": cfg.moe, "attn": cfg.attn, "window": cfg.window}
    return out


def _lm_resume(dev) -> dict:
    """olmo reduced on the card, interrupted after step 3 and resumed to 6,
    against an uninterrupted 6-step run, under deterministic algorithms
    (cuBLAS's workspace fixed by ``CUBLAS_WORKSPACE_CONFIG``, set before
    the first product): equal bit for bit."""
    import shutil

    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.models import lm
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.utils.tree import tree_leaves

    cfg = get_arch(LM_ARCH).reduced_config()
    stream = TokenStream(cfg.vocab, 2, 16, seed=5)
    step_fn = lm.make_train_step(cfg)
    work = ROOT / "build" / "lm_resume"
    shutil.rmtree(work, ignore_errors=True)

    def fresh():
        p = lm.init_params(cfg, device=dev, seed=0)
        return p, init_opt_state(p)

    def loop(name, every):
        return TrainLoop(step_fn, stream.batch_at,
                         CheckpointManager(work / name), ckpt_every=every,
                         log_every=1000, device=dev)

    torch.use_deterministic_algorithms(True)
    try:
        pa, _, _, hist_a = loop("a", 100).run(*fresh(), 6, start_step=0)
        _, _, s, _ = loop("b", 3).run(*fresh(), 3, start_step=0)
        pc, oc, s2, hist_c = loop("b", 100).run(*fresh(), 6)
    finally:
        torch.use_deterministic_algorithms(False)
    diff = max(float((a - c).abs().max())
               for a, c in zip(tree_leaves(pa), tree_leaves(pc)))
    require(s == 3 and s2 == 6 and int(oc["step"]) == 6,
            f"resume stopped at {s}, ended at {s2}")
    require(hist_c == hist_a[3:] and diff == 0.0,
            f"resumed run differs: losses {hist_c} vs {hist_a[3:]}, "
            f"parameters by {diff}")
    shutil.rmtree(work, ignore_errors=True)
    return {"losses": hist_a, "max_param_diff": diff,
            "deterministic": True}


def _lm_launcher(dev) -> dict:
    """``python -m repro_torch.launch.train`` as a child on the card."""
    import os
    import re
    import shutil

    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.models import lm
    from repro_torch.train.optimizer import init_opt_state

    work = ROOT / "build" / "train_lm"
    shutil.rmtree(work, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           LM_ARCH, "--steps", "100", "--ckpt-dir", str(work)]
    t = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=LM_LAUNCH_TIMEOUT_S,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    seconds = time.perf_counter() - t
    require(out.returncode == 0, f"the launcher exited {out.returncode}:\n"
                                 f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
    losses = [float(x) for x in
              re.findall(r"^step \d+: loss=([-0-9.naif]+)", out.stdout, re.M)]
    require(len(losses) == 10 and all(map(math.isfinite, losses))
            and losses[-1] < losses[0],
            f"the launcher's logged losses: {losses}")
    cfg = get_arch(LM_ARCH).reduced_config()
    mgr = CheckpointManager(work)
    p = lm.init_params(cfg, device=dev)
    (_, opt), manifest = mgr.restore((p, init_opt_state(p)))  # hash checked
    require(mgr.all_steps() == [50, 100] and int(opt["step"]) == 100
            and manifest["extra"] == {"next_step": 100},
            f"checkpoints {mgr.all_steps()}, manifest {manifest}")
    return {"cmd": " ".join(cmd[1:]), "seconds": seconds,
            "logged_losses": losses, "checkpoints": mgr.all_steps(),
            "device_line": out.stdout.splitlines()[0]}


def phase_lm():
    """The LM family on the card: olmo-1b trained at full width and depth,
    prefilled and decoded; the five archs' reduced configs against their
    CPU runs; the resume contract; the launcher."""
    import torch
    from repro_torch.configs.registry import get_arch

    dev = _lm_device()
    emit({"phase": "lm_start", "memory_allocated_gib":
          torch.cuda.memory_allocated() / 2**30})
    cfg = get_arch(LM_ARCH).full_config()
    params, line = _lm_train_full(cfg, dev)
    emit(line)
    emit(_lm_serve_full(cfg, params, dev))
    del params
    torch.cuda.empty_cache()
    emit({"phase": "lm_reduced", "archs": _lm_reduced_archs(dev)})
    emit({"phase": "lm_resume", **_lm_resume(dev)})
    emit({"phase": "lm_launcher", **_lm_launcher(dev)})


def lm_spread(n: int) -> None:
    """The serving checks' readings at olmo-1b's full width over ``n``
    weight seeds x ``n`` prompt seeds, one line each and their largest:
    what LM_BLOCKWISE_LIMIT and LM_DECODE_LIMIT are set from."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import lm

    cfg = get_arch(LM_ARCH).full_config()
    dev = _lm_device()
    worst = {}
    for weight_seed in range(n):
        params = lm.init_params(cfg, device=dev, seed=weight_seed)
        for prompt_seed in range(2, 2 + n):
            first = _lm_serve_first(cfg, params, dev, prompt_seed)
            errs = {**{f"blockwise/{k}": v for k, v in
                       first["blockwise_vs_naive"].items()},
                    "decode/norm_rel_err":
                        first["decode_vs_forward"]["norm_rel_err"]}
            emit({"phase": "lm_spread", "weight_seed": weight_seed,
                  "prompt_seed": prompt_seed, **errs,
                  "decode_argmax_agree":
                      first["decode_vs_forward"]["argmax_agree"]})
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
            del first
        del params
        torch.cuda.empty_cache()
    emit({"phase": "lm_spread_max", "readings": n * n, **worst})


# ---------------------------------------------------------------------------
# Phase 11: the GNN family (no hand-written kernel on its path)
# ---------------------------------------------------------------------------

GNN_STEPS = 5  # SGD steps a timed run takes; the median is of the last 4
GNN_MOLECULES = 128  # the molecule shape's batch of 30-atom graphs
GNN_CPU_MOLECULES = 4  # EquiformerV2's forward held to the CPU's on these
H100_FP32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
# minibatch_lg's source graph: reddit-like, its 232,965 nodes kept and its
# 114,615,892 edges cut to a tenth (the block's static shape is the same)
GNN_SOURCE_EDGES = 11_461_589
GNN_SEEDS = 1024
GNN_LEARN_STEPS = 100  # GAT at lr 0.5 must fall below 0.9 of its first loss
GNN_EXAMPLE_TIMEOUT_S = 300  # the example child is killed past this
# EquiformerV2 at full width on 4 molecules, the card against the CPU on
# the same weights (norm-relative, float32, TF32 off): two runs of this
# phase on an H100 80GB HBM3 at 700 W read 1.38e-6 and 1.32e-6 (sums in
# another order over 12 layers); a wrong rotation or mask is of order one
GNN_CARD_CPU_LIMIT = 1e-5
# the mrestrict variant at full width against the full rotation: the
# restricted rotation exactly (max over max), bf16 edges within 5%
GNN_RESTRICT_LIMIT = 1e-5
GNN_BF16_LIMIT = 0.05
# EquiformerV2's SGD rate at full width.  At make_gnn_train_step's default
# of 1e-3 its loss diverges in 5 steps, the reference's too (the full
# config on the first 4 molecules, the same weights, on the CPU: 29.73,
# 20,847, 70,599, 6.1e7, nan in both); at 1e-6 it falls (29.73 to 2.03 in
# 6 steps).  The step's work does not depend on the rate.
GNN_EQUIFORMER_LR = 1e-6
GNN_GRAD_FLOOR = 1e-4  # as LM_GRAD_FLOOR, for the reduced archs' SGD step
GNN_UPDATE_ULPS = 16  # float32 epsilons of a leaf's largest update


def _gnn_device():
    import torch

    return torch.device("cuda")


def _gnn_steps(step, params, graph, dev, n: int = GNN_STEPS) -> tuple:
    """``n`` SGD steps, each timed with the card synced around it:
    (params, losses, step ms)."""
    losses, ms = [], []
    for _ in range(n):
        (params, loss), t = _timed(dev, step, params, graph)
        losses.append(float(loss))
        ms.append(t)
    return params, losses, ms


def _frozen_leaves(before: dict, params) -> list:
    """The paths of the leaves of ``params`` equal to their host copies in
    ``before``."""
    import torch
    from repro_torch.utils.tree import tree_items

    return sorted("/".join(map(str, path)) for path, t in tree_items(params)
                  if torch.equal(t.cpu(), before[path]))


def _gnn_run(arch: str, shape_id: str, graph, dev, cfg=None,
             steps: int = GNN_STEPS, profile: bool = False,
             lr: float = 1e-3) -> tuple:
    """``steps`` SGD steps of ``make_gnn_train_step`` at ``lr`` at an
    arch's full config for ``shape_id`` from seed-0 weights: the losses
    finite, the step ms (median of all but the first), peak GiB since the
    run began, the analytic model FLOPs and their share of the float32
    peak.  Returns (params, before, line)."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.launch import cells
    from repro_torch.utils.tree import tree_items, tree_leaves

    mod = get_arch(arch)
    shp = GNN_SHAPES[shape_id]
    if cfg is None:
        cfg = mod.full_config(
            d_feat=shp["d_feat"], edge_chunks=shp["edge_chunks"],
            n_classes=shp["n_classes"] if shp["task"] == "cls" else 1)
    torch.cuda.reset_peak_memory_stats()
    params = cells._GNN_MODELS[mod.MODEL].init_params(cfg, device=dev, seed=0)
    before = {path: t.to("cpu", copy=True) for path, t in tree_items(params)}
    step = cells.make_gnn_train_step(mod.MODEL, cfg, shp["task"], lr=lr)
    params, losses, ms = _gnn_steps(step, params, graph, dev, steps)
    peak = peak_gib()
    require(all(math.isfinite(x) for x in losses),
            f"{arch} {shape_id}: non-finite loss {losses}")
    N, E = graph["nodes"].shape[0], graph["edges"].shape[0]
    flops = cells._gnn_analytic_flops(mod.MODEL, cfg, N, E, shp["d_feat"])
    med = statistics.median(ms[1:])
    line = {"phase": "gnn_train", "arch": arch, "shape": shape_id,
            "config": cfg.name, "lr": lr, "params": sum(t.numel() for t in
                                              tree_leaves(params)),
            "nodes": N, "edge_slots": E, "steps": steps, "losses": losses,
            "step_ms": ms, "step_ms_median": med, "peak_gib": peak,
            "model_flop_per_step": flops,
            "model_flop_share_of_fp32_peak": flops / (med / 1e3)
            / H100_FP32_FLOPS,
            "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
    if profile:
        line["profile_one_step"] = _lm_profile(lambda: step(params, graph),
                                               med)
    return params, before, line


def _molecules_graph(n_graphs: int, dev) -> tuple:
    """The molecule shape's batch (30 atoms, 64 edges a graph, seed 0) on
    ``dev``, and its first GNN_CPU_MOLECULES graphs on the CPU."""
    import numpy as np
    from repro_torch.data.graphs import graph_to_device, make_molecules

    g = make_molecules(n_graphs, 30, 64)
    k = GNN_CPU_MOLECULES
    first = {"pos": g["pos"][:30 * k], "species": g["species"][:30 * k],
             "edges": g["edges"][:64 * k], "batch_seg": g["batch_seg"][:30 * k],
             "energy": g["energy"][:k], "nodes": g["nodes"][:30 * k]}
    require(int(np.max(first["edges"])) < 30 * k, "molecules overlap")
    return graph_to_device(g, dev), first


def _gnn_equiformer(dev) -> dict:
    """EquiformerV2 at full width on the molecule shape: GNN_STEPS SGD
    steps (finite losses; every weight moved but the |m| > 0 SO(2) weights
    of the first layer, whose inputs are l = 0 only, and of the last, whose
    l > 0 outputs never reach the invariant readout), a profiled step, the
    card's forward on 4 molecules against the CPU's, and the mrestrict
    variant: its forwards against the full rotation's and its step ms."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_arch, variant_overrides
    from repro_torch.data.graphs import graph_to_device
    from repro_torch.models.gnn import equiformer
    from repro_torch.utils.tree import tree_map

    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmuls are on: float32 numbers would not be float32")
    graph, first = _molecules_graph(GNN_MOLECULES, dev)
    params, before, line = _gnn_run("equiformer-v2", "molecule", graph, dev,
                                    profile=True, lr=GNN_EQUIFORMER_LR)
    line["gather_ab_49x128"] = _gather_ab(graph["nodes"].shape[0], (49, 128),
                                          graph["edges"][:, 0], dev)
    cfg = get_arch("equiformer-v2").full_config()
    L = cfg.n_layers - 1
    expect = sorted(f"layers/{i}/so2/m{m}{c}" for i in (0, L)
                    for m in range(1, cfg.m_max + 1) for c in "ri")
    frozen = _frozen_leaves(before, params)
    require(frozen == expect, f"equiformer-v2: unmoved weights {frozen}, "
                              f"want {expect}")
    line["unmoved_leaves"] = frozen
    del before
    # the card's forward on 4 molecules against the CPU's, same weights
    cpu = torch.device("cpu")
    with torch.no_grad():
        on_card = equiformer.forward(params, graph_to_device(first, dev),
                                     cfg).cpu()
        on_cpu = equiformer.forward(tree_map(lambda t: t.cpu(), params),
                                    graph_to_device(first, cpu), cfg)
    err = _norm_rel_err(on_card, on_cpu)
    require(bool(torch.isfinite(on_card).all()) and err < GNN_CARD_CPU_LIMIT,
            f"equiformer-v2 card vs CPU: norm-relative {err:.3g} (limit "
            f"{GNN_CARD_CPU_LIMIT})")
    line["card_vs_cpu"] = {"molecules": GNN_CPU_MOLECULES,
                           "norm_rel_err": err, "rel_err": _rel_err(
                               on_card, on_cpu),
                           "limit": GNN_CARD_CPU_LIMIT}
    # mrestrict at full width: forwards over the whole batch
    restrict = dataclasses.replace(cfg, rotate_restrict=True)
    mrestrict = dataclasses.replace(cfg, **variant_overrides("mrestrict",
                                                             "gnn"))
    with torch.no_grad():
        o0 = equiformer.forward(params, graph, cfg)
        o1 = equiformer.forward(params, graph, restrict)
        o2 = equiformer.forward(params, graph, mrestrict)
    r1, r2 = _rel_err(o1, o0), _rel_err(o2, o0)
    require(r1 < GNN_RESTRICT_LIMIT and 0 < r2 < GNN_BF16_LIMIT,
            f"mrestrict at full width: restricted {r1:.3g} (limit "
            f"{GNN_RESTRICT_LIMIT}), bf16 edges {r2:.3g} "
            f"(limit {GNN_BF16_LIMIT})")
    del params, o0, o1, o2
    variants = {"restricted_rel_err": r1, "bf16_edges_rel_err": r2}
    for name, vcfg in (("rotate_restrict", restrict),
                       ("mrestrict", mrestrict)):
        _, _, v = _gnn_run("equiformer-v2", "molecule", graph, dev, cfg=vcfg,
                           steps=3, lr=GNN_EQUIFORMER_LR)
        variants[name] = {k: v[k] for k in ("step_ms", "step_ms_median",
                                            "peak_gib", "losses")}
    line["variants"] = variants
    return line


def _gnn_full_graph_sm(dev) -> list:
    """GAT and GatedGCN at full width on Cora's shape (2,708 nodes, 10,556
    edges, 1,433 features, 7 classes); then GAT trained GNN_LEARN_STEPS
    steps at lr 0.5, its loss below 0.9 of the first."""
    from repro_torch.data.graphs import graph_to_device, make_cora_like
    from repro_torch.launch import cells
    from repro_torch.models.gnn import gat

    graph = graph_to_device(make_cora_like(), dev)
    lines = [_gnn_run(a, "full_graph_sm", graph, dev, profile=True)[2]
             for a in ("gat-cora", "gatedgcn")]
    cfg = gat.GATConfig(d_in=1433, n_classes=7)
    step = cells.make_gnn_train_step("gat", cfg, "cls", lr=0.5)
    _, losses, ms = _gnn_steps(step, gat.init_params(cfg, device=dev, seed=0),
                               graph, dev, GNN_LEARN_STEPS)
    require(losses[-1] < 0.9 * losses[0],
            f"GAT did not learn: {losses[::20]}")
    lines[0]["learns"] = {"lr": 0.5, "steps": GNN_LEARN_STEPS,
                          "loss_first": losses[0], "loss_last": losses[-1],
                          "step_ms_median": statistics.median(ms[1:])}
    return lines


def _gather_ab(rows: int, width: tuple, idx, dev) -> dict:
    """A gather of ``rows`` x ``width`` float32 rows by ``idx`` and its
    backward, by event time in turns (A, B, B, A): advanced indexing
    (``h[idx]``; the backward sorts the indices and one warp accumulates
    each run of equal ones) against ``index_select`` (the models' gather;
    the backward is an ``index_add``)."""
    import torch

    h = torch.randn((rows,) + width, device=dev, requires_grad=True)
    g = torch.randn((idx.shape[0],) + width, device=dev)
    fns = {"advanced_index": lambda: torch.autograd.grad(h[idx], h, g),
           "index_select": lambda: torch.autograd.grad(
               h.index_select(0, idx), h, g)}
    out = {"rows_gathered_from_node0": int((idx == 0).sum())}
    for name in ("advanced_index", "index_select", "index_select",
                 "advanced_index"):
        out.setdefault(name + "_ms", []).append(time_ms(fns[name], iters=10))
    return out


def _gnn_minibatch(dev) -> list:
    """GatedGCN and GAT at full width on minibatch_lg: one padded block
    (1,024 seeds, fanouts 15 and 10) drawn by the port's NeighborSampler
    from the reddit-like source graph (edges cut to GNN_SOURCE_EDGES);
    the gather A/B at the block's width-70 rows (its padded slots all
    gather from node 0)."""
    import numpy as np
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.data.graphs import (
        NeighborSampler, block_shape_for, graph_to_device, make_reddit_like,
    )

    shp = GNN_SHAPES["minibatch_lg"]
    t = time.perf_counter()
    src = make_reddit_like(n_nodes=shp["src_nodes"],
                           n_edges=GNN_SOURCE_EDGES, d_feat=shp["d_feat"])
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    sampler = NeighborSampler(src["edges"], shp["src_nodes"], seed=0)
    csr_s = time.perf_counter() - t
    seeds = np.random.default_rng(0).choice(shp["src_nodes"], GNN_SEEDS,
                                            replace=False).astype(np.int32)
    nb, eb = block_shape_for(GNN_SEEDS, shp["fanouts"])
    t = time.perf_counter()
    block = sampler.padded_block(seeds, shp["fanouts"], nb, eb, src["nodes"],
                                 src["labels"])
    sample_s = time.perf_counter() - t
    del src, sampler
    valid = int(((block["edges"][:, 0] >= 0)
                 & (block["edges"][:, 1] >= 0)).sum())
    require(block["nodes"].shape == (169_984, 602) and eb == 168_960
            and block["edges"].shape == (eb, 2) and valid > 0,
            f"block {block['nodes'].shape} {block['edges'].shape}")
    graph = graph_to_device(block, dev)
    host = {"source_edges": GNN_SOURCE_EDGES, "source_nodes": shp["src_nodes"],
            "generate_s": gen_s, "csr_s": csr_s, "sample_block_s": sample_s,
            "valid_edges": valid, "seeds": GNN_SEEDS,
            "gather_ab_width_70": _gather_ab(
                nb, (70,), graph["edges"][:, 0].clamp(min=0), dev)}
    lines = []
    for arch in ("gatedgcn", "gat-cora"):
        line = _gnn_run(arch, "minibatch_lg", graph, dev, profile=True)[2]
        line["block"] = host
        lines.append(line)
    return lines


def _sgd_update_err(got, old_got, want, old_want) -> float:
    """The card's SGD update ``got - old_got`` against the CPU's ``want -
    old_want``: the largest error over ``1e-3 |want update|`` plus 4
    float32 spacings of ``|old|`` and GNN_UPDATE_ULPS epsilons of the
    leaf's largest update, over the weights whose CPU gradient is zero or
    above GNN_GRAD_FLOOR of the leaf's largest; the rest are held to two
    steps' ``2 lr``.  A value of 1 or more fails."""
    import numpy as np

    old = old_want.double().numpy()
    want_d = want.double().numpy() - old
    got_d = got.double().numpy() - old_got.double().numpy()
    err = np.abs(got_d - want_d)
    g = np.abs(want_d)
    held = (g == 0) | (g > GNN_GRAD_FLOOR * g.max())
    limit = (1e-3 * g + 4 * np.spacing(np.abs(old).astype(np.float32))
             + GNN_UPDATE_ULPS * np.finfo(np.float32).eps * g.max())
    worst = float((err / limit)[held].max()) if held.any() else 0.0
    free = float(err[~held].max() / 2e-3) if (~held).any() else 0.0
    return max(worst, free)


def _gnn_reduced_archs(dev) -> dict:
    """The four GNN archs' reduced configs on the reference smoke test's
    graphs: forward, unified loss and one SGD step on the card against the
    port's CPU run from the same weights (outputs and loss rtol=atol=1e-4;
    each weight's update by ``_sgd_update_err``)."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.graphs import (
        graph_to_device, make_cora_like, make_molecules,
    )
    from repro_torch.launch import cells
    from repro_torch.models.gnn import common
    from repro_torch.utils.tree import tree_items

    out = {}
    for arch, mod in ARCHS.items():
        if mod.FAMILY != "gnn":
            continue
        if mod.MODEL in ("schnet", "equiformer"):
            task, cfg, g = "reg", mod.reduced_config(), make_molecules(4, 8, 16)
        else:
            task, cfg = "cls", mod.reduced_config(d_feat=64, n_classes=7)
            g = make_cora_like(n_nodes=120, n_edges=480, d_feat=64, seed=2)
        model = cells._GNN_MODELS[mod.MODEL]
        w = common.params_to_reference(model.init_params(cfg, device="cpu",
                                                         seed=5))
        step = cells.make_gnn_train_step(mod.MODEL, cfg, task)
        runs = {}
        for d in (dev, torch.device("cpu")):
            p = model.params_from_reference(w, cfg, d)
            graph = graph_to_device(g, d)
            with torch.no_grad():
                fwd = model.forward(p, graph, cfg).cpu()
                loss = cells.gnn_unified_loss(mod.MODEL, p, graph, cfg,
                                              task).cpu()
            p1, _ = step(p, graph)
            runs[d.type] = (fwd, loss, dict(tree_items(p)),
                            dict(tree_items(p1)))
        (f1, l1, q0, q1), (f0, l0, c0, c1) = runs[dev.type], runs["cpu"]
        require(torch.allclose(f1, f0, rtol=1e-4, atol=1e-4)
                and torch.allclose(l1, l0, rtol=1e-4, atol=1e-4),
                f"{arch}: card and CPU differ by {float((f1 - f0).abs().max())}"
                f" (forward), {float((l1 - l0).abs())} (loss)")
        upd = max(_sgd_update_err(q1[k].cpu(), q0[k].cpu(), c1[k], c0[k])
                  for k in c1)
        require(upd < 1.0, f"{arch}: the card's update off by {upd:.3g} of "
                           f"its limit")
        out[arch] = {"loss": float(l1), "forward_max_err":
                     float((f1 - f0).abs().max()),
                     "loss_err": float((l1 - l0).abs()),
                     "update_share_of_limit": upd}
    return out


def _gnn_example(dev) -> dict:
    """``examples/train_gnn_torch.py --steps 50`` as a child on the card:
    exit 0, the interval filter's line, the last logged loss below the
    first."""
    import os
    import re

    cmd = [sys.executable, str(ROOT / "examples" / "train_gnn_torch.py"),
           "--steps", "50"]
    t = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=GNN_EXAMPLE_TIMEOUT_S,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    seconds = time.perf_counter() - t
    require(out.returncode == 0, f"the example exited {out.returncode}:\n"
                                 f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
    losses = [float(x) for x in
              re.findall(r"^step +\d+: loss=([-0-9.naif]+)", out.stdout, re.M)]
    require(out.stdout.startswith("semantic filter relatedTo: kept ")
            and len(losses) == 3 and all(map(math.isfinite, losses))
            and losses[-1] < losses[0],
            f"the example's output: {out.stdout[-2000:]}")
    return {"cmd": " ".join(cmd[1:]), "seconds": seconds,
            "logged_losses": losses,
            "filter_line": out.stdout.splitlines()[0]}


def phase_gnn():
    """The GNN family on the card: EquiformerV2 at full width on the
    molecule shape (steps, profile, card vs CPU, mrestrict), SchNet on the
    molecule shape, GAT and GatedGCN on full_graph_sm and minibatch_lg,
    the reduced archs against their CPU runs, and the GAT example."""
    import torch

    dev = _gnn_device()
    card = nvidia_smi()

    def report(line: dict) -> None:  # each line names the card
        emit({**line, "card": card})

    report({"phase": "gnn_start", "memory_allocated_gib":
            torch.cuda.memory_allocated() / 2**30})
    report(_gnn_equiformer(dev))
    torch.cuda.empty_cache()
    graph, _ = _molecules_graph(GNN_MOLECULES, dev)
    report(_gnn_run("schnet", "molecule", graph, dev, profile=True)[2])
    del graph
    for line in _gnn_full_graph_sm(dev) + _gnn_minibatch(dev):
        report(line)
    torch.cuda.empty_cache()
    report({"phase": "gnn_reduced", "archs": _gnn_reduced_archs(dev)})
    report({"phase": "gnn_example", **_gnn_example(dev)})


def main(argv: list[str]) -> int:
    import gc
    import os

    # the lm phase's resume check runs under deterministic algorithms,
    # which need cuBLAS's workspace fixed before its first product (the
    # H100's default size, 8 buffers of 4 MiB)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core.engine  # noqa: F401  (fails outside a checkout)

    kind, count = phase_device()
    if argv[:1] == ["--lm-spread"]:
        lm_spread(int(argv[1]))
        return 0
    phase_build()
    launches = {}
    kb1 = drive(launches, phase_lubm1,
                need=("compact_mask", "masked_interval_compact", "pair_range",
                      "member_compact"))
    drive(launches, phase_quickstart, need=("pass/compact", "member_compact"))
    kb100, raw = drive(launches, phase_lubm100,
                       need=("compact_mask", "merge_path",
                             "pass/merge_partitioned"))
    drive(launches, phase_lubm100_rewrite, kb100,
          need=("compact_mask", "member_compact"))
    drive(launches, phase_lubm100_sharded, kb100, raw,
          need=("compact_mask", "masked_interval_compact", "member_compact",
                "compact_mask_batched", "masked_interval_compact_batched",
                "member_compact_batched"))
    drive(launches, phase_lubm100_sharded_devices, kb100, raw,
          need=("compact_mask", "masked_interval_compact", "member_compact",
                "pair_range"))
    # the children's launches are theirs: the phase checks what they print
    drive(launches, phase_lubm100_multiprocess, kb100, raw)
    small_cap = drive(launches, phase_lubm100_live, kb100, raw,
                      need=("compact_mask", "member_compact", "pair_range",
                            "merge_path_resident", "merge_path"))
    api = drive(launches, phase_lubm100_kernel_api, kb100,
                need=("pair_search", "dual_compact", "interval_tiles",
                      "interval_filter", "msc_select", "closure_expand",
                      "pass/dual_compact"))
    drive(launches, phase_lubm100_serving, kb100, raw,
          need=("compact_mask_batched", "masked_interval_compact_batched",
                "member_compact_batched"))
    drive(launches, phase_lubm100_telemetry, kb100, raw,
          need=("compact_mask", "merge_path"))
    del raw
    phase_kernels(kb1, kb100, launches, small_cap, api)
    del kb1, kb100, api, small_cap
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm_window = {}
    drive(lm_window, phase_lm)
    require(not any(lm_window.values()),
            f"the lm phase launched a hand-written kernel: {lm_window}")
    gc.collect()
    torch.cuda.empty_cache()
    gnn_window = {}
    drive(gnn_window, phase_gnn)
    require(not any(gnn_window.values()),
            f"the gnn phase launched a hand-written kernel: {gnn_window}")
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
