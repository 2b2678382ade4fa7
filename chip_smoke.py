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
                ``window`` line each), and the line sums the eight windows.
                The scratch builds the checks compare against run with the
                counters set back, so only the main path's launches count.

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
    from repro_torch.kernels import ops

    for fn in _counters()[0].values():
        fn.launches = 0
    ops.reset_pass_counters()


def drive(total: dict, phase, *args, need=()):
    """Run one main-path phase in its own launch window: every counter is
    zeroed just before it and read just after; the window is printed,
    each counter in ``need`` must have moved in it, and it is added to
    ``total``.  Returns the phase's result."""
    zero_counts()
    out = phase(*args)
    window = read_counts()
    emit({"window": phase.__name__, "launches": window})
    for k in need:
        require(window[k] > 0, f"{phase.__name__} never launched {k}")
    for k, v in window.items():
        total[k] = total.get(k, 0) + v
    return out


@contextlib.contextmanager
def uncounted():
    """Set every counter back to its value on entry when the block ends:
    what a check runs on the side is no launch of the main path."""
    saved = read_counts()
    yield
    wrappers, passes = _counters()
    for name, fn in wrappers.items():
        fn.launches = saved[name]
    for k in passes:
        passes[k] = saved[f"pass/{k}"]


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
          "store_size_compaction": store_scan, "peak_gib": peak_gib()})
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
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
