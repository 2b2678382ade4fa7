#!/usr/bin/env python3
"""Where the snapshot-isolated runtime spends its time under an insert
stream (``launch/serve.py --concurrent``), on one GPU.

    python3 scripts/serving_diag.py [--universities 100] [--requests 128]

Builds LUBM-N (seed 0), then prints one ``name {json}`` line per step:

  * ``insert_publish`` — five 64-row inserts, each followed by a publish
    of the runtime's snapshot registry, alone on one thread: seconds each,
    and the ten functions of the port with the most cumulative time
    (cProfile);
  * ``runtime_quiet`` — the runtime (2 workers) answering ``--requests``
    requests (the paper queries and the serving families of
    ``chip_smoke.py``) with no writer: wall seconds and latency;
  * ``runtime_stream`` — the same with the background 64-row insert
    stream, and where each thread was, sampled every 2 ms from
    ``sys._current_frames`` (the innermost frame in ``repro_torch``, else
    the innermost frame);
  * ``runtime_stream_switch`` — the same with the interpreter's thread
    switch interval at 0.1 ms instead of 5 ms (``sys.setswitchinterval``):
    how much of the time is threads waiting for the GIL.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import cProfile
import json
import pstats
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _where(frame) -> str:
    inner = frame
    while frame is not None:
        if "repro_torch" in frame.f_code.co_filename:
            code = frame.f_code
            return f"{Path(code.co_filename).name}:{code.co_name}"
        frame = frame.f_back
    code = inner.f_code
    return f"{Path(code.co_filename).name}:{code.co_name}"


class Sampler:
    """Every ``period_s``, the innermost port frame of each named thread."""

    def __init__(self, period_s: float = 0.002):
        self.period_s = period_s
        self.counts: dict = collections.defaultdict(collections.Counter)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        me = threading.get_ident()
        while not self._stop.wait(self.period_s):
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                name = names.get(ident, "?").rstrip("0123456789-")
                self.counts[name][_where(frame)] += 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def top(self, k: int = 8) -> dict:
        return {name: c.most_common(k) for name, c in self.counts.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--universities", type=int, default=100)
    ap.add_argument("--requests", type=int, default=128)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("serving_diag: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
    from repro_torch.launch.serve import run_concurrent
    from repro_torch.rdf.generator import generate_lubm
    from repro_torch.core.snapshot import SnapshotRegistry

    print(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    raw = generate_lubm(args.universities, seed=0)
    kb = KnowledgeBase.build(raw)
    queries = list(PAPER_QUERIES.values()) + [
        q for qs in cs.serving_families().values() for q in qs]
    s, p, o = np.asarray(raw.s), np.asarray(raw.p), np.asarray(raw.o)

    reg = SnapshotRegistry(kb)
    reg.prewarm(queries)
    prof = cProfile.Profile()
    times = []
    for i in range(5):
        t0 = time.perf_counter()
        prof.enable()
        with kb.write_lock:
            kb.insert((s[i * 64:(i + 1) * 64], p[i * 64:(i + 1) * 64],
                       o[i * 64:(i + 1) * 64]), auto_compact=False)
            reg.publish()
        prof.disable()
        times.append(time.perf_counter() - t0)
    stats = pstats.Stats(prof)
    top = sorted(((v[3], f"{Path(k[0]).name}:{k[2]}")
                  for k, v in stats.stats.items() if "repro_torch" in k[0]),
                 reverse=True)[:10]
    print("insert_publish", json.dumps({"seconds": times, "top_cum_s": top}),
          flush=True)

    def runtime(name: str, stream: bool, switch_s: float | None = None):
        ns = argparse.Namespace(workers=2, max_queue=args.requests + 8,
                                deadline_s=None, requests=args.requests,
                                seed=0)
        old = sys.getswitchinterval()
        if switch_s is not None:
            sys.setswitchinterval(switch_s)
        try:
            t0 = time.perf_counter()
            with Sampler() as smp:
                out = run_concurrent(kb, raw if stream else None, ns,
                                     queries=queries)
            wall = time.perf_counter() - t0
        finally:
            sys.setswitchinterval(old)
        print(name, json.dumps({
            "wall_s": wall, "latency": out["latency"],
            "updates": out["stats"]["updates"],
            "ok": sum(x.ok for x in out["outcomes"]),
            "stale_served": out["stats"]["stale_served"],
            "where": smp.top()}), flush=True)

    runtime("runtime_quiet", stream=False)
    runtime("runtime_stream", stream=True)
    runtime("runtime_stream_switch", stream=True, switch_s=1e-4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
