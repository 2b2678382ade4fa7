"""One run of one benchmark cell.

    python3 -m litemat_bench.run --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.  It
sets up the program (``src/repro_torch``) on the cell's configuration, warms
it, measures for ``--seconds``, judges what the window produced against the
plain reference, and prints one JSON line as the last line of standard
output: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics with the device's busy time and a breakdown (``--trace 1``).  The
numbers compared, each with its limit, are the last lines of standard error
and the last key of the JSON line.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def foreign_modules(names=None) -> list:
    """Loaded modules whose top-level name (up to the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def _program_path() -> None:
    """Put the program's package directory first on the import path."""
    from litemat_bench.spec import ROOT
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"no program at {src / 'repro_torch'}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> dict:
    """Set up, measure, read the metrics and judge; returns the result."""
    import torch

    from litemat_bench import checks, devtrace
    from litemat_bench.drive import DRIVERS, Context
    from litemat_bench.spec import reader

    _program_path()
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                  device=torch.device(device))
    run, judge = DRIVERS[cell.traffic["driver"]](ctx, t_start)
    metrics = {}
    for kind, entries in (("metrics", cell.per_layer) if trace else
                          ("end_to_end", cell.end_to_end),):
        for m in entries:
            v = reader(kind, m["name"])(run)
            if v is None:
                if not trace and ctx.cuda:
                    raise RuntimeError(f"nothing to read for {m['name']}")
                continue
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.cuda else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.cuda
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    result = {"correct": False, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = devtrace.busy_s(run.ops, run.t_open, run.t_close)
        dev["window_s"] = run.t_close - run.t_open
        spans = [s[:4] for s in run.spans]
        result["breakdown"] = {
            "device_ops": devtrace.top_ops(run.ops, run.t_open, run.t_close),
            "idle_gaps": devtrace.idle_by_span(run.ops, spans, run.t_open,
                                               run.t_close)}
    print("setup " + json.dumps({k: round(v, 3) for k, v in run.phases.items()}),
          file=sys.stderr)
    t = time.perf_counter()
    found = judge()
    print(f"judged in {time.perf_counter() - t:.3f} s", file=sys.stderr)
    result["correct"] = all(v <= checks.LIMITS[k] for k, v in found.items())
    result["checks"] = {k: {"value": v, "limit": checks.LIMITS[k]}
                        for k, v in found.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from litemat_bench.spec import cell as find_cell
    cell = find_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the program on the "
              "GPU", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0")
    foreign = foreign_modules()
    if foreign:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(foreign), file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
