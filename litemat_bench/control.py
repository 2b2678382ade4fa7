"""The control: the reference in the program's place, with one guarantee
that the configuration states broken, judged by the same comparison as a
run.  It has to come out as not correct; its readings set the upper end of
each limit (see PERF.md).

    python3 -m litemat_bench.control --workload <name> --seeds 11 12 13 \\
        [--requests N]

The guarantee broken is set semantics, the step a later change would be
tempted to skip because its sort is the costliest work on both paths: a
facet count that counts every most specific (instance, class) row under the
class instead of distinct instances, and a full store that keeps every
derivation instead of each entailed triple once.  A facet control answers
the first ``--requests`` requests the seed draws, as many as a run answers.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from litemat_bench import checks, data, spec
from litemat_bench.reference.rdfs import Entailment
from litemat_bench.workload import RequestStream


def readings(cell, seed: int, device, n_requests: int) -> dict:
    """The numbers a run compares, for the control in the program's place."""
    cols, _ = data.raw_columns(cell.config)
    traffic = cell.traffic
    if traffic["driver"] == "serve_closed_loop":
        keys = RequestStream(traffic, seed).take(n_requests)
        E = Entailment.build(*cols, device=device)
        expected = checks.facet_expected(E, set(keys))
        topk = int(traffic["topk"])
        answers = checks.control_facet_answers(E, keys, expected, topk)
        return checks.facet_checks(answers, expected, topk, 0)
    E = Entailment.build(*cols, device=device)
    lite, bag = E.lite_store(), E.full_store(distinct=False)
    rows = [(lite.shape[0], bag.shape[0])]
    return checks.load_checks(E, lite, bag, rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=400)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        found = readings(cell, seed, torch.device("cuda"), args.requests)
        correct = all(v <= checks.LIMITS[k] for k, v in found.items())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": correct, "checks": found,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
