"""End to end on the PyTorch port (the paper's workload at serving
scale):

generate a multi-university LUBM-style KB (~0.5M triples by default) ->
OBE-encode -> lite-materialize -> serve batched parameterized SPARQL-style
queries through the batched LiteMat plans, with a completeness audit
against the full-materialization and rewriting baselines — then keep
serving while the store takes live inserts: the delta overlay absorbs the
new triples without a rebuild, and the server notices the version bump by
itself (no invalidate() call anywhere in this file).

    PYTHONPATH=src python examples/serve_queries_torch.py [--universities 4]
    PYTHONPATH=src python examples/serve_queries_torch.py --device cpu

It runs on CUDA, which must exist, unless ``--device`` names another
device.
"""
import argparse
import time

import numpy as np

from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
from repro_torch.device import resolve_device
from repro_torch.rdf.generator import generate_lubm
from repro_torch.serving.engine import QueryServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--universities", type=int, default=4)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.time()
    raw = generate_lubm(args.universities, seed=0)
    print(f"generated {raw.n_triples:,} triples in {time.time()-t0:.1f}s")

    t0 = time.time()
    K = KnowledgeBase.build(raw, device=device)
    print(f"encoded + materialized in {time.time()-t0:.1f}s on {device}; "
          f"sizes={K.sizes()}")

    # pre-plan the Q1-Q4 queries so the first live query pays no planning
    # (the plan cache is otherwise populated lazily per bucket)
    t0 = time.time()
    n_plans = K.prewarm()
    print(f"prewarmed {n_plans} query plans in {time.time()-t0:.1f}s")

    # completeness audit (the paper's own validation)
    audit = {}
    for qn, pats in PAPER_QUERIES.items():
        res = {m: K.answers(pats, mode=m) for m in ("litemat", "full", "rewrite")}
        assert res["litemat"] == res["full"] == res["rewrite"], qn
        audit[qn] = len(res["litemat"])
        print(f"  {qn}: {audit[qn]:,} answers — complete in all 3 modes")

    srv = QueryServer(K)
    classes = ["Professor", "Student", "Faculty", "Person", "Course",
               "Publication", "Organization", "Department"]
    rng = np.random.default_rng(0)
    srv.class_members(classes)  # warm the plans

    t0 = time.time()
    total = 0
    for _ in range(args.batches):
        names = [classes[i] for i in rng.integers(0, len(classes), args.batch)]
        counts, members = srv.class_members(names)
        total += len(names)
    wall = time.time() - t0
    print(f"served {total:,} class-member queries in {wall:.2f}s "
          f"-> {total/wall:,.0f} q/s (batch={args.batch})")

    # ---- live updates: insert while serving -------------------------------
    before, _ = srv.class_members(["Student"])
    # a brand-new university: every instance term is new to the dictionary
    delta = generate_lubm(1, seed=1234, univ_offset=args.universities)
    t0 = time.time()
    st = K.insert(delta, auto_compact=False)
    print(f"inserted {st['n_inserted']:,} triples "
          f"({st['n_new_terms']:,} new terms) in {time.time()-t0:.2f}s "
          f"-> delta ratio {st['delta_ratio']:.3f}, version {K.version}")
    after, _ = srv.class_members(["Student"])  # picks up the delta by itself
    print(f"Student members {int(before[0]):,} -> {int(after[0]):,} "
          "(server re-synced automatically)")
    assert int(after[0]) > int(before[0])

    # compaction folds the overlay back into the base stores (sorted merge)
    t0 = time.time()
    K.compact()
    t_compact = time.time() - t0
    stable, _ = srv.class_members(["Student"])
    print(f"compacted to sizes={K.sizes()} in {t_compact:.2f}s; "
          f"answers stable: {int(stable[0]) == int(after[0])}")
    return {"audit": audit, "served": total, "student_before": int(before[0]),
            "student_after": int(after[0]), "student_stable": int(stable[0])}


if __name__ == "__main__":
    main()
