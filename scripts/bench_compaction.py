#!/usr/bin/env python3
"""Time the single-pass compactions (K1, K2, K4, and K7 through its
``ops`` entry point), the batched K2 and K4 (the serving phase's
``(?x rdf:type C)`` family: K2 over ten and sixteen members, K4 over its
largest rewrite group, and the same sets without the domain and range
branches; the cost per member from K2 over its first one and four members
and K4 over one, and each with cap 0, no writes) and the
kernel-API kernels K10 and K11 at
LUBM-100's shapes on one GPU, beside two yardsticks of the card's
streaming rate over the same store: a copy of the lite store and the
interval filter (K9), which read the same rows and keep nothing.  K11 is
also timed on a synthetic table past its staging limit (``k11_large_c``:
213,000 sorted ids, D = 8, LUBM-100's query count, half of the queries
hits).  Last, a ``ptxas`` line: the look-back compactions' registers and
spills (``chip_smoke.ptxas_lines``).

    python3 scripts/bench_compaction.py [SRC]

``SRC`` (default: the checkout's ``src``) is the directory to import
``repro_torch`` from, so a copy of the tree with a changed kernel can be
timed against this one on the same card, one process each; K7, K10 and
K11 are timed through calls every tree since K7's port has
(``ops.dual_compact_indices``, ``msc_select``, ``closure_expand``), the
batched K2 and K4 through their wrappers (every tree since they came).
Prints one ``name {json}`` line per measurement: ``ms`` (CUDA events per
call, back to back), ``event_ms`` (CUDA events around calls enqueued
behind a sleep kernel: the device time alone), ``split`` (profiler device
ms per call by kernel name) and, for the compactions, the match totals and
the cap.  Needs a CUDA device; builds LUBM-100 (seed 0) first, about 20 s.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    src = sys.argv[1] if len(sys.argv) > 1 else str(ROOT / "src")
    sys.path[:0] = [src, str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("bench_compaction: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
    from repro_torch.core.index import pow2_bucket
    from repro_torch.core.materialize import INVALID, candidate_types
    from repro_torch.core.query import QueryEngine
    from repro_torch.kernels import build
    from repro_torch.kernels import closure_expand as ce
    from repro_torch.kernels import interval_filter as itf
    from repro_torch.kernels import msc_select as msc
    from repro_torch.kernels import ops
    from repro_torch.kernels import stream_compact as sc
    from repro_torch.launch.serve import CLASSES
    from repro_torch.rdf.generator import generate_lubm

    print(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), "src", sc.__file__, flush=True)
    kb = KnowledgeBase.build(generate_lubm(100, seed=0))
    dev = kb.device
    out = {}

    def timed(name, fn, **extra):
        out[name] = {"ms": cs.time_ms(fn, 50), "event_ms": cs.event_ms(fn, 50),
                     "split": cs.device_split(fn, 50), **extra}

    # the yardsticks: the lite store's rows copied, and filtered (K9)
    lite = kb.lite_spo
    n = lite.shape[0]
    eng = QueryEngine(kb=kb.kb, spo=lite, mode="litemat", dtb=kb.dtb,
                      view=kb.view("litemat"), use_index=False)
    q1 = eng._prepare(PAPER_QUERIES["Q1"])[0][1]
    params = (q1[1].lo, q1[1].hi, q1[2].lo, q1[2].hi)
    p, o = lite[:, 1], lite[:, 2]
    timed("store_copy", lambda: lite.clone())
    timed("k9_filter", lambda: itf.interval_filter(p, o, params))

    # K1 at store size (memberOf's run) and at Q2's distinct
    q2 = eng._prepare(PAPER_QUERIES["Q2"])[0][1]
    mask = (lite[:, 1] >= q2[1].lo) & (lite[:, 1] < q2[1].hi)
    keep = torch.arange(1 << 21, device=dev) < 1_133_328
    for name, m in (("k1_store", mask), ("k1_distinct", keep)):
        cs._exact(name, sc.compact_mask(m, 1 << 21),
                  sc.compact_mask_plain(m, 1 << 21))
        timed(name, lambda m=m: sc.compact_mask(m, 1 << 21))

    # K2: Q1's fused scan, and the same scan matching no row
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    cap = cs._plan_cap(eng, PAPER_QUERIES["Q1"])
    none = (params[0], params[0], params[2], params[3])
    for name, prm in (("k2", params), ("k2_no_match", none)):
        got = sc.masked_interval_compact(p, o, alive, prm, cap)
        cs._exact(name, got,
                  sc.masked_interval_compact_plain(p, o, alive, prm, cap))
        timed(name, lambda prm=prm: sc.masked_interval_compact(
            p, o, alive, prm, cap), totals=[int(got[2])], cap=cap)

    # K4 over the raw store: Q4's Chair (one stream), Q1's Professor (two),
    # and the two-stream call without its writes (cap 0) or its matches
    # (an all-padding range set)
    raw = kb.kb.spo
    cols = (raw[:, 0], raw[:, 1], raw[:, 2])
    ralive = torch.ones(raw.shape[0], dtype=torch.bool, device=dev)
    reng = kb.engine("rewrite")
    pad = cs._id_set(torch.zeros(0, device=dev), 8, dev)
    cases = []
    for name, pats in (("k4_one_stream", PAPER_QUERIES["Q4"][:1]),
                       ("k4_two_streams", PAPER_QUERIES["Q1"])):
        tid, mem, dom, rng, has_dom, has_rng = cs._rewrite_sets(reng, pats)
        cases.append((name, (*cols, ralive, tid, mem, dom, rng, has_dom,
                             has_rng, cs._plan_cap(reng, pats))))
    cases += [("k4_two_streams_cap0", (*cases[1][1][:-1], 0)),
              ("k4_two_streams_no_range_match",
               (*cases[1][1][:7], pad, *cases[1][1][8:]))]
    for name, args in cases:
        got = sc.member_compact(*args)
        cs._exact(name, [t for x in got for t in x],
                  [t for x in sc.member_compact_plain(*args) for t in x])
        timed(name, lambda a=args: sc.member_compact(*a),
              totals=[int(x[2]) for x in got], cap=args[-1])

    # K7 through ops.dual_compact_indices: Q1's Professor member masks over
    # the raw store (both fresh, so at one alignment), mask b one byte off
    # (two loads per 16 rows), both one byte off (one each), and no writes
    tid, mem, dom, rng, has_dom, has_rng = cs._rewrite_sets(
        reng, PAPER_QUERIES["Q1"])
    ms_, mo_ = sc.member_masks(*cols, ralive, tid, mem, dom, rng, has_dom,
                               has_rng)
    cap7 = pow2_bucket(max(int(ms_.sum()), int(mo_.sum())))

    def off1(m):
        return torch.cat([m[:1], m])[1:]

    for name, a, b, c in (("k7_ops", ms_, mo_, cap7),
                          ("k7_ops_b_off1", ms_, off1(mo_), cap7),
                          ("k7_ops_both_off1", off1(ms_), off1(mo_), cap7),
                          ("k7_ops_cap0", ms_, mo_, 0)):
        got = ops.dual_compact_indices(a, b, c)
        want = sc.compact_mask_plain(a, c) + sc.compact_mask_plain(b, c)
        cs._exact(name, got, want)
        timed(name, lambda a=a, b=b, c=c: ops.dual_compact_indices(a, b, c),
              totals=[int(got[2]), int(got[5])], cap=c)

    # the batched K2 and K4: the (?x rdf:type C) family's fused scan over
    # the lite store at ten members (launch/serve.py's classes) and sixteen
    # (the runtime's max_batch), and its largest rewrite group (two
    # members, both streams) over the raw store
    bk = cs._batched_args(kb, keys=("k2", "k4"))
    bk["k2_16"] = cs._batched_args(kb, CLASSES + cs.SERVING_CLASSES_16,
                                   ("k2",))["k2"]
    for name, key in (("k2_batched", "k2"), ("k2_batched_16", "k2_16")):
        a = bk[key]
        got = sc.masked_interval_compact_batched(*a)
        cs._exact(name, got, sc.masked_interval_compact_batched_plain(*a))
        timed(name, lambda a=a: sc.masked_interval_compact_batched(*a),
              members=int(a[3].shape[0]), totals=got[2].tolist(), cap=a[4])
    # K2's cost per member: the first 1 and 4 members, and the ten with no
    # writes (cap 0, outputs are totals only)
    p2, o2, a2, prm2, cap2 = bk["k2"]
    for name, prm, c in (("k2_batched_b1", prm2[:1], cap2),
                         ("k2_batched_b4", prm2[:4], cap2),
                         ("k2_batched_cap0", prm2, 0)):
        prm = prm.contiguous()
        timed(name, lambda prm=prm, c=c: sc.masked_interval_compact_batched(
            p2, o2, a2, prm, c), members=int(prm.shape[0]), cap=c)
    spo4, a4, tid4, mem4, dom4, rng4, cap4, hd4, hr4 = bk["k4"]
    k4b = (spo4[:, 0], spo4[:, 1], spo4[:, 2], a4, tid4, mem4, dom4, rng4,
           hd4, hr4, cap4)
    got = sc.member_compact_batched(*k4b)
    cs._exact("k4_batched", [t for x in got for t in x],
              [t for x in sc.member_compact_batched_plain(*k4b) for t in x])
    timed("k4_batched", lambda: sc.member_compact_batched(*k4b),
          members=int(mem4.shape[0]), streams=len(got),
          totals=[x[2].tolist() for x in got], cap=cap4)
    # the rewrite type pattern with no domain or range sets
    # (MemberGroup<false, false>)
    k4n = (*k4b[:8], False, False, cap4)
    got = sc.member_compact_batched(*k4n)
    cs._exact("k4_batched_no_branches", [t for x in got for t in x],
              [t for x in sc.member_compact_batched_plain(*k4n) for t in x])
    timed("k4_batched_no_branches", lambda: sc.member_compact_batched(*k4n),
          members=int(mem4.shape[0]), cap=cap4, totals=got[0][2].tolist())
    timed("k4_batched_b1", lambda: sc.member_compact_batched(
        *k4b[:5], mem4[:1], dom4[:1], rng4[:1], *k4b[8:]), members=1,
        cap=cap4)
    timed("k4_batched_cap0", lambda: sc.member_compact_batched(
        *k4b[:-1], 0), members=int(mem4.shape[0]), cap=0)
    del bk

    # K10 on the candidate types grouped by instance; K11 on the candidate
    # types' concepts (phase lubm100_kernel_api's inputs)
    inst, conc, _ = candidate_types(raw, kb.dtb)
    cvalid = inst != INVALID
    c_inst, c_conc = inst[cvalid], conc[cvalid]
    conc_g, bounds_g = cs.msc_groups(c_inst, c_conc, kb.dtb)[3:]
    cs._exact("k10", [msc.msc_select(conc_g, bounds_g)],
              [msc.msc_select_plain(conc_g, bounds_g)])
    timed("k10", lambda: msc.msc_select(conc_g, bounds_g),
          shape=list(conc_g.shape))
    ids, anc = kb.dtb.concept_sorted_ids, kb.dtb.concept_ancestors
    cs._exact("k11", [ce.closure_expand(c_conc, ids, anc)],
              [ce.closure_expand_plain(c_conc, ids, anc)])
    timed("k11", lambda: ce.closure_expand(c_conc, ids, anc),
          shape=[int(c_conc.shape[0]), int(ids.shape[0]), int(anc.shape[1])])
    # K11, synthetic: Wikidata's 213,000 concept ids (the scale the
    # reference's kernel names), D = 8, LUBM-100's query count, half hits
    gen = torch.Generator(device=dev).manual_seed(0)
    nq, big_c = c_conc.shape[0], 213_000
    big_ids = torch.randint(1, 2 * (1 << 24) // big_c + 1, (big_c,),
                            generator=gen, device=dev).cumsum(0).to(torch.int32)
    big_anc = torch.randint(-1, 1 << 20, (big_c, 8), generator=gen,
                            device=dev, dtype=torch.int32)
    big_q = torch.randint(0, int(big_ids[-1]) + 1, (nq,), generator=gen,
                          device=dev, dtype=torch.int32)
    big_q[::2] = big_ids[torch.randint(0, big_c, ((nq + 1) // 2,),
                                       generator=gen, device=dev)]
    cs._exact("k11_large_c", [ce.closure_expand(big_q, big_ids, big_anc)],
              [ce.closure_expand_plain(big_q, big_ids, big_anc)])
    timed("k11_large_c", lambda: ce.closure_expand(big_q, big_ids, big_anc),
          shape=[int(nq), big_c, 8], synthetic=True,
          hits=int(torch.isin(big_q, big_ids).sum()))
    for name, v in out.items():
        print(name, json.dumps(v), flush=True)
    print("ptxas", json.dumps(cs.ptxas_lines(
        build.BUILD_LOG.get("stream_compact", ""), "compact_lookback")),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
