"""The drivers a traffic mix names: set-up, the measured window, the check.

``serve_closed_loop`` serves facet requests through the program's
``ServingRuntime`` (``submit_class_members`` / ``submit_class_prop_join``,
batched into ``QueryServer``'s plans), from one client thread that keeps
``outstanding`` requests in flight and issues the next one as each resolves.
``bulk_load`` runs ``KnowledgeBase.build`` over the configuration's raw
columns one build after another, each store freed before the next; its
window ends when the build running at ``--seconds`` finishes.

Each driver returns a :class:`Run` (what the metric readers read) and a
judge that decodes the program's outputs through the program's dictionary,
frees the program's state, and compares with the reference.
"""
from __future__ import annotations

import gc
import queue
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from litemat_bench import checks, data
from litemat_bench.devtrace import WindowProfile
from litemat_bench.frozen import ontology as onto
from litemat_bench.reference.rdfs import Entailment
from litemat_bench.workload import RequestStream


@dataclass
class Run:
    """What a run measured, on the ``time.perf_counter`` clock."""

    kind: str  # the driver's name
    n_raw: int
    t_open: float = 0.0
    t_close: float = 0.0  # end of the window the rates divide by
    setup_s: float = 0.0
    peak_bytes: int = 0
    traced: bool = False
    requests: list = field(default_factory=list)  # serve: one dict each
    builds: list = field(default_factory=list)  # load: one dict each
    spans: list = field(default_factory=list)  # (name, start, end, depth, group)
    ops: list = field(default_factory=list)  # device (name, start, end)
    hist: dict = field(default_factory=dict)  # histogram -> (count, sum) in window
    attempted: int = 0
    failed: int = 0
    phases: dict = field(default_factory=dict)  # set-up seconds by phase


@dataclass
class Context:
    cell: object  # spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def port_raw(cols):
    """The benchmark's columns and frozen ontology as the program's input."""
    from repro_torch.core.tbox import Ontology
    from repro_torch.rdf.generator import RawDataset
    o = Ontology(concepts=list(onto.CONCEPTS), properties=list(onto.PROPERTIES),
                 subclass=list(onto.SUBCLASS), subprop=list(onto.SUBPROP),
                 domain={k: list(v) for k, v in onto.DOMAIN.items()},
                 range_={k: list(v) for k, v in onto.RANGE.items()})
    s, p, o_ = cols
    return RawDataset(s=s, p=p, o=o_, onto=o)


def decode(K, ids: torch.Tensor) -> torch.Tensor:
    """Program ids -> fingerprints through the program's dictionary (-1 for
    an id it does not know)."""
    from repro_torch.utils.pair64 import WORD_BITS
    hi, lo, hit = K.kb.table.extract_fp(ids.reshape(-1).to(torch.int32))
    fp = (hi.to(torch.int64) << WORD_BITS) | lo.to(torch.int64)
    return torch.where(hit, fp, -1).reshape(ids.shape)


def _span_rows(tracer, keep) -> list:
    """Finished traces' spans on the perf_counter clock, with their depth."""
    epoch = time.perf_counter() - tracer.now()
    rows = []
    for tr in tracer.finished_traces():
        if not keep(tr.trace_id):
            continue
        spans = tr.spans
        parent = {s.span_id: s.parent_id for s in spans}
        for s in spans:
            depth, p = 0, s.parent_id
            while p != -1:
                depth, p = depth + 1, parent.get(p, -1)
            rows.append((s.name, epoch + s.t0, epoch + s.t1, depth,
                         tr.trace_id))
    return rows


def _hist_state(registries) -> dict:
    """(registry tag, name, labels) -> (count, sum) of every histogram."""
    return {(tag, h["name"], tuple(sorted(h["labels"].items()))):
            (h["count"], h["sum"])
            for tag, reg in registries
            for h in reg.mergeable_snapshot()["histograms"]}


def _hist_delta(before: dict, after: dict) -> dict:
    """(registry tag, name, labels) -> (count, sum) observed in between."""
    out = {}
    for k, (n, s) in after.items():
        n0, s0 = before.get(k, (0, 0.0))
        if n > n0:
            out[k] = (n - n0, s - s0)
    return out


# ---------------------------------------------------------------------------
# serve_closed_loop
# ---------------------------------------------------------------------------


def _submit(rt, req):
    kind, cls, prop = req
    if kind == "class_members":
        return rt.submit_class_members([cls])
    return rt.submit_class_prop_join([cls], [prop])


def _closed_loop(rt, stream, outstanding: int, t_stop: float,
                 drain_s: float, on_close=None, limit: int | None = None):
    """Keep ``outstanding`` requests in flight until ``t_stop`` (or until
    ``limit`` were issued), then wait (``drain_s`` at most) for those in
    flight.  Returns (records, requests that never resolved)."""
    done: queue.SimpleQueue = queue.SimpleQueue()
    records: list = []
    issued = [0]

    def issue():
        issued[0] += 1
        req = stream.next()
        rec = {"key": req, "t_issue": time.perf_counter()}
        fut = _submit(rt, req)
        fut.add_done_callback(
            lambda f, rec=rec: (rec.__setitem__("t_done", time.perf_counter()),
                                done.put((rec, f))))

    for _ in range(outstanding):
        issue()
    live, closed = outstanding, False
    while live:
        wait = t_stop + drain_s - time.perf_counter()
        try:
            rec, fut = done.get(timeout=min(max(wait, 1e-3), 3600.0))
        except queue.Empty:
            break
        live -= 1
        out = fut.result()
        rec.update(status=out.status, answers=out.answers,
                   trace_id=out.trace_id)
        records.append(rec)
        if time.perf_counter() < t_stop and (limit is None
                                             or issued[0] < limit):
            issue()
            live += 1
        elif not closed:
            closed = True
            if on_close is not None:
                on_close()
    if not closed and on_close is not None:
        on_close()
    return records, live


def serve_closed_loop(ctx: Context, t_start: float):
    from repro_torch.core.engine import KnowledgeBase
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.runtime import ServingRuntime

    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    phases = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()
    cols, generated = data.raw_columns(cfg)
    phases["generate" if generated else "data"] = time.perf_counter() - t
    t = time.perf_counter()
    K = KnowledgeBase.build(port_raw(cols), device=ctx.device)
    ctx.sync()
    phases["build"] = time.perf_counter() - t
    # the serving peak: the store and its views with the workspace of the
    # widest batch the runtime can form (max_batch requests of the pool's
    # widest class), which the warm-up runs; the window adds what it adds
    ctx.reset_peak()
    t = time.perf_counter()
    tracer = Tracer(max_traces=1 << 30) if ctx.trace else None
    rt = ServingRuntime(K, modes=("litemat",), tracer=tracer,
                        server_topk=int(traffic["topk"]))
    rt.start()
    # warm the plans of every class of the pool, alone and at the widest
    # batch, then a fixed stretch of the mix itself (seed-independent)
    sizes = {}
    for c in traffic["classes"]:
        sizes[c] = int(rt.class_members([c]).answers[0][0])
        rt.class_prop_join([c], [traffic["properties"][0]])
    wide = max(sizes, key=sizes.get)
    rt.class_members([wide] * rt.max_batch)
    rt.class_prop_join([wide] * rt.max_batch,
                       [traffic["properties"][0]] * rt.max_batch)
    warm = RequestStream(traffic, int(traffic["warm_seed"]))
    _closed_loop(rt, warm, int(traffic["outstanding"]), float("inf"), 60.0,
                 limit=int(traffic["warm_requests"]))
    ctx.sync()
    phases["warm"] = time.perf_counter() - t

    run = Run(kind="serve_closed_loop",
              n_raw=int(cols[0].shape[0]), traced=ctx.trace, phases=phases)
    regs = [("process", REGISTRY), ("runtime", rt.metrics)]
    prof = WindowProfile(ctx.trace, ctx.cuda)
    stream = RequestStream(traffic, ctx.seed)
    hist = {}
    before = _hist_state(regs)
    run.t_open = prof.open()
    run.setup_s = run.t_open - t_start
    run.t_close = run.t_open + ctx.seconds
    records, unresolved = _closed_loop(
        rt, stream, int(traffic["outstanding"]), run.t_close,
        float(traffic["drain_s"]),
        on_close=lambda: hist.update(after=_hist_state(regs)))
    ctx.sync()
    prof.close()
    run.peak_bytes = ctx.peak()
    run.hist = _hist_delta(before, hist["after"])
    run.ops = prof.ops
    run.requests = [
        {"kind": r["key"][0], "t_issue": r["t_issue"], "t_done": r["t_done"],
         "status": r["status"], "trace_id": r["trace_id"]}
        for r in records]
    if tracer is not None:
        ids = {r["trace_id"] for r in records if r["t_done"] <= run.t_close}
        run.spans = _span_rows(tracer, lambda t: t in ids)
    run.attempted = len(records) + unresolved
    run.failed = sum(r["status"] != "ok" for r in records) + unresolved
    topk = rt.server_topk
    program = {"K": K, "rt": rt}
    del K, rt

    def judge() -> dict:
        ok = [r for r in records if r["status"] == "ok"]
        ids = torch.zeros((0, topk), dtype=torch.int64)
        if ok:
            ids = torch.as_tensor(np.stack([r["answers"][1][0] for r in ok]),
                                  dtype=torch.int64)
        fps = decode(program["K"], ids.to(ctx.device)).cpu()
        answers = [(r["key"], int(r["answers"][0][0]), ids[i], fps[i])
                   for i, r in enumerate(ok)]
        program.pop("rt").stop()
        program.clear()
        ctx.free()
        E = Entailment.build(*cols, device=ctx.device)
        expected = checks.facet_expected(E, {a[0] for a in answers})
        return checks.facet_checks(answers, expected, topk, unresolved)

    return run, judge


# ---------------------------------------------------------------------------
# bulk_load
# ---------------------------------------------------------------------------


def bulk_load(ctx: Context, t_start: float):
    from repro_torch.core.engine import KnowledgeBase
    from repro_torch.obs.trace import Tracer, activate

    cfg = ctx.cell.config
    phases = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()
    cols, generated = data.raw_columns(cfg)
    phases["generate" if generated else "data"] = time.perf_counter() - t
    raw = port_raw(cols)
    t = time.perf_counter()
    K = KnowledgeBase.build(raw, device=ctx.device)
    ctx.sync()
    del K
    ctx.free()
    phases["warm"] = time.perf_counter() - t

    run = Run(kind="bulk_load",
              n_raw=int(cols[0].shape[0]), traced=ctx.trace, phases=phases)
    tracer = Tracer(max_traces=1 << 30) if ctx.trace else None
    prof = WindowProfile(ctx.trace, ctx.cuda)
    ctx.reset_peak()
    run.t_open = prof.open()
    run.setup_s = run.t_open - t_start
    t_stop = run.t_open + ctx.seconds
    rows = []
    while True:
        t0 = time.perf_counter()
        if tracer is not None:
            tr = tracer.new_trace("build")
            root = tracer.start_root(tr, "build")
            with activate(root):
                K = KnowledgeBase.build(raw, device=ctx.device)
            ctx.sync()
            root.finish()
            tracer.finish_trace(tr)
        else:
            K = KnowledgeBase.build(raw, device=ctx.device)
            ctx.sync()
        t1 = time.perf_counter()
        run.builds.append({"t0": t0, "t1": t1})
        rows.append((int(K.lite_spo.shape[0]), int(K.full_spo.shape[0])))
        if t1 >= t_stop:
            break
        del K
    prof.close()
    run.t_close = run.builds[-1]["t1"]
    run.peak_bytes = ctx.peak()
    run.ops = prof.ops
    if tracer is not None:
        run.spans = _span_rows(tracer, lambda t: True)
    run.attempted = len(run.builds)
    program = {"K": K}
    del K

    def judge() -> dict:
        K = program.pop("K")
        lite = decode(K, K.lite_spo)
        full = decode(K, K.full_spo)
        del K
        ctx.free()
        E = Entailment.build(*cols, device=ctx.device)
        return checks.load_checks(E, lite, full, rows)

    return run, judge


DRIVERS = {"serve_closed_loop": serve_closed_loop, "bulk_load": bulk_load}
