"""Port parity, telemetry (slice 5): mergeable sketches, exports and their
validators, the device-memory ledger, and the SLO control loop on the
port's serving runtime.

Mirrors tests/test_fleet_obs.py and the export cases of tests/test_obs.py
on ``repro_torch.obs``.  Where both packages take the same input (sketch
states, snapshots, malformed documents) the outputs are compared with the
reference's, exactly.  The ledger keys its records on torch storages: two
views of one storage count once, at the storage's bytes.  On the port's
CPU build of LUBM-1 (seed 7: the shared ``lubm_kb`` fixture's raw
triples) the ledger's triples, components and bytes equal the reference
ledger's over the reference store.  The SLO loop runs on the port's
runtime over that CPU store, and ``scripts/check_traces.py`` validates
the port's exported files unchanged (the wire schemas are the
reference's).
"""
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import aggregate as j_aggregate
from repro.obs import export as j_export
from repro.obs import metrics as j_metrics
from repro.obs.ledger import ResourceLedger as JResourceLedger
from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
from repro_torch.core.snapshot import SnapshotRegistry
from repro_torch.obs.aggregate import (AggregationError, aggregate,
                                       check_compatible)
from repro_torch.obs.export import (export_mergeable_metrics, export_traces,
                                    validate, validate_metrics_snapshot,
                                    validate_trace)
from repro_torch.obs.ledger import ResourceLedger, StorageKey, tensor_record
from repro_torch.obs.metrics import (REGISTRY, MetricsRegistry, _GROWTH_LOG,
                                     merge_states, summarize_state)
from repro_torch.obs.slo import SLO, SLOMonitor, TelemetryRollup, _spec
from repro_torch.obs.trace import Tracer
from repro_torch.rdf.generator import generate_lubm
from repro_torch.serving.runtime import ServingRuntime
from repro_torch.testing import faults

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
Q1, Q4 = PAPER_QUERIES["Q1"], PAPER_QUERIES["Q4"]


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.uninstall()


@pytest.fixture(scope="module")
def kbs(lubm_kb):
    jkb, _ = lubm_kb
    return jkb, KnowledgeBase.build(generate_lubm(1, seed=7), device="cpu")


# -- mergeable histogram sketches ---------------------------------------------

def _hist_with(reg, values, **labels):
    h = reg.histogram("t/lat", **labels)
    for v in values:
        h.observe(v)
    return h


def test_merge_states_associative_and_order_independent():
    rng = np.random.default_rng(3)
    streams = [rng.lognormal(-3, 1, 500), rng.lognormal(-2, 0.5, 300),
               rng.lognormal(-4, 2, 700)]
    states = [_hist_with(MetricsRegistry(), s).state() for s in streams]
    a, b, c = states
    left = merge_states(merge_states(a, b), c)
    right = merge_states(a, merge_states(b, c))
    shuffled = merge_states(c, a, b)
    for other in (right, shuffled):
        # counts/buckets/min/max are integers or copied floats: exact;
        # "sum" reassociates float additions, so approx only
        assert {k: v for k, v in left.items() if k != "sum"} \
            == {k: v for k, v in other.items() if k != "sum"}
        assert left["sum"] == pytest.approx(other["sum"])
    assert left["count"] == sum(len(s) for s in streams)
    assert left["sum"] == pytest.approx(sum(s.sum() for s in streams))
    assert left["min"] == pytest.approx(min(s.min() for s in streams))
    assert left["max"] == pytest.approx(max(s.max() for s in streams))
    # the same streams through the reference: the same states, bit for bit
    jstates = [_hist_with(j_metrics.MetricsRegistry(), s).state()
               for s in streams]
    assert jstates == states
    assert j_metrics.merge_states(*jstates) == merge_states(*states)


def test_merged_percentiles_match_pooled_stream_within_one_bucket():
    rng = np.random.default_rng(11)
    streams = [rng.lognormal(-3, 1, 400) for _ in range(4)]
    pooled = _hist_with(MetricsRegistry(), np.concatenate(streams))
    merged = merge_states(*[
        _hist_with(MetricsRegistry(), s).state() for s in streams])
    ms = summarize_state(merged)
    one_bucket = math.exp(_GROWTH_LOG)
    for q in (50, 99):
        p_pool = pooled.percentile(q)
        p_merge = ms[f"p{q}"]
        assert p_merge / p_pool <= one_bucket + 1e-9
        assert p_pool / p_merge <= one_bucket + 1e-9
    # bucket-wise addition IS the pooled sketch: exact equality too
    assert merged["buckets"] == pooled.state()["buckets"]
    assert ms == j_metrics.summarize_state(merged)


def test_mergeable_snapshot_roundtrip_and_validation(tmp_path):
    reg = MetricsRegistry()
    reg.counter("t/reqs", status="ok").inc(5)
    reg.gauge("t/depth").set(3.5)
    _hist_with(reg, [0.01, 0.02, 0.4], mode="x")
    path = tmp_path / "snap.json"
    export_mergeable_metrics(reg, str(path), process="7")
    snap = json.loads(path.read_text())
    assert snap["schema"] == "repro.metrics.snapshot/1"
    assert snap["process"] == "7"
    assert validate_metrics_snapshot(snap) == []
    assert j_export.validate_metrics_snapshot(snap) == []
    # corrupt a bucket count: the validator names the inconsistency
    snap["histograms"][0]["buckets"][
        next(iter(snap["histograms"][0]["buckets"]))] += 1
    errs = validate_metrics_snapshot(snap)
    assert errs and "bucket counts sum" in errs[0]
    assert errs == j_export.validate_metrics_snapshot(snap)
    # unknown schema versions fail loudly, never silently skew a merge
    errs = validate_metrics_snapshot({"schema": "repro.metrics/99"})
    assert errs and "unknown metrics snapshot schema" in errs[0]
    assert errs == j_export.validate_metrics_snapshot(
        {"schema": "repro.metrics/99"})


def test_aggregate_sums_counters_and_rejects_bad_inputs():
    snaps = []
    for proc in ("0", "1"):
        reg = MetricsRegistry()
        reg.counter("t/reqs", status="ok").inc(3)
        reg.gauge("t/depth").set(float(proc))
        _hist_with(reg, [0.01, 0.1])
        snaps.append(reg.mergeable_snapshot(process=proc))
    fleet = aggregate(snaps)
    assert fleet["schema"] == "repro.metrics.fleet/1"
    assert fleet["processes"] == ["0", "1"]
    assert validate_metrics_snapshot(fleet) == []
    # the reference's aggregator reads the port's snapshots the same way
    jfleet = j_aggregate.aggregate(snaps)
    assert {k: v for k, v in fleet.items() if k != "t"} == \
        {k: v for k, v in jfleet.items() if k != "t"}
    [ctr] = [e for e in fleet["counters"] if e["name"] == "t/reqs"]
    assert ctr["value"] == 6  # counters SUM across processes
    # gauges stay per-process (labelled), never averaged
    depths = {e["labels"]["process"]: e["value"]
              for e in fleet["gauges"] if e["name"] == "t/depth"}
    assert depths == {"0": 0.0, "1": 1.0}
    [h] = [e for e in fleet["histograms"] if e["name"] == "t/lat"]
    assert h["count"] == 4 and "summary" in h
    with pytest.raises(AggregationError, match="claim process"):
        check_compatible([snaps[0], snaps[0]])
    bad = dict(snaps[1], schema="repro.metrics.snapshot/0")
    with pytest.raises(AggregationError, match="snapshot/0"):
        aggregate([snaps[0], bad])
    bad = dict(snaps[1], growth_log=_GROWTH_LOG * 2)
    with pytest.raises(AggregationError, match="growth_log"):
        aggregate([snaps[0], bad])


# -- validators and the trace export ------------------------------------------

def test_validator_catches_malformed_traces():
    tracer = Tracer()
    tr = tracer.new_trace()
    tracer.start_root(tr, "r")
    good = tr.to_dict()
    assert validate_trace(good) == []

    bad = json.loads(json.dumps(good))
    bad["spans"][0]["parent_id"] = 42  # no root anymore + dangling parent
    assert validate_trace(bad)
    assert validate_trace(bad) == j_export.validate_trace(bad)

    bad = json.loads(json.dumps(good))
    bad["spans"][0]["t1"] = bad["spans"][0]["t0"] - 1.0
    assert any("t1 < t0" in e for e in validate_trace(bad))
    assert validate_trace(bad) == j_export.validate_trace(bad)

    bad = json.loads(json.dumps(good))
    del bad["spans"][0]["name"]
    assert any("missing required key" in e for e in validate_trace(bad))
    assert validate_trace(bad) == j_export.validate_trace(bad)

    assert validate(True, {"type": "integer"})  # bool is not an integer


def test_trace_export_roundtrip(tmp_path, kbs):
    _, K = kbs
    tracer = Tracer()
    rt = ServingRuntime(K, modes=("litemat",), n_workers=2, tracer=tracer)
    with rt:
        for _ in range(5):
            assert rt.serve(Q1).ok
    path = tmp_path / "traces.json"
    n = export_traces(tracer, str(path))
    assert n == 5
    doc = json.loads(path.read_text())
    assert doc["dropped"] == 0
    for trace in doc["traces"]:
        assert validate_trace(trace) == []
        assert j_export.validate_trace(trace) == []


# -- resource ledger ----------------------------------------------------------

class _Owner:
    """Minimal device_buffers() provider over torch tensors."""

    def __init__(self, tensors, triples=0):
        self.tensors = tensors
        self.triples = triples

    def device_buffers(self):
        return [tensor_record(comp, t) for comp, t in self.tensors]

    def n_live_triples(self):
        return self.triples


def test_ledger_accounts_dedupes_and_zeroes():
    reg = MetricsRegistry()
    led = ResourceLedger(registry=reg)
    shared = torch.zeros(1024, dtype=torch.int32)  # 4096 B, owned by BOTH
    a = _Owner([("base", torch.zeros(256, dtype=torch.int32)),
                ("base", shared)], triples=100)
    b = _Owner([("delta", shared)], triples=50)
    led.track("0", a)
    led.track("1", b)
    s = led.sample()
    # shared storage counts ONCE, attributed to the first-registered owner
    assert s["shards"]["0"]["components"]["base"] == 1024 + 4096
    assert s["shards"]["1"].get("components") == {}
    assert s["total_bytes"] == 1024 + 4096
    assert s["total_triples"] == 150
    assert reg.gauge_value("hbm_bytes", shard="0", component="base") == 5120
    assert reg.gauge_value("store/bytes_per_triple") == pytest.approx(
        5120 / 150)
    # dropping an owner zeroes its gauges on the next sample
    del a
    gc.collect()
    s2 = led.sample()
    assert "0" not in s2["shards"]
    assert reg.gauge_value("hbm_bytes", shard="0", component="base") == 0
    # ...and the survivor now owns the shared storage
    assert s2["shards"]["1"]["components"]["delta"] == 4096


def test_ledger_counts_views_of_one_storage_once_at_its_bytes():
    """A slice, a transpose, a reshape and a permutation that is the
    tensor itself share one storage: one record's worth, the storage's
    bytes, whichever view an owner reports first."""
    base = torch.arange(3 * 1000, dtype=torch.int32).reshape(1000, 3)
    views = [base[10:20], base.T, base.view(-1), base[:, 1], base]
    keys = {tensor_record("base", v)[1] for v in views}
    assert keys == {StorageKey("cpu", base.untyped_storage().data_ptr(),
                               None)}
    for first in (views[0], views[3]):
        reg = MetricsRegistry()
        led = ResourceLedger(registry=reg)
        owner = _Owner([("base", first)] + [("base", v) for v in views]
                       + [("alive", torch.ones(7, dtype=torch.bool))])
        led.track("0", owner)
        s = led.sample()
        # the storage's bytes, not the first view's numel * itemsize
        assert s["shards"]["0"]["components"] == {"base": 12_000,
                                                  "alive": 7}
    # a copy is another storage
    owner = _Owner([("base", base), ("base", base[:5].clone())])
    led = ResourceLedger(registry=MetricsRegistry())
    led.track("0", owner)
    assert led.sample()["total_bytes"] == 12_000 + 60


def test_ledger_on_real_store_matches_reference(kbs):
    """The port's CPU store against the reference's: the same live
    triples, components and bytes; base covers the three store tensors;
    sampling is read-only."""
    jkb, K = kbs
    s = {}
    for name, kb, ledger in (("port", K, ResourceLedger),
                             ("ref", jkb, JResourceLedger)):
        led = ledger(registry=MetricsRegistry() if name == "port"
                     else j_metrics.MetricsRegistry())
        led.track("0", kb)
        kb.query(Q1)  # materialize indexes + device caches
        s[name] = led.sample()
        assert led.sample()["total_bytes"] == s[name]["total_bytes"]
    rec, jrec = s["port"]["shards"]["0"], s["ref"]["shards"]["0"]
    assert rec["triples"] == jrec["triples"] == K.n_live_triples()
    assert rec["triples"] == K.store_rows("litemat").shape[0]
    assert set(rec["components"]) == set(jrec["components"]) == {
        "base", "alive", "tbox"}
    assert rec["components"] == jrec["components"]
    floor = sum(t.untyped_storage().nbytes()
                for t in (K.kb.spo, K.lite_spo, K.full_spo))
    assert rec["components"]["base"] >= floor
    assert s["port"]["bytes_per_triple"] == pytest.approx(
        s["port"]["total_bytes"] / s["port"]["total_triples"])


def test_ledger_tracks_delta_and_snapshot_retention():
    """Through an insert, a delete and a compaction with a version pinned:
    delta buckets and liveness masks appear, the pinned version's
    superseded base surfaces under ``snapshot`` (an independent sum over
    its own tensors), and retiring it zeroes its gauge."""
    K = KnowledgeBase.build(generate_lubm(1, seed=3), device="cpu")
    raw = generate_lubm(1, seed=5)
    reg = SnapshotRegistry(K)
    metrics = MetricsRegistry()
    led = ResourceLedger(registry=metrics)
    led.track("0", K)
    led.track("snapshots", reg)
    pin = reg.pin()
    pinned = pin.snapshot.views["litemat"]
    v0 = pin.version
    pin.query(Q4)
    K.insert((raw.s[:64], raw.p[:64], raw.o[:64]), auto_compact=False)
    K.delete((raw.s[:8], raw.p[:8], raw.o[:8]), auto_compact=False)
    K.query(Q4)
    comps = led.sample()["shards"]["0"]["components"]
    assert comps["delta"] > 0 and comps["alive"] > 0
    K.compact()
    K.query(Q4)
    reg.publish()  # the live version: deduped against the store's own
    s = led.sample()
    # the old litemat base and its permutations: pinned, no longer live
    old = {p.rows.untyped_storage().data_ptr(): p.rows.untyped_storage()
           .nbytes() for p in pinned.base_index._perms.values()}
    old[pinned.base_rows.untyped_storage().data_ptr()] = \
        pinned.base_rows.untyped_storage().nbytes()
    live = {r[1].ptr for r in K.device_buffers()}
    retained = sum(n for ptr, n in old.items() if ptr not in live)
    assert retained > 0
    assert s["shards"]["snapshots"]["components"]["snapshot"] == retained
    assert s["shards"]["snapshots"]["triples"] == 0
    assert metrics.gauge_value("hbm_bytes", shard="snapshots",
                               component="snapshot") == retained
    assert reg.metrics.gauge_value("snapshot/retained_bytes",
                                   version=v0) == retained
    pin.release()
    assert v0 not in reg.live_versions()
    led.sample()
    assert reg.metrics.gauge_value("snapshot/retained_bytes",
                                   version=v0) == 0
    assert s["total_triples"] == K.n_live_triples()


@pytest.mark.parametrize("racer", ["cache", "view"])
def test_device_buffers_walk_survives_a_writer_mid_walk(racer):
    """A writer that bumps the version and serves other modes while the
    sampler walks (here: from inside the walk) replaces the view, cache
    and index dicts; the walk reads copies, so it neither raises nor
    loses a record of what it already holds."""
    K = KnowledgeBase.build(generate_lubm(1, seed=3), device="cpu")
    K.query(Q4)
    before = K.device_buffers()
    obj = K.dev_cache("litemat") if racer == "cache" else K.view("litemat")
    walk = obj.device_buffers

    def racing():
        K._bump()  # a mutation: every cached view goes
        K.view("full")  # another mode served: new view, cache, index
        K.view("rewrite")
        return walk()

    obj.device_buffers = racing
    got = K.device_buffers()
    assert {r[1] for r in before} <= {r[1] for r in got}


def test_rollup_thread_samples_while_the_writer_replaces_state():
    """The rollup thread samples the ledger every millisecond while a
    writer inserts, deletes and compacts (each bumps the version and
    replaces the view, cache and index dicts the walk reads) and readers
    build permutations: no tick fails, and the last sample agrees with
    the store."""
    K = KnowledgeBase.build(generate_lubm(1, seed=3), device="cpu")
    raw = generate_lubm(1, seed=5)
    rt = ServingRuntime(K, n_workers=2)
    rt.enable_slo_control(interval_s=0.001)
    roll = rt._slo_rollup
    ticks = [0]
    tick = roll.tick

    def counted():
        ticks[0] += 1
        return tick()

    roll.tick = counted
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with rt:
            for i in range(12):
                sl = slice(64 * i, 64 * (i + 1))
                rt.insert((raw.s[sl], raw.p[sl], raw.o[sl]),
                          auto_compact=False)
                if i % 4 == 3:
                    rt.delete((raw.s[sl][:8], raw.p[sl][:8], raw.o[sl][:8]),
                              auto_compact=False)
                    rt.compact()
                futs = [rt.submit(q) for q in PAPER_QUERIES.values()]
                assert all(f.result(timeout=60).ok for f in futs)
            deadline = time.monotonic() + 10
            while ticks[0] < 20 and time.monotonic() < deadline:
                time.sleep(0.01)
    finally:
        sys.setswitchinterval(old)
    assert roll._thread is None  # stop() joined the rollup thread
    assert ticks[0] >= 20
    assert rt.metrics.counter_value("rollup/tick_errors") == 0
    assert REGISTRY.gauge_value("store/live_triples", shard="0") > 0
    s = ResourceLedger(registry=MetricsRegistry())
    s.track("0", K)
    assert s.sample()["total_triples"] == K.n_live_triples()


# -- SLO monitor + admission control loop -------------------------------------

def _mk_points(pairs, den_spec, num_spec):
    """Timeline of points from cumulative (den, num) counter pairs."""
    return [{"t": float(i), "counters": {den_spec: d, num_spec: n},
             "hists": {}, "rates": {}} for i, (d, n) in enumerate(pairs)]


def test_monitor_burn_rates_and_state_machine():
    from repro.obs.slo import SLO as JSLO
    from repro.obs.slo import SLOMonitor as JSLOMonitor

    den, num = _spec("t/submitted"), _spec("t/outcomes", status="deadline")
    seen = {}
    mons = {}
    for name, slo_cls, mon_cls, reg in (
            ("port", SLO, SLOMonitor, MetricsRegistry()),
            ("ref", JSLO, JSLOMonitor, j_metrics.MetricsRegistry())):
        slo = slo_cls(name="miss", objective=0.01, num=num, den=den)
        mon = mon_cls([slo], fast_window=2, slow_window=4, min_events=4,
                      registry=reg)
        seen[name] = []
        mon.on_transition(lambda st, detail, n=name: seen[n].append(st))
        mons[name] = (mon, reg)
    mon, reg = mons["port"]
    jmon, _ = mons["ref"]
    steps = [
        # healthy: 100 events/tick, zero bad
        ([(0, 0), (100, 0), (200, 0), (300, 0)], "ok", []),
        # sustained 50% miss rate = 50x budget: page
        ([(0, 0), (100, 50), (200, 100), (300, 150), (400, 200)], "page",
         ["page"]),
        # recovery: fast window clean, slow window still dirty -> clears
        ([(0, 100), (100, 100), (200, 100), (300, 100), (400, 100)], "ok",
         ["page", "ok"]),
        # too few events: no signal, no flapping
        ([(0, 0), (2, 2)], "ok", ["page", "ok"]),
    ]
    for pairs, state, trans in steps:
        tl = _mk_points(pairs, den, num)
        assert mon.observe(tl) == state and seen["port"] == trans
        assert jmon.observe(tl) == state and seen["ref"] == trans
        assert mon.detail == jmon.detail
        if state == "page":
            assert reg.gauge_value("slo/burn_rate", slo="miss",
                                   window="fast") >= 2.0


@pytest.fixture()
def slo_rt(kbs):
    _, K = kbs
    tracer = Tracer()
    rt = ServingRuntime(K, max_queue=32, tracer=tracer)
    # interval_s is huge: the tests drive tick() by hand so window
    # contents are deterministic
    mon = rt.enable_slo_control(interval_s=60.0, fast_window=2,
                                slow_window=4, min_events=4)
    with rt:
        rt.serve(Q4)  # warm the plan before any deadline-bounded traffic
        yield rt, mon, tracer


def test_slo_loop_tightens_admission_and_recovers(slo_rt):
    rt, mon, tracer = slo_rt
    tick = rt._slo_rollup.tick
    for _ in range(12):
        assert rt.serve(Q4).ok
    tick(); tick()
    assert mon.state == "ok"
    b0, w0 = rt.admission_bound, rt.batch_window_s
    # injected overload: every execute faults, deadlines pile up, and the
    # monitor pages -> admission bound drops, batch window widens
    with faults.inject() as inj:
        inj.arm("serving.execute", times=0)
        for _ in range(4):
            for _ in range(10):
                rt.serve(Q4, deadline_s=0.01)
            tick()
    assert mon.state == "page"
    assert rt.admission_bound < b0
    assert rt.batch_window_s > w0
    assert rt.metrics.gauge_value("serving/admission_bound") == \
        rt.admission_bound
    # recovery: healthy traffic drains the windows, knobs restore
    for _ in range(6):
        for _ in range(8):
            assert rt.serve(Q4).ok
        tick()
    assert mon.state == "ok"
    assert rt.admission_bound == b0 and rt.batch_window_s == w0
    assert mon.detail["deadline_miss"]["state"] == "ok"
    # every transition landed as its own schema-valid single-span trace
    trans = [t for t in tracer.finished_traces()
             if t.root.name == "slo_transition"]
    assert len(trans) >= 2
    states = [t.root.attrs["to"] for t in trans]
    assert "page" in states and states[-1] == "ok"
    for t in trans:
        assert validate_trace(t.to_dict()) == []
        assert len(t.spans) == 1
    # each tick sampled the process ledger into the process registry
    assert REGISTRY.gauge_value("hbm_bytes", shard="0", component="base") > 0
    assert REGISTRY.gauge_value("store/hbm_bytes_total") > 0


def test_slo_apply_fault_leaves_data_plane_knobs(slo_rt):
    rt, mon, _ = slo_rt
    tick = rt._slo_rollup.tick
    for _ in range(12):
        rt.serve(Q4)
    tick(); tick()
    b0 = rt.admission_bound
    # the CONTROL plane faults at apply time: the monitor pages but the
    # runtime keeps its previous knobs
    with faults.inject() as inj:
        inj.arm("slo.apply", times=0)
        inj.arm("serving.execute", times=0)
        for _ in range(4):
            for _ in range(10):
                rt.serve(Q4, deadline_s=0.01)
            tick()
        assert mon.state == "page"
        assert rt.admission_bound == b0  # apply faulted: knobs unchanged
        assert rt.metrics.counter_value("slo/apply_faults") >= 1
    # with the fault gone, the next transition applies normally
    for _ in range(6):
        for _ in range(8):
            rt.serve(Q4)
        tick()
    assert mon.state == "ok" and rt.admission_bound == b0


def test_rollup_rates_are_first_class_series():
    reg = MetricsRegistry()
    roll = TelemetryRollup(reg, maxlen=8)
    reg.counter("serving/submitted").inc(10)
    roll.tick()
    reg.counter("serving/submitted").inc(30)
    roll.tick()
    series = roll.rate_series("serving/submitted")
    assert len(series) == 1 and series[0][1] > 0
    assert reg.gauge_value("rate/serving/submitted") == series[0][1]
    for _ in range(20):  # timeline stays bounded
        roll.tick()
    assert len(roll.timeline) == 8


def test_check_traces_accepts_port_exports(tmp_path, kbs):
    """The reference's CI checker reads the port's trace export, its
    mergeable snapshot and their fleet aggregate unchanged."""
    _, K = kbs
    tracer = Tracer()
    rt = ServingRuntime(K, n_workers=2, tracer=tracer)
    with rt:
        for q in PAPER_QUERIES.values():
            assert rt.serve(q).ok
    export_traces(tracer, str(tmp_path / "traces.json"))
    export_mergeable_metrics(rt.metrics, str(tmp_path / "m0.json"),
                             process="0")
    other = MetricsRegistry()
    _hist_with(other, [0.01, 0.2])
    snaps = [rt.metrics.mergeable_snapshot(process="0"),
             other.mergeable_snapshot(process="1")]
    (tmp_path / "fleet.json").write_text(json.dumps(aggregate(snaps)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "check_traces.py"),
         "--min-traces", "4", str(tmp_path / "traces.json"),
         str(tmp_path / "m0.json"), str(tmp_path / "fleet.json")],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 errors" in proc.stdout
