"""Port parity, batched serving: the engine's ``run_batch`` and the request
runtime, on LUBM-1 (seed 7: the shared ``lubm_kb`` fixture for the
reference, the same raw triples built by the port on the CPU).

The requests are parameterized and share a signature — ``(?x rdf:type C)``
over many classes, ``(?x rdf:type C) (?x memberOf ?y)`` and the Q4 shape
with C among the professors — so ``run_batch`` really forms groups of two
or more members and runs the batched plan body (the reference's batch
tests send the paper queries, whose groups each hold one member).  Per
mode (litemat indexed, litemat scan, full, rewrite), one family goes
through both packages' ``run_batch`` (the reference's vmapped executable,
compiled once per case): the rows are equal array for array and so are
the plan-cache counters; every family goes through the port's
``run_batch`` and its solo ``run``.  The runtime half mirrors
tests/test_serving_batch.py on the port: batched answers equal solo ones,
per-member outcomes and traces, member-fault isolation, whole-batch
degradation, pagination and cursors, shedding, bounded latency stats and
``_batch_caps``.  Everything compared is integer: the tolerance is zero.
"""
import threading

import numpy as np
import pytest
import torch

from repro.core.query import Pattern as JPattern
from repro.core.query import QueryEngine as JQueryEngine
from repro.obs.export import validate_trace
from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
from repro_torch.core.query import Pattern, QueryEngine
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import Tracer
from repro_torch.rdf.generator import generate_lubm
from repro_torch.serving.runtime import Cursor, ServingRuntime
from repro_torch.testing import faults

torch.set_num_threads(2)

CLASSES = ["Professor", "Student", "Faculty", "Person", "Course",
           "Publication", "Organization", "Department", "Chair",
           "GraduateStudent"]
Q4_CLASSES = ["Chair", "Dean", "FullProfessor", "AssociateProfessor",
              "AssistantProfessor", "Lecturer"]


def family(name, classes, pattern=Pattern):
    """One request family over ``classes``: a list of pattern lists."""
    if name == "type":
        return [[pattern("?x", "rdf:type", c)] for c in classes]
    if name == "type_member":
        return [[pattern("?x", "rdf:type", c), pattern("?x", "memberOf", "?y")]
                for c in classes]
    return [[pattern("?x", "rdf:type", c),
             pattern("?y", "rdf:type", "Department"),
             pattern("?x", "worksFor", "?y")] for c in classes]


FAMILIES = {"type": CLASSES, "type_member": CLASSES, "q4": Q4_CLASSES}
# (mode, use_index, family, classes) run through both packages' run_batch:
# each one signature group (one vmapped compile in the reference)
REFERENCE_CASES = [
    ("litemat", True, "type", CLASSES),
    ("litemat", False, "type", CLASSES),  # the fused scan: batched K2
    ("full", True, "type_member", ["Professor", "Faculty", "Department",
                                   "Chair"]),
    ("rewrite", True, "type", ["GraduateStudent", "FullProfessor",
                               "AssociateProfessor", "Lecturer"]),  # K4
]


@pytest.fixture(scope="module")
def tkb():
    return KnowledgeBase.build(generate_lubm(1, seed=7), device="cpu")


def _engine(kb, mode, use_index=True, cls=QueryEngine):
    """A private engine: the KB's cached one is shared state."""
    return cls(kb=kb.kb, spo=kb._base_store(mode), mode=mode, dtb=kb.dtb,
               use_index=use_index, view=kb.view(mode))


def _batched_groups(eng) -> list:
    """Member counts (Bp) of the batched plan bodies ``eng`` has made."""
    return [k[-1] for k in eng._exec_cache
            if isinstance(k, tuple) and k and k[0] == "bexec"]


@pytest.mark.parametrize("mode,use_index,fam,classes", REFERENCE_CASES,
                         ids=[f"{m}-{'index' if u else 'scan'}-{f}"
                              for m, u, f, _ in REFERENCE_CASES])
def test_run_batch_matches_reference(lubm_kb, tkb, mode, use_index, fam,
                                     classes):
    """The port's run_batch equals the reference's run_batch, array for
    array, on one same-signature family (one group of every member), and
    the plan-cache counters agree."""
    jkb, _ = lubm_kb
    j = _engine(jkb, mode, use_index, JQueryEngine)
    t = _engine(tkb, mode, use_index)
    jout = j.run_batch([(q, None) for q in family(fam, classes, JPattern)])
    tout = t.run_batch([(q, None) for q in family(fam, classes)])
    assert len(tout) == len(jout) == len(classes)
    for (rt, st), (rj, sj) in zip(tout, jout):
        assert st == sj
        assert rt.dtype == np.int32
        np.testing.assert_array_equal(rt, np.asarray(rj))
    assert _batched_groups(t) == [1 << (len(classes) - 1).bit_length()]
    assert t.cache_stats == j.cache_stats


@pytest.mark.parametrize("mode,use_index", [("litemat", True),
                                            ("litemat", False),
                                            ("full", True), ("rewrite", True)],
                         ids=["litemat", "scan", "full", "rewrite"])
def test_run_batch_matches_solo_every_family(tkb, mode, use_index):
    """Every family, in every mode: each member's rows from run_batch equal
    its solo run, and groups of two or more members formed."""
    eng = _engine(tkb, mode, use_index)
    b0 = REGISTRY.histogram("query/batch_size", mode=mode).summary()
    for fam, classes in FAMILIES.items():
        qs = family(fam, classes)
        outs = eng.run_batch([(q, None) for q in qs])
        for q, (rows, sel) in zip(qs, outs):
            want, wsel = eng.run(q)
            assert sel == wsel
            np.testing.assert_array_equal(rows, want, err_msg=f"{fam} {q}")
    b1 = REGISTRY.histogram("query/batch_size", mode=mode).summary()
    assert b1["n"] > b0.get("n", 0) and b1["max"] >= 2
    assert _batched_groups(eng)


def test_run_batch_dedupes_and_mixes_solo_groups(tkb):
    """Structurally identical requests are answered once and fanned out; a
    signature nobody else shares runs solo; the answers are aligned with
    the requests."""
    eng = _engine(tkb, "litemat")
    qs = family("type", ["Chair", "Course"]) + [PAPER_QUERIES["Q2"]]
    reqs = [(q, None) for q in qs + qs]
    outs = eng.run_batch(reqs)
    for (q, _), (rows, _) in zip(reqs, outs):
        np.testing.assert_array_equal(rows, eng.run(q)[0])
    assert outs[0][0] is outs[3][0]  # one answer fanned out
    assert _batched_groups(eng) == [2]


def test_batch_caps_observation_shrinks_and_grows(tkb):
    """Complete per-member evidence lets the observed floor shrink an
    over-provisioned cap; partial evidence only grows it."""
    eng = _engine(tkb, "litemat")
    planned = eng._plan(PAPER_QUERIES["Q1"], None)
    store_n = max(eng.view.n, 1)
    key0 = (planned[0][0], planned[8][0])
    p_big = (planned[0], planned[1], [c * 16 for c in planned[2]],
             planned[3] * 16, *planned[4:])
    caps_big, _ = eng._batch_caps([p_big])
    assert caps_big == p_big[2]
    eng.observed_selectivity[key0] = 1 / store_n
    caps_shrunk, _ = eng._batch_caps([p_big])
    assert caps_shrunk[0] < caps_big[0]
    assert caps_shrunk[0] == eng._bucket(int(1 * eng.slack) + 16)
    caps0, _ = eng._batch_caps([planned])
    eng.observed_selectivity[key0] = (caps0[0] * 8) / store_n
    caps1, join1 = eng._batch_caps([planned])
    assert caps1[0] > caps0[0] and join1 >= max(caps1)
    eng.observed_selectivity[key0] = 1 / store_n
    p_other = (*planned[:8], tuple(("unobserved",) for _ in planned[8]))
    caps_mixed, _ = eng._batch_caps([p_big, p_other])
    assert caps_mixed[0] == max(p_big[2][0], planned[2][0])


def test_run_batch_overflow_retries_per_batch(tkb):
    """Caps observed far below the truth make the batched body overflow:
    it retries with doubled caps (``join/capacity_retry{site=batch}``) and
    still answers as solo runs do."""
    eng = _engine(tkb, "litemat")
    qs = family("type", ["Course", "Faculty"])
    plans = [eng._plan(q, None) for q in qs]
    for pl in plans:  # a tiny observation for every member: caps shrink
        eng.observed_selectivity[(pl[0][0], pl[8][0])] = 1e-9
    c0 = REGISTRY.counter_value("query/overflow_retries")
    outs = eng.run_batch([(q, None) for q in qs])
    assert REGISTRY.counter_value("query/overflow_retries") > c0
    fresh = _engine(tkb, "litemat")
    for q, (rows, _) in zip(qs, outs):
        np.testing.assert_array_equal(rows, fresh.run(q)[0])


# -- the runtime --------------------------------------------------------------


def _burst(rt, queries, **kw):
    futs = [rt.submit(q, **kw) for q in queries]
    return [f.result() for f in futs]


def test_runtime_batches_match_solo_across_modes(tkb):
    """A burst of parameterized requests through the runtime's coalesced
    path answers exactly as per-request serve(), in every mode, and the
    engine formed groups of two or more."""
    qs = family("type", CLASSES[:6]) + family("q4", Q4_CLASSES[:3])
    rt = ServingRuntime(tkb, modes=("litemat", "full", "rewrite"),
                        n_workers=1, batch_window_s=0.05, max_batch=16)
    with rt:
        for mode in ("litemat", "full", "rewrite"):
            solo = [rt.serve(q, mode=mode) for q in qs]
            assert all(o.ok for o in solo)
            b0 = REGISTRY.histogram("query/batch_size", mode=mode).summary()
            burst = _burst(rt, qs, mode=mode)
            assert all(o.ok for o in burst)
            for out, want in zip(burst, solo):
                assert out.answers == want.answers, mode
                assert out.version is not None
            b1 = REGISTRY.histogram("query/batch_size", mode=mode).summary()
            assert b1["n"] > b0.get("n", 0) and b1["max"] >= 2, mode
        assert rt.stats["batched"] > 0
        occ = rt.metrics.histogram("serving/batch_size",
                                   kind="query").summary()
        assert occ["max"] >= 2
        assert rt.metrics.counter_value("serving/batch_fallback",
                                        reason="batch_error") == 0


def test_batch_members_carry_own_outcomes(tkb):
    """Every member of a coalesced batch gets its own version and trace,
    and the batched spans export as well-formed traces."""
    tracer = Tracer()
    qs = family("type", CLASSES[:8])
    rt = ServingRuntime(tkb, modes=("litemat",), n_workers=1,
                        batch_window_s=0.05, max_batch=8, tracer=tracer)
    with rt:
        outs = _burst(rt, qs)
    assert all(o.ok for o in outs)
    ids = [o.trace_id for o in outs]
    assert len(set(ids)) == len(ids) and all(ids)
    assert len({o.version for o in outs}) == 1
    by_id = {t.trace_id: t for t in tracer.finished_traces()}
    saw_batched = False
    for o in outs:
        tr = by_id[o.trace_id]
        assert validate_trace(tr.to_dict()) == []
        for sp in tr.find("attempt"):
            if sp.attrs.get("batched"):
                saw_batched = True
                assert sp.attrs["batch_size"] >= 2
    assert saw_batched


def test_batch_member_fault_does_not_poison_batchmates(tkb):
    """One member faulting at the serving.execute gate retries alone; every
    batchmate still answers ok from the shared batch."""
    qs = family("type", CLASSES[:8])
    rt = ServingRuntime(tkb, modes=("litemat",), n_workers=1,
                        batch_window_s=0.05, max_batch=8, max_retries=2)
    with rt:
        expected = [rt.serve(q) for q in qs]
        with faults.inject() as inj:
            inj.arm("serving.execute", exc=faults.FaultError, after=0,
                    times=1)
            outs = _burst(rt, qs)
            assert inj.fired("serving.execute") == 1
    assert all(o.ok for o in outs)
    for o, want in zip(outs, expected):
        assert o.answers == want.answers
    assert rt.metrics.counter_value("serving/batch_fallback",
                                    reason="member_fault") == 1


def test_whole_batch_failure_degrades_to_solo(tkb):
    """A batch-level error falls every member back to its own retry ladder:
    outcomes stay ok and nothing leaks the batch exception."""
    qs = family("type", CLASSES[:8])
    rt = ServingRuntime(tkb, modes=("litemat",), n_workers=1,
                        batch_window_s=0.05, max_batch=8)
    with rt:
        expected = [rt.serve(q) for q in qs]
        boom = {"armed": True}
        orig = rt.registry.pin

        def bad_pin(*a, **kw):
            pin = orig(*a, **kw)
            if boom.pop("armed", None):
                class _BadPin:
                    version = pin.version
                    stale = pin.stale

                    def query_batch(self, *a, **kw):
                        raise RuntimeError("injected batch crash")

                    def release(self):
                        pin.release()
                return _BadPin()
            return pin

        rt.registry.pin = bad_pin
        try:
            outs = _burst(rt, qs)
        finally:
            rt.registry.pin = orig
    assert all(o.ok for o in outs)
    for o, want in zip(outs, expected):
        assert o.answers == want.answers
    assert rt.metrics.counter_value("serving/batch_fallback",
                                    reason="batch_error") >= 1


def test_page_union_equals_unpaginated(tkb):
    rt = ServingRuntime(tkb, modes=("litemat",), n_workers=2)
    with rt:
        for q in (PAPER_QUERIES["Q1"], PAPER_QUERIES["Q4"]):
            full = rt.serve(q)
            page = rt.serve(q, page_size=7)
            assert page.ok and page.total == len(full.answers)
            got = list(page.answers)
            versions = {page.version}
            while page.cursor is not None:
                assert isinstance(page.cursor, Cursor)
                page = rt.serve(q, cursor=page.cursor)
                assert page.ok
                got += list(page.answers)
                versions.add(page.version)
            assert len(versions) == 1
            assert got == sorted(got)  # one stable order across pages
            assert set(got) == full.answers


def test_cursor_repins_same_version_or_reports_stale():
    raw = generate_lubm(1, seed=7)
    K = KnowledgeBase.build(raw, device="cpu")  # this test moves the store
    s, p, o = (np.asarray(raw.s), np.asarray(raw.p), np.asarray(raw.o))
    rt = ServingRuntime(K, modes=("litemat",), n_workers=1)
    with rt:
        q = PAPER_QUERIES["Q1"]
        first = rt.serve(q, page_size=5)
        assert first.ok and first.cursor is not None and not first.stale
        second = rt.serve(q, cursor=first.cursor)
        assert second.ok and second.version == first.version
        assert not second.stale
        rt.insert((s[:32], p[:32], o[:32]), auto_compact=False)
        assert first.version not in rt.registry.live_versions()
        third = rt.serve(q, cursor=second.cursor)
        assert third.ok and third.stale
        assert third.version != first.version
    assert rt.metrics.counter_value("snapshot/pin_path",
                                    path="cursor_miss") >= 1


def test_server_fanout_under_runtime(tkb):
    """class_members / class_prop_join ride the runtime's queue, batch by
    concatenation and match the direct QueryServer answers."""
    from repro_torch.serving.engine import QueryServer

    srv = QueryServer(tkb, topk=32)
    names = ["Professor", "Student", "Department", "Chair"]
    want_counts, _ = srv.class_members(names)
    rt = ServingRuntime(tkb, modes=("litemat",), n_workers=1,
                        batch_window_s=0.05, max_batch=8, server_topk=32)
    with rt:
        out = rt.class_members(names)
        assert out.ok and out.version is not None
        assert np.array_equal(out.answers[0], want_counts)
        futs = [rt.submit_class_members([n]) for n in names]
        outs = [f.result() for f in futs]
        assert all(o.ok for o in outs)
        for n, o, want in zip(names, outs, want_counts):
            assert int(o.answers[0][0]) == int(want), n
        jn = rt.class_prop_join(["Professor"], ["worksFor"])
        want_j, _ = srv.class_prop_join(["Professor"], ["worksFor"])
        assert jn.ok and int(jn.answers[0][0]) == int(want_j[0])


def test_admission_queue_sheds_past_capacity(tkb):
    rt = ServingRuntime(tkb, modes=("litemat",), n_workers=1, max_queue=2,
                        max_batch=1)
    with rt:
        rt.registry.prewarm([PAPER_QUERIES["Q1"]])
        with faults.inject() as inj:
            inj.arm("serving.execute", exc=None, delay_s=0.3, times=1)
            outs = [f.result() for f in
                    [rt.submit(PAPER_QUERIES["Q1"]) for _ in range(8)]]
    statuses = [o.status for o in outs]
    assert statuses.count("shed") >= 5
    assert all(o.ok for o in outs if o.status == "ok")
    assert rt.stats["shed"] == statuses.count("shed")


def test_start_is_race_free(tkb):
    rt = ServingRuntime(tkb, modes=("litemat",), n_workers=2)
    barrier = threading.Barrier(8)

    def hammer():
        barrier.wait()
        rt.start()

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        assert len(rt._workers) == 2
    finally:
        rt.stop()
    assert rt._workers == []


def test_latency_stats_is_bounded_state(tkb):
    rt = ServingRuntime(tkb, modes=("litemat",), n_workers=1)
    with rt:
        for _ in range(4):
            assert rt.serve(PAPER_QUERIES["Q1"]).ok
    assert not hasattr(rt, "_latencies")
    stats = rt.latency_stats()
    assert stats["n"] == 4
    assert stats["p50_ms"] > 0 and stats["p99_ms"] >= stats["p50_ms"]
    assert rt.latency_stats(status="error") == dict(n=0)


def test_launch_counts_are_exact_across_threads():
    """The runtime's workers launch kernels from several threads: a
    wrapper's launch count, and its count on the launch's device, lose no
    increment under a short switch interval (``build.launched`` holds a
    lock around both ``+= 1``)."""
    import sys

    from repro_torch.kernels import build

    def wrapper():
        pass

    wrapper.launches = 0
    dev = torch.device("cuda", 1)  # a device name: nothing runs on it
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [build.launched(wrapper, dev)
                            for _ in range(5000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 8 * 5000
    assert build.DEVICE_LAUNCHES.pop(("wrapper", 1)) == 8 * 5000
