"""Port parity, serving a sharded store on one device: sharded snapshots,
the sharded ``query_batch``, ``ShardedQueryServer``, the serving runtime
over a ``ShardedKB`` and the sharded ledger arm (the sharded legs of
tests/test_snapshot.py, tests/test_serving_batch.py, tests/test_faults.py
and tests/test_fleet_obs.py, on the port).

LUBM-1 (seed 7), built by the port on the CPU as one store and as 8
shards: pinned sharded snapshots answer at their version across an
insert, fresh pins equal the live store, batched sharded reads equal solo
reads, the sharded server's counts and member lists equal the single
store's ``QueryServer``, a slow shard turns into a deadline miss, and
the ledger reports every shard.  Integer outputs: the tolerance is zero.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import shard as shard_mod
from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
from repro_torch.core.query import Pattern
from repro_torch.core.shard import ShardedKB
from repro_torch.core.snapshot import SnapshotRegistry
from repro_torch.launch.serve import CLASSES, PROPS
from repro_torch.obs.ledger import ResourceLedger
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.rdf.generator import generate_lubm
from repro_torch.serving.engine import QueryServer, ShardedQueryServer
from repro_torch.serving.runtime import ServingRuntime
from repro_torch.testing import faults

torch.set_num_threads(2)
Q1, Q3, Q4 = (PAPER_QUERIES[q] for q in ("Q1", "Q3", "Q4"))


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.uninstall()


def _sel(patterns):
    return tuple(dict.fromkeys(
        v for p in patterns for v in (p.s, p.p, p.o)
        if isinstance(v, str) and v.startswith("?")))


@pytest.fixture(scope="module")
def raw():
    return generate_lubm(1, seed=7)


@pytest.fixture(scope="module")
def stores(raw):
    """The single store and an 8-shard store of the same triples (neither
    is mutated by the tests that share them)."""
    return (KnowledgeBase.build(raw, device="cpu"),
            ShardedKB.build(raw, n_shards=8, device="cpu"))


def test_sharded_snapshot_pins_across_insert(raw):
    """A pinned sharded snapshot answers at its version after an insert
    and a compaction; a fresh pin equals the live store, in two modes."""
    K = KnowledgeBase.build(raw, device="cpu")
    S = ShardedKB.build(raw, n_shards=4, device="cpu")
    reg = SnapshotRegistry(S, modes=("litemat", "rewrite"))
    pin = reg.pin()
    assert pin.snapshot.sharded and len(pin.snapshot.views["litemat"]) == 4
    queries = {"Q3": Q3, "Q4": Q4}
    before = {(q, m): pin.query(p, select=_sel(p), mode=m)[0]
              for q, p in queries.items() for m in ("litemat", "rewrite")}
    extra = generate_lubm(1, seed=8, univ_offset=1)
    cols = tuple(c[:3000] for c in (extra.s, extra.p, extra.o))
    for kb in (K, S):
        kb.insert(cols, auto_compact=False)
    for (q, m), rows in before.items():
        np.testing.assert_array_equal(
            pin.query(queries[q], select=_sel(queries[q]), mode=m)[0], rows)
    with reg.pin() as fresh:
        assert fresh.version == S.version != pin.version
        for (q, m), rows in before.items():
            p = queries[q]
            got = fresh.query(p, select=_sel(p), mode=m)[0]
            np.testing.assert_array_equal(
                got, K.query(p, select=_sel(p), mode=m)[0])
            np.testing.assert_array_equal(
                got, S.query(p, select=_sel(p), mode=m)[0])
            assert got.shape[0] >= rows.shape[0]
        np.testing.assert_array_equal(
            np.sort(fresh.store_rows("litemat"), axis=0),
            np.sort(S.store_rows("litemat").numpy(), axis=0))
    S.compact()
    np.testing.assert_array_equal(
        pin.query(Q4, select=_sel(Q4), mode="litemat")[0],
        before[("Q4", "litemat")])
    assert pin.snapshot.device_buffers()
    pin.release()


def test_sharded_query_batch_matches_solo(stores):
    """Every member's groups ride one run_batch per shard; each member's
    rows equal its solo pinned query and the single store's."""
    K, S = stores
    reg = SnapshotRegistry(S, modes=("litemat",))
    reqs = [(Q1, None), (Q3, None), (Q4, _sel(Q4))]
    reqs += [([Pattern("?x", "rdf:type", c)], None)
             for c in ("Student", "Course", "Department")]
    reqs += [([Pattern("?x", "rdf:type", c), Pattern("?x", "memberOf", "?y")],
              ("?y", "?x")) for c in ("Professor", "GraduateStudent")]
    reqs.append((Q1, None))  # a duplicate
    with reg.pin() as pin:
        batched = pin.query_batch(reqs)
        assert len(batched) == len(reqs)
        for (pats, sel), (rows, bsel) in zip(reqs, batched):
            solo, ssel = pin.query(pats, select=sel)
            assert bsel == ssel
            np.testing.assert_array_equal(rows, solo)
            want, _ = K.query(pats, select=ssel)
            np.testing.assert_array_equal(rows, want)


@pytest.mark.parametrize("kind", ["members", "prop_join"])
def test_sharded_query_server_matches_single(stores, kind):
    K, S = stores
    one, sharded = QueryServer(K, topk=16), ShardedQueryServer(S, topk=16)
    classes = CLASSES + ["Chair", "Person"]
    if kind == "members":
        want, got = one.class_members(classes), sharded.class_members(classes)
    else:
        props = [PROPS[i % len(PROPS)] for i in range(len(classes))]
        want = one.class_prop_join(classes, props)
        got = sharded.class_prop_join(classes, props)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert sharded.served_version == S.version
    if kind == "members":  # counts are the engine's distinct answers
        assert got[0][0] == len(K.answers(Q1))


def test_runtime_serves_a_sharded_store(stores):
    """The runtime over a ShardedKB: queries, a batched burst equal to
    solo runs, and server requests through the ShardedQueryServer."""
    K, S = stores
    rt = ServingRuntime(S, modes=("litemat",), n_workers=1,
                        batch_window_s=0.05, max_batch=8)
    with rt:
        solo = [rt.serve(q) for q in (Q1, Q3, Q4)]
        assert all(o.ok for o in solo)
        for o, q in zip(solo, (Q1, Q3, Q4)):  # sharded default select:
            assert o.answers == K.answers(q, select=_sel(q))  # pattern order
        futs = [rt.submit((Q1, Q3)[i % 2]) for i in range(6)]
        outs = [f.result() for f in futs]
        assert all(o.ok for o in outs)
        for i, o in enumerate(outs):
            assert o.answers == solo[i % 2].answers
        out = rt.class_members(["Professor", "Department"])
        assert out.ok
        counts, members = out.answers
        want_counts, want_members = QueryServer(K).class_members(
            ["Professor", "Department"])
        np.testing.assert_array_equal(counts, want_counts)
        np.testing.assert_array_equal(members, want_members)
        assert isinstance(rt._server, ShardedQueryServer)


def test_slow_shard_becomes_deadline_miss(stores):
    _, S = stores
    rt = ServingRuntime(S, modes=("litemat",), n_workers=1, max_retries=0)
    with rt:
        rt.registry.prewarm([Q1])
        assert rt.serve(Q1).ok
        with faults.inject() as inj:
            inj.arm("shard.query_shard", exc=None, delay_s=0.05, times=-1)
            out = rt.serve(Q1, deadline_s=0.2)
            assert out.status == "deadline"
            assert inj.fired("shard.query_shard") >= 1
        assert rt.serve(Q1, deadline_s=30.0).ok


def test_sharded_ledger_reports_every_shard(stores, monkeypatch):
    """track_ledger registers each shard under its index and the store
    under "stack" (empty: no stacked slabs on one device); per-shard live
    triples sum to the store's litemat rows."""
    _, S = stores
    reg = MetricsRegistry()
    led = ResourceLedger(registry=reg)
    monkeypatch.setattr(shard_mod, "LEDGER", led)
    monkeypatch.setattr(S, "_ledger_handles", [])
    S.track_ledger()
    S.track_ledger()  # idempotent
    assert len(S._ledger_handles) == S.n_shards + 1
    S.query(Q4)
    s = led.sample()
    assert set(s["shards"]) == {str(i) for i in range(8)} | {"stack"}
    for i in range(8):
        rec = s["shards"][str(i)]
        assert rec["total"] > 0 and rec["triples"] > 0
        assert reg.gauge_value("hbm_bytes", shard=str(i),
                               component="base") > 0
    assert s["shards"]["stack"]["total"] == 0
    total = sum(s["shards"][str(i)]["triples"] for i in range(8))
    assert total == S.store_rows("litemat").shape[0]
    assert led.sample()["total_bytes"] == s["total_bytes"]


def test_sharded_writes_under_readers(raw):
    """Inserts through the runtime while a reader thread pins and queries:
    every outcome ok, versions never go backwards."""
    S = ShardedKB.build(raw, n_shards=2, device="cpu")
    extra = generate_lubm(1, seed=9, univ_offset=2)
    rt = ServingRuntime(S, modes=("litemat",), n_workers=2)
    seen, errors = [], []

    def reader():
        try:
            for _ in range(6):
                o = rt.serve(Q1)
                assert o.ok
                seen.append(o.version)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    with rt:
        t = threading.Thread(target=reader)
        t.start()
        for k in range(3):
            lo = 500 * k
            rt.insert(tuple(c[lo:lo + 500] for c in (extra.s, extra.p,
                                                     extra.o)),
                      auto_compact=False)
        t.join(timeout=120)
    assert not t.is_alive() and not errors
    assert seen == sorted(seen)


def test_prop_join_counts_equal_the_engine():
    """Every class x property semi-join count, on one store and on 8
    shards, equals the engine's distinct answers — also where a class
    member is the last subject of a property view and its properties all
    sort below the requested one (LUBM-1, seed 0: Publication x
    takesCourse), which the reference's clamped search answers."""
    raw = generate_lubm(1, seed=0)
    K = KnowledgeBase.build(raw, device="cpu")
    S = ShardedKB.build(raw, n_shards=8, device="cpu")
    pairs = [(c, p) for c in CLASSES for p in PROPS]
    names, props = [c for c, _ in pairs], [p for _, p in pairs]
    want = np.array([len(K.answers([Pattern("?x", "rdf:type", c),
                                    Pattern("?x", p, "?y")], select=("?x",)))
                     for c, p in pairs], dtype=np.int32)
    for server in (QueryServer(K), ShardedQueryServer(S)):
        np.testing.assert_array_equal(
            server.class_prop_join(names, props)[0], want)
