"""Port parity, snapshot isolation: pinned readers against the mutating
store (tests/test_snapshot.py and the single-store legs of
tests/test_faults.py, on the port).

On LUBM-1 (seed 7, built by the port on the CPU), a random store over
the LUBM ontology and a small seeded ontology: a pinned snapshot answers exactly as before any insert, delete
or compact (the device cache copies a leased liveness mask instead of
scattering into it); a fresh pin answers as ``tests/oracle.py``'s
``NaiveKB`` at the new version, and as the reference's pins do on the
same mutation script; refcounts gate retirement; a contended write lock
degrades a pin to the last published version; publish crashes, serving
transients and the widened retire window recover as the reference's do.
Answers are compared in fingerprint space or row for row: the tolerance
is zero.
"""
import threading

import numpy as np
import pytest
import torch

from oracle import NaiveKB, query_vars

from repro.core.engine import KnowledgeBase as JKB
from repro.core.query import Pattern as JPattern
from repro.core.snapshot import SnapshotRegistry as JRegistry
from repro.core.tbox import Ontology as JOntology
from repro.rdf.generator import generate_random_abox as j_gen
from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
from repro_torch.core.query import Pattern
from repro_torch.core.snapshot import SnapshotRegistry
from repro_torch.core.tbox import Ontology
from repro_torch.rdf.generator import generate_lubm, generate_random_abox
from repro_torch.rdf.vocab import lubm_ontology
from repro_torch.serving.runtime import ServingRuntime
from repro_torch.testing import faults
from repro_torch.testing.faults import FaultCrash, FaultError
from repro_torch.utils import pair64

torch.set_num_threads(2)
QUERIES = {name: PAPER_QUERIES[name] for name in ("Q1", "Q3", "Q4")}
Q1 = PAPER_QUERIES["Q1"]


@pytest.fixture(scope="module")
def raw():
    return generate_lubm(1, seed=7)


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.uninstall()


def _fp(kb, rows) -> set:
    """Answer rows with ids mapped back to term fingerprints."""
    if rows.size == 0:
        return set()
    hi, lo, hit = kb.kb.table.extract_fp(torch.as_tensor(rows.reshape(-1)))
    fps = pair64.combine_np(hi.numpy(), lo.numpy())
    fps = np.where(hit.numpy(), fps, rows.reshape(-1))
    return {tuple(r) for r in fps.reshape(rows.shape).tolist()}


def _mutation_script(raw):
    s, p, o = np.asarray(raw.s), np.asarray(raw.p), np.asarray(raw.o)
    return [
        ("delete", (s[:120], p[:120], o[:120])),
        ("insert", (s[:40], p[:40], o[:40])),  # re-insert some deleted rows
        ("compact", None),
        ("delete", (s[200:260], p[200:260], o[200:260])),
    ]


def _apply(kb, op, payload):
    if op == "insert":
        kb.insert(payload, auto_compact=False)
    elif op == "delete":
        kb.delete(payload, auto_compact=False)
    else:
        kb.compact()


def test_pinned_snapshot_immutable_and_fresh_pins_track_oracle():
    """The MVCC contract against the differential oracle per version, on a
    random store over the LUBM ontology (the oracle's joins are quadratic):
    the old pin answers at its version through every step, and a fresh pin
    at the new one; the batched path of a pin answers as its solo path."""
    raw = generate_random_abox(lubm_ontology(), n_instances=2000,
                               n_type_triples=1000, n_prop_triples=4000,
                               seed=1)
    kb = KnowledgeBase.build(raw, device="cpu")
    oracle = NaiveKB(raw.onto)
    oracle.insert(raw)
    reg = SnapshotRegistry(kb, modes=("litemat", "rewrite"))
    sel = {name: query_vars(q) for name, q in QUERIES.items()}
    pairs = [(name, mode) for name in QUERIES
             for mode in ("litemat", "rewrite")]
    pinned = reg.pin()

    def answers(pin, name, mode):
        rows, _ = pin.query(QUERIES[name], select=sel[name], mode=mode)
        return _fp(kb, rows)

    at_v0 = {(name, mode): answers(pinned, name, mode)
             for name, mode in pairs}
    for key, got in at_v0.items():
        assert got == oracle.answers(QUERIES[key[0]], sel[key[0]]), key

    for step, (op, payload) in enumerate(_mutation_script(raw)):
        _apply(kb, op, payload)
        if op == "insert":
            oracle.insert(payload)
        elif op == "delete":
            oracle.delete(payload)
        else:
            oracle.compact()
        name, mode = pairs[step % len(pairs)]
        assert answers(pinned, name, mode) == at_v0[(name, mode)], (op, name)
        name2, mode2 = pairs[(step + 1) % len(pairs)]
        with reg.pin() as fresh:
            assert fresh.version == kb.version
            assert answers(fresh, name2, mode2) == oracle.answers(
                QUERIES[name2], sel[name2]), (op, name2, mode2)

    with reg.pin() as fresh:
        for name, mode in pairs:
            assert answers(fresh, name, mode) == oracle.answers(
                QUERIES[name], sel[name]), (name, mode)
        reqs = [(QUERIES[n], sel[n]) for n in QUERIES]
        for (rows, _), (q, s) in zip(fresh.query_batch(reqs, mode="litemat"),
                                     reqs):
            np.testing.assert_array_equal(
                rows, fresh.query(q, select=s, mode="litemat")[0])
    for name, mode in pairs:
        assert answers(pinned, name, mode) == at_v0[(name, mode)], name
    pinned.release()


def test_pins_match_reference_through_mutations():
    """The same mutation script on a small store in both packages: pinned
    and fresh pins give the reference's rows, version tags and registry
    stats at every step."""
    spec = dict(concepts=["C0", "C1", "C2", "C3", "C4"],
                properties=["p0", "p1"],
                subclass=[("C1", "C0"), ("C2", "C0"), ("C3", "C1"),
                          ("C4", "C2"), ("C4", "C1")],
                subprop=[("p1", "p0")], domain={"p0": ["C1"]},
                range_={"p1": ["C2"]})
    j = JKB.build(j_gen(JOntology(**spec), 120, 160, 200, seed=4))
    t = KnowledgeBase.build(generate_random_abox(Ontology(**spec), 120, 160,
                                                 200, seed=4), device="cpu")
    jr, tr = JRegistry(j, modes=("litemat", "rewrite")), \
        SnapshotRegistry(t, modes=("litemat", "rewrite"))
    qs = [[("?x", "rdf:type", "C0")],
          [("?x", "rdf:type", "C1"), ("?x", "p0", "?y")]]
    jpin, tpin = jr.pin(), tr.pin()

    def same(jp, tp):
        assert tp.version == jp.version and tp.stale == jp.stale
        for q in qs:
            for mode in ("litemat", "rewrite"):
                rt, _ = tp.query([Pattern(*x) for x in q], mode=mode)
                rj, _ = jp.query([JPattern(*x) for x in q], mode=mode)
                np.testing.assert_array_equal(rt, np.asarray(rj))

    same(jpin, tpin)
    raw = generate_random_abox(Ontology(**spec), 120, 160, 200, seed=4)
    s, p, o = raw.s, raw.p, raw.o
    for op, payload in (("delete", (s[:50], p[:50], o[:50])),
                        ("insert", (s[:20], p[:20], o[:20])),
                        ("compact", None)):
        _apply(j, op, payload)
        _apply(t, op, payload)
        same(jpin, tpin)
        with jr.pin() as jf, tr.pin() as tf:
            same(jf, tf)
    jpin.release()
    tpin.release()
    assert tr.stats == jr.stats
    assert tr.live_versions() == jr.live_versions()


def test_refcounts_gate_retirement(raw):
    K = KnowledgeBase.build(raw, device="cpu")
    reg = SnapshotRegistry(K, modes=("litemat",))
    pin0 = reg.pin()
    v0 = pin0.version
    s, p, o = np.asarray(raw.s), np.asarray(raw.p), np.asarray(raw.o)
    K.delete((s[:30], p[:30], o[:30]), auto_compact=False)
    with reg.pin() as pin1:
        assert pin1.version == K.version != v0
        assert reg.pinned_versions() == [v0, pin1.version]
    K.compact()
    reg.publish()
    assert v0 in reg.live_versions()
    pin0.release()
    assert v0 not in reg.live_versions()


def test_contended_write_lock_degrades_to_stale_pin(raw):
    K = KnowledgeBase.build(raw, device="cpu")
    reg = SnapshotRegistry(K, modes=("litemat",), lock_timeout_s=0.01)
    reg.publish()
    v0 = K.version
    in_write = threading.Event()
    release = threading.Event()

    def writer():
        with K.write_lock:
            K.version += 1
            in_write.set()
            release.wait(5.0)
            K.version -= 1

    t = threading.Thread(target=writer)
    t.start()
    assert in_write.wait(5.0)
    try:
        with reg.pin() as pin:
            assert pin.stale and pin.version == v0
        assert reg.stats["stale_pins"] == 1
    finally:
        release.set()
        t.join()
    with reg.pin() as pin:
        assert not pin.stale


def test_snapshot_store_rows_match_live(raw):
    K = KnowledgeBase.build(raw, device="cpu")
    reg = SnapshotRegistry(K, modes=("litemat",))
    with reg.pin() as pin:
        live = K.store_rows("litemat").numpy()
        assert np.array_equal(np.sort(pin.store_rows("litemat"), axis=0),
                              np.sort(live, axis=0))


def test_sharded_store_is_refused():
    """No longer refused: the registry pins a ShardedKB through per-shard
    views, and a pin answers as the live store does."""
    from repro_torch.core.shard import ShardedKB

    raw = generate_random_abox(lubm_ontology(), n_instances=60,
                               n_type_triples=60, n_prop_triples=90, seed=2)
    S = ShardedKB.build(raw, n_shards=2, device="cpu")
    with SnapshotRegistry(S).pin() as pin:
        assert pin.snapshot.sharded
        assert len(pin.snapshot.views["litemat"]) == 2
        assert np.array_equal(pin.query(Q1)[0], S.query(Q1)[0])


# -- the single-store legs of tests/test_faults.py ---------------------------


def test_publish_crash_serves_stale_snapshot_then_catches_up(raw):
    K = KnowledgeBase.build(raw, device="cpu")
    rt = ServingRuntime(K, modes=("litemat",), n_workers=1,
                        pin_lock_timeout_s=0.05)
    s, p, o = np.asarray(raw.s), np.asarray(raw.p), np.asarray(raw.o)
    with rt:
        v0 = rt.serve(Q1).version
        with faults.inject() as inj:
            inj.arm("engine.flush_mat", exc=FaultCrash, times=2)
            assert rt.insert((s[:32], p[:32], o[:32]),
                             auto_compact=False)["n_inserted"] == 32
            assert rt.stats["publish_failures"] == 1
            out_stale = rt.serve(Q1)
            assert out_stale.ok and out_stale.stale
            assert out_stale.version == v0
            assert inj.fired("engine.flush_mat") == 2
        out_fresh = rt.serve(Q1)
        assert out_fresh.ok and not out_fresh.stale
        assert out_fresh.version == K.version != v0
        assert rt.stats["stale_served"] == 1


def test_serving_transient_retries_with_jitter_inside_deadline(raw):
    K = KnowledgeBase.build(raw, device="cpu")
    rt = ServingRuntime(K, modes=("litemat",), n_workers=1, max_retries=3,
                        retry_backoff_s=0.001)
    with rt:
        rt.registry.prewarm([Q1])
        with faults.inject() as inj:
            inj.arm("serving.execute", exc=FaultError, times=2)
            out = rt.serve(Q1, deadline_s=30.0)
            assert out.ok and out.retries == 2
        assert rt.stats["retries"] == 2
        with faults.inject() as inj:
            inj.arm("serving.execute", exc=FaultError, times=-1)
            out = rt.serve(Q1)
            assert out.status == "error" and "FaultError" in out.error
        with faults.inject() as inj:  # a slow attempt misses its deadline
            inj.arm("serving.execute", exc=None, delay_s=0.25, times=1)
            assert rt.serve(Q1, deadline_s=0.2).status == "deadline"
        assert rt.serve(Q1, deadline_s=30.0).ok


def test_retire_window_never_drops_a_pinned_version(raw):
    K = KnowledgeBase.build(raw, device="cpu")
    reg = SnapshotRegistry(K, modes=("litemat",))
    s, p, o = np.asarray(raw.s), np.asarray(raw.p), np.asarray(raw.o)
    reg.publish()
    errors = []
    with faults.inject() as inj:
        inj.arm("snapshot.retire", exc=None, delay_s=0.02, times=-1)

        def reader():
            try:
                for _ in range(6):
                    with reg.pin() as pin:
                        assert pin.version in reg.live_versions()
                        assert len(pin.answers(Q1)) > 0
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        for i in range(4):
            K.delete((s[i * 16:(i + 1) * 16], p[i * 16:(i + 1) * 16],
                      o[i * 16:(i + 1) * 16]), auto_compact=False)
            reg.publish()
        for t in threads:
            t.join()
        assert inj.hit_count("snapshot.retire") > 0
    assert not errors
    reg.retire()
    assert reg.live_versions() == [reg.published.version]
    assert reg.pinned_versions() == []
