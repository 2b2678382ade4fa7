"""Port parity, sharding on one device: the ShardedKB, its per-shard
dispatch loop, the host fold and the repartition combine
(tests/test_shard.py, tests/test_repartition.py and the sharded leg of
tests/test_faults.py, on the port).

A random store over the LUBM ontology (2,000 instances, 4 shards) is
built by the reference's ``ShardedKB`` and the port's on the same raw
triples: placement, planning and every shard's store in each mode are
equal array for array, and stay equal through an insert, a delete and a
compaction; the sharded answers equal the reference's single store in
fingerprint space in every mode, indexed and scan, and the sharded
servers' counts and members equal the reference's ``ShardedQueryServer``.  On LUBM-1 (seed 7, the port's 8-shard store on the CPU), Q1–Q4
in three modes, indexed and scan, equal the port's own ``KnowledgeBase``
row for row; the repartition combine equals the host fold and the single
store, also on a skewed join key; faults degrade or propagate as the
reference's do.
Integer outputs: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

from repro.core.engine import PAPER_QUERIES as J_QUERIES
from repro.core.engine import KnowledgeBase as JKnowledgeBase
from repro.core.query import Pattern as JPattern
from repro.core.shard import ShardedKB as JShardedKB
from repro.core.shard import partition_rows as j_partition_rows
from repro.core.shard import plan_groups as j_plan_groups
from repro.core.shard import shard_of as j_shard_of
from repro.rdf.generator import generate_random_abox as j_gen
from repro.rdf.vocab import lubm_ontology as j_lubm
from repro.serving.engine import ShardedQueryServer as JShardedQueryServer
from repro_torch.core import shard as shard_mod
from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
from repro_torch.core.query import Pattern
from repro_torch.core.shard import (
    ShardedKB, assert_partitioned, partition_rows, plan_groups, shard_of,
)
from repro_torch.core.snapshot import SnapshotRegistry
from repro_torch.core.tbox import RDF_TYPE, Ontology, build_tbox
from repro_torch.launch.serve import CLASSES, PROPS
from repro_torch.obs.metrics import REGISTRY
from repro_torch.rdf.generator import (
    RawDataset, generate_lubm, generate_random_abox,
)
from repro_torch.rdf.vocab import lubm_ontology
from repro_torch.serving.engine import ShardedQueryServer
from repro_torch.testing import faults
from repro_torch.testing.faults import FaultCrash, FaultError
from repro_torch.utils import pair64
from repro_torch.utils.hashing import fingerprint_string

torch.set_num_threads(2)
MODES = ("litemat", "full", "rewrite")


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.uninstall()


def _sel(patterns):
    return tuple(dict.fromkeys(
        v for p in patterns for v in (p.s, p.p, p.o)
        if isinstance(v, str) and v.startswith("?")))


def _fp(kb, rows) -> set:
    """Answer rows with ids mapped to term fingerprints, through the
    dictionary of ``kb`` (the port's or the reference's store)."""
    rows = np.asarray(rows)
    if rows.size == 0:
        return set()
    flat = rows.reshape(-1).astype(np.int32)
    ported = isinstance(kb, (KnowledgeBase, ShardedKB))
    hi, lo, hit = kb.kb.table.extract_fp(
        torch.as_tensor(flat) if ported else flat)
    fps = pair64.combine_np(np.asarray(hi), np.asarray(lo))
    fps = np.where(np.asarray(hit), fps, flat)
    return {tuple(r) for r in fps.reshape(rows.shape).tolist()}


def _shard_state(S) -> dict:
    """Every shard's live rows per mode and sizes, as numpy."""
    out = {mode: [np.asarray(K.store_rows(mode)).reshape(-1, 3)
                  for K in S.shards] for mode in MODES}
    out["sizes"] = [K.sizes() for K in S.shards]
    return out


# ---------------------------------------------------------------------------
# the reference's and the port's sharded stores of one random store
# ---------------------------------------------------------------------------


def _random_queries():
    return [
        [Pattern("?x", "rdf:type", "Professor")],
        [Pattern("?x", "memberOf", "?y")],
        [Pattern("?x", "rdf:type", "Person"), Pattern("?x", "memberOf", "?y")],
        [Pattern("?x", "rdf:type", "Faculty"),
         Pattern("?y", "rdf:type", "Organization"),
         Pattern("?x", "worksFor", "?y")],
    ]


@pytest.fixture(scope="module")
def random_pair():
    """(raw, reference store, port store, the states right after build)."""
    raw = j_gen(j_lubm(), n_instances=2000, n_type_triples=1500,
                n_prop_triples=3000, seed=3)
    J = JShardedKB.build(raw, n_shards=4)
    T = ShardedKB.build(raw, tbox=build_tbox(lubm_ontology()), n_shards=4,
                        device="cpu")
    return raw, J, T, _shard_state(J), _shard_state(T)


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_placement_and_planning_match_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    ids = np.concatenate([rng.integers(0, 2**31 - 1, 5000),
                          [0, 1, 2**31 - 1]]).astype(np.int32)
    np.testing.assert_array_equal(shard_of(ids, n_shards),
                                  j_shard_of(ids, n_shards))
    rows = rng.integers(0, 50_000, (3001, 3)).astype(np.int32)
    got, want = partition_rows(rows, n_shards), j_partition_rows(rows, n_shards)
    assert len(got) == len(want) == n_shards
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert all(p.shape == (0, 3) for p in partition_rows(rows[:0], n_shards))

    class _T:  # stand-in tbox: only rdf_type_id is consulted
        rdf_type_id = 7

    for name, pats in PAPER_QUERIES.items():
        for mode in MODES:
            assert plan_groups(pats, mode, _T) == j_plan_groups(
                J_QUERIES[name], mode, _T), (name, mode)
    q4 = PAPER_QUERIES["Q4"]
    assert {frozenset(g) for g in plan_groups(q4, "litemat", _T)} == {
        frozenset({0, 2}), frozenset({1})}


@pytest.mark.parametrize("mode", MODES)
def test_shard_stores_match_reference(random_pair, mode):
    """Every shard's store equals the reference's shard, array for array;
    summed lite sizes may exceed the single store's (range-derived type
    rows migrate to their object's shard), so nothing sums here."""
    _, _, _, want, got = random_pair
    for i, (g, w) in enumerate(zip(got[mode], want[mode])):
        np.testing.assert_array_equal(g, w, err_msg=f"{mode} shard {i}")
    assert got["sizes"] == want["sizes"]


@pytest.fixture(scope="module")
def reference_single(random_pair):
    """The reference's single store of the random store's raw triples."""
    return JKnowledgeBase.build(random_pair[0])


@pytest.mark.parametrize("mode", MODES)
def test_answers_match_reference_in_fingerprint_space(random_pair,
                                                      reference_single,
                                                      mode):
    """A query of two groups (the host fold joins them on ?y), indexed
    and scan, on the port's 4-shard store and the reference's single store:
    the same answers in fingerprint space.  One query a mode, since each
    costs the reference a compile; the others are held row for row to the
    port's single store in
    test_updates_match_reference_and_keep_partition."""
    _, _, T, _, _ = random_pair
    pats = [Pattern("?x", "worksFor", "?y"),
            Pattern("?y", "rdf:type", "Organization")]
    assert len(plan_groups(pats, mode, T.tbox)) == 2
    jpats = [JPattern(p.s, p.p, p.o) for p in pats]
    sel = _sel(pats)
    for use_index in (True, False):
        want, _ = reference_single.query(jpats, select=sel, mode=mode,
                                         use_index=use_index)
        got, _ = T.query(pats, select=sel, mode=mode, use_index=use_index)
        assert np.asarray(want).shape[0] > 0
        assert _fp(T, got) == _fp(reference_single, want), use_index


@pytest.mark.parametrize("mode", MODES)
def test_device_path_matches_reference_in_fingerprint_space(
        random_pair, reference_single, mode):
    """The device path on the 4 shards that share the CPU: every group's
    plan bodies enqueued shard after shard, the two-group query's
    results kept per shard through the repartition combine (no relation
    re-uploaded), indexed and scan: the reference's single store's
    answers in fingerprint space."""
    _, _, T, _, _ = random_pair
    pats = [Pattern("?x", "worksFor", "?y"),
            Pattern("?y", "rdf:type", "Organization")]
    jpats = [JPattern(p.s, p.p, p.o) for p in pats]
    sel = _sel(pats)
    uploads = REGISTRY.counter("device/transfer_bytes", src="combine_upload")
    for use_index in (True, False):
        eng = T.engine(mode, use_index)
        eng.use_repartition_join = True
        try:
            stats0, up0 = dict(eng.cache_stats), uploads.value
            got, _ = eng.run(pats, select=sel)
            assert eng.cache_stats["group_runs"] == stats0[
                "group_runs"] + 2  # one a group
            assert eng.cache_stats["repartition_runs"] == stats0[
                "repartition_runs"] + 1
            assert uploads.value == up0
        finally:
            eng.use_repartition_join = False
        want, _ = reference_single.query(jpats, select=sel, mode=mode,
                                         use_index=use_index)
        assert np.asarray(want).shape[0] > 0
        assert _fp(T, got) == _fp(reference_single, want), use_index


def test_sharded_query_server_matches_reference(random_pair):
    """Counts and member lists of the port's ShardedQueryServer equal the
    reference's on the same 4-shard store, for every class of the serving
    loop and each class with two of its properties."""
    _, J, T, _, _ = random_pair
    names = CLASSES + CLASSES
    props = [PROPS[(i + i // len(CLASSES)) % len(PROPS)]
             for i in range(len(names))]
    ref, port = JShardedQueryServer(J, topk=16), ShardedQueryServer(T, topk=16)
    for want, got in ((ref.class_members(CLASSES), port.class_members(CLASSES)),
                      (ref.class_prop_join(names, props),
                       port.class_prop_join(names, props))):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert int(np.asarray(want[0]).sum()) > 0


def test_updates_match_reference_and_keep_partition(random_pair):
    """insert / delete / compact on both sharded stores and on the port's
    single store: after every step each shard's stores equal the
    reference's, every row sits on its subject's shard, and the sharded
    answers equal the single store's row for row."""
    raw, J, T, _, _ = random_pair
    tbox = build_tbox(lubm_ontology())
    K = KnowledgeBase.build(raw, tbox=tbox, device="cpu")
    extra = j_gen(j_lubm(), n_instances=200, n_type_triples=200,
                  n_prop_triples=300, seed=11, instance_offset=100_000)
    gone = tuple(np.asarray(c)[::40] for c in (raw.s, raw.p, raw.o))
    script = [("insert", extra), ("delete", gone), ("compact", None)]
    for step, (op, payload) in enumerate(script):
        for S in (J, T, K):
            if op == "compact":
                S.compact()
            else:
                getattr(S, op)(payload, auto_compact=False)
        got, want = _shard_state(T), _shard_state(J)
        for mode in MODES:
            for i, (g, w) in enumerate(zip(got[mode], want[mode])):
                np.testing.assert_array_equal(g, w, err_msg=f"{op} {mode} {i}")
        assert T.version == J.version
        assert_partitioned(T)
        mode = MODES[step]
        for pats in _random_queries():
            sel = _sel(pats)
            want_rows, _ = K.query(pats, select=sel, mode=mode)
            got_rows, _ = T.query(pats, select=sel, mode=mode)
            np.testing.assert_array_equal(got_rows, want_rows)


# ---------------------------------------------------------------------------
# LUBM-1: the paper queries against the single store and the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lubm_pair():
    raw = generate_lubm(1, seed=7)
    return (KnowledgeBase.build(raw, device="cpu"),
            ShardedKB.build(raw, n_shards=8, device="cpu"))


@pytest.mark.parametrize("mode", MODES)
def test_paper_queries_match_single_store(lubm_pair, mode):
    """Every mode, indexed and scan, against the port's single store, row
    for row and in fingerprint space.  The single store answers as the
    reference's in every mode (test_torch_query.py, test_torch_rewrite.py),
    and the sharded store's answers the reference's on the random store
    (test_answers_match_reference_in_fingerprint_space); the reference's
    own LUBM-1 plans are left out here: each costs a compile, and this
    file keeps to the suite's time budget."""
    K, S = lubm_pair
    for name, pats in PAPER_QUERIES.items():
        sel = _sel(pats)
        for use_index in (True, False):
            want, _ = K.query(pats, select=sel, mode=mode, use_index=use_index)
            got, gsel = S.query(pats, select=sel, mode=mode,
                                use_index=use_index)
            assert gsel == sel and got.dtype == np.int32
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{name} {use_index}")
            assert _fp(S, got) == _fp(K, want), (name, use_index)


def test_constant_subject_routes_to_owner_shard(lubm_pair):
    K, S = lubm_pair
    s_id = int(K.kb.spo[0, 0])
    pats = [Pattern(s_id, "?p", "?y")]
    want, _ = K.query(pats, select=("?p", "?y"))
    got, _ = S.query(pats, select=("?p", "?y"))
    np.testing.assert_array_equal(got, want)
    owner = int(shard_of(np.asarray([s_id]), S.n_shards)[0])
    assert S.engine("litemat")._route_shards(pats) == [owner]
    assert S.engine("litemat")._route_shards(PAPER_QUERIES["Q1"]) == list(
        range(S.n_shards))
    with SnapshotRegistry(S).pin() as pin:  # pinned reads route the same
        np.testing.assert_array_equal(
            pin.query(pats, select=("?p", "?y"))[0], want)
        assert pin.snapshot._sharded_engine("litemat")._route_shards(
            pats) == [owner]


def _repartition(S, mode):
    eng = S.engine(mode)
    eng.use_repartition_join = True
    return eng


@pytest.mark.parametrize("mode", MODES)
def test_repartition_matches_host_fold_and_single(lubm_pair, mode):
    """Multi-group queries (Q4's ?y join; Q3 and Q4 in rewrite) through
    the repartition combine and the host fold: the same rows as the
    single store; only the host fold re-uploads a relation."""
    K, S = lubm_pair
    eng = _repartition(S, mode)
    uploads = REGISTRY.counter("device/transfer_bytes", src="combine_upload")
    try:
        for name, pats in PAPER_QUERIES.items():
            multi = len(plan_groups(pats, mode, S.tbox)) > 1
            want, wsel = K.query(pats, select=_sel(pats), mode=mode)
            runs0, up0 = eng.cache_stats["repartition_runs"], uploads.value
            got, gsel = eng.run(pats, select=wsel)
            assert gsel == wsel
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert eng.cache_stats["repartition_runs"] == runs0 + multi
            assert (uploads.value == up0) == multi, name
            eng.use_repartition_join = False
            host, _ = eng.run(pats, select=wsel)
            eng.use_repartition_join = True
            np.testing.assert_array_equal(host, got, err_msg=name)
        assert eng.cache_stats["exchange_faults"] == 0
    finally:
        eng.use_repartition_join = False


def _skew_onto():
    return Ontology(
        concepts=["C0", "C1", "C2"], properties=["p0", "p1"],
        subclass=[("C1", "C0"), ("C2", "C0")], subprop=[("p1", "p0")],
        domain={"p0": ["C1"]}, range_={})


@pytest.mark.parametrize("seed", [0, 1])
def test_skewed_join_key_parity(seed):
    """90% of the join keys are one object: the hot key's bin absorbs it
    without dropping or duplicating rows, in every mode."""
    onto = _skew_onto()
    raw = generate_random_abox(onto, n_instances=240, n_type_triples=400,
                               n_prop_triples=500, seed=seed)
    rng = np.random.default_rng(seed)
    idx = np.where(raw.p == fingerprint_string("p0"))[0]
    hot = raw.o[idx[0]]
    raw.o[rng.permutation(idx)[:int(idx.size * 0.9)]] = hot
    raw.s[idx[1]] = hot  # the hot instance needs a C2 type to join
    raw.p[idx[1]] = fingerprint_string(RDF_TYPE)
    raw.o[idx[1]] = fingerprint_string("C2")
    K = KnowledgeBase.build(raw, device="cpu")
    S = ShardedKB.build(raw, n_shards=4, device="cpu")
    q = [Pattern("?x", "p0", "?y"), Pattern("?y", "rdf:type", "C2")]
    sel = _sel(q)
    for mode in MODES:
        want, _ = K.query(q, select=sel, mode=mode)
        assert want.shape[0] > 50, "the skewed join should be dense"
        got, _ = _repartition(S, mode).run(q, select=sel)
        host, _ = S.engine(mode, use_index=False).run(q, select=sel)
        np.testing.assert_array_equal(got, want, err_msg=mode)
        np.testing.assert_array_equal(host, want, err_msg=mode)
    assert_partitioned(S)


def _ingest_parts(n_parts=4):
    return [generate_random_abox(lubm_ontology(), n_instances=150,
                                 n_type_triples=250, n_prop_triples=200,
                                 seed=10 + i, instance_offset=50_000 * i)
            for i in range(n_parts)]


def test_ingest_matches_a_single_build_lazily():
    """Bulk ingest of four parts into 4 shards, one part's encode failing
    twice: the part is retried, rows sit on their subject's shard,
    lite-only service derives no full rows, and every mode answers as a
    single build of the union (fingerprint space: ids follow the ingest
    order)."""
    parts = _ingest_parts()
    whole = RawDataset(*(np.concatenate([getattr(p, c) for p in parts])
                         for c in "spo"), onto=parts[0].onto)
    K = KnowledgeBase.build(whole, device="cpu")
    with faults.inject() as inj:
        inj.arm("shard.ingest_encode", exc=FaultError, after=1, times=2)
        S = ShardedKB.ingest(parts, n_shards=4, device="cpu", backoff_s=0.001)
    rep = S.ingest_report
    assert rep.ok and rep.n_retries == 2 and S.version == len(parts)
    assert [p["attempts"] for p in rep.parts] == [1, 3, 1, 1]
    assert rep.n_rows == whole.n_triples
    assert S.mat_counts == {"litemat": 0, "full": 0}
    queries = _random_queries()
    for mode in MODES:
        for q in queries:
            sel = _sel(q)
            got, _ = S.query(q, select=sel, mode=mode)
            want, _ = K.query(q, select=sel, mode=mode)
            assert _fp(S, got) == _fp(K, want), (mode, q)
        if mode == "litemat":
            assert S.mat_counts == {"litemat": len(parts), "full": 0}
    assert_partitioned(S)
    assert S.prewarm(queries[:2], buckets=(1 << 12,)) > 0  # new buckets
    assert len(S.warm_device("full")) == S.n_shards


@pytest.mark.parametrize("exc", [FaultError, FaultCrash])
def test_ingest_skips_a_failed_part(exc):
    """A part that keeps failing, or crashes once, is reported and
    skipped; the stream goes on at the version the last part published."""
    with faults.inject() as inj:
        inj.arm("shard.ingest_encode", exc=exc, after=2,
                times=3 if exc is FaultError else 1)
        S = ShardedKB.ingest(_ingest_parts(), n_shards=2, device="cpu",
                             max_part_retries=2, backoff_s=0.001)
        fired = inj.fired("shard.ingest_encode")
    rep = S.ingest_report
    assert [p["ok"] for p in rep.parts] == [True, True, False, True]
    assert rep.failed[0]["attempts"] == (3 if exc is FaultError else 1)
    assert exc.__name__ in rep.failed[0]["error"]
    assert fired == (3 if exc is FaultError else 1) and S.version == 3
    assert_partitioned(S)


# ---------------------------------------------------------------------------
# faults and the unported paths
# ---------------------------------------------------------------------------


def test_flush_crash_leaves_store_consistent():
    """A crash in the second shard's derivation commits nothing: the
    retried flush derives the backlog once (as the single store does)."""
    raw = generate_random_abox(lubm_ontology(), n_instances=300,
                               n_type_triples=300, n_prop_triples=500, seed=4)
    K = KnowledgeBase.build(raw, device="cpu")
    S = ShardedKB.build(raw, n_shards=2, device="cpu")
    extra = (raw.s[:64], raw.p[:64], raw.o[:64])
    K.insert(extra, auto_compact=False)
    S.insert(extra, auto_compact=False)
    with faults.inject() as inj:
        inj.arm("shard.flush_mat", exc=FaultCrash, after=1, times=1)
        with pytest.raises(FaultCrash):
            S._flush("litemat")
        assert inj.fired("shard.flush_mat") == 1
    pats = [Pattern("?x", "rdf:type", "Person"), Pattern("?x", "memberOf", "?y")]
    want, _ = K.query(pats, select=_sel(pats))
    got, _ = S.query(pats, select=_sel(pats))
    np.testing.assert_array_equal(got, want)
    assert S.mat_counts["litemat"] == 1
    assert_partitioned(S)


@pytest.mark.parametrize("exc", [FaultError, FaultCrash, RuntimeError])
def test_exchange_faults(lubm_pair, exc):
    """A transient exchange fault degrades to the host fold; a crash, or
    any other error (a kernel failing on the card), propagates."""
    K, S = lubm_pair
    eng = _repartition(S, "litemat")
    q4 = PAPER_QUERIES["Q4"]
    want, sel = K.query(q4, select=_sel(q4))
    try:
        faults0 = eng.cache_stats["exchange_faults"]
        fb = REGISTRY.counter("shard/combine_runs", path="host_fallback")
        fb0 = fb.value
        with faults.inject() as inj:
            inj.arm("shard.exchange", exc=exc, times=1)
            if exc is not FaultError:
                with pytest.raises(exc):
                    eng.run(q4, select=sel)
                return
            got, _ = eng.run(q4, select=sel)
            assert inj.fired("shard.exchange") == 1
        np.testing.assert_array_equal(got, want)
        assert eng.cache_stats["exchange_faults"] == faults0 + 1
        assert fb.value == fb0 + 1
        runs0 = eng.cache_stats["repartition_runs"]
        again, _ = eng.run(q4, select=sel)  # the fault is spent
        np.testing.assert_array_equal(again, want)
        assert eng.cache_stats["repartition_runs"] == runs0 + 1
    finally:
        eng.use_repartition_join = False


def test_unported_paths_refuse(lubm_pair, monkeypatch):
    """The device path, refused before sharding across devices was
    ported, now runs on shards that share a device (the CPU here), every
    routed shard's plan enqueued before any is read, and answers as the
    single store; a store without CUDA still raises unless a device says
    CPU."""
    K, S = lubm_pair
    eng = S.engine("full")
    runs0 = eng.cache_stats["group_runs"]
    got, sel = eng.run(PAPER_QUERIES["Q1"])
    want, _ = K.query(PAPER_QUERIES["Q1"], select=sel, mode="full")
    np.testing.assert_array_equal(got, want)
    assert eng.cache_stats["group_runs"] == runs0 + 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = generate_random_abox(lubm_ontology(), n_instances=20,
                               n_type_triples=20, n_prop_triples=20, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedKB.build(raw, n_shards=2)
    assert shard_mod._resolve_devices(device="cpu") == [torch.device("cpu")]
