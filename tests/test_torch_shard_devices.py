"""Port parity, sharding across devices: the sharded dictionary build, the
device path of ``ShardedQueryEngine`` and ``ShardedQueryServer``, the
combine's fault legs, the sharded encode and shard placement.

The reference's ``sharded_dictionary_fn`` body runs in-process under
``jax.vmap`` with a named axis (its ``all_to_all`` and ``all_gather``
lower there), over the same ``[S, cap]`` inputs the port's function takes
as per-shard tensors: every output is equal bit for bit.  The device path
runs on 4 shards that share the CPU, against a single store of the same
triples.  Integer outputs: the tolerance is zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dictionary import sharded_dictionary_fn as j_sharded_dict
from repro_torch.core.dictionary import sharded_dictionary_fn
from repro_torch.core.engine import KnowledgeBase
from repro_torch.core.query import Pattern
from repro_torch.core.shard import (
    ShardedKB, ShardedQueryEngine, _resolve_devices, assert_partitioned,
    plan_groups,
)
from repro_torch.core.snapshot import SnapshotRegistry
from repro_torch.launch.serve import CLASSES, PROPS
from repro_torch.obs.metrics import REGISTRY
from repro_torch.rdf.generator import RawDataset, generate_random_abox
from repro_torch.rdf.vocab import lubm_ontology
from repro_torch.serving.engine import QueryServer, ShardedQueryServer
from repro_torch.testing import faults
from repro_torch.testing.faults import FaultError
from repro_torch.utils import pair64

torch.set_num_threads(2)
MODES = ("litemat", "full", "rewrite")
CPU = torch.device("cpu")
QUERIES = [
    [Pattern("?x", "rdf:type", "Professor")],
    [Pattern("?x", "rdf:type", "Person"), Pattern("?x", "memberOf", "?y")],
    [Pattern("?x", "worksFor", "?y"),
     Pattern("?y", "rdf:type", "Organization")],  # two groups
]


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.uninstall()


def _sel(patterns):
    return tuple(dict.fromkeys(
        v for p in patterns for v in (p.s, p.p, p.o)
        if isinstance(v, str) and v.startswith("?")))


def _fp(kb, rows) -> set:
    """Answer rows as term fingerprints (ids differ between encodes)."""
    rows = np.asarray(rows)
    if rows.size == 0:
        return set()
    hi, lo, hit = kb.kb.table.extract_fp(
        torch.as_tensor(rows.reshape(-1).astype(np.int32)))
    assert bool(hit.all())
    fps = pair64.combine_np(hi.numpy(), lo.numpy())
    return {tuple(r) for r in fps.reshape(rows.shape).tolist()}


@pytest.mark.parametrize("S,cap", [(4, 64), (8, 32)])
def test_sharded_dictionary_matches_reference_bit_for_bit(S, cap):
    """Occurrence ids, the six table planes, overflow and counts: the
    reference's shard_map body (vmapped over a named axis) and the port's
    function over per-shard tensors, with duplicated occurrences, invalid
    slots and ids from 1000."""
    rng = np.random.default_rng(S)
    terms = rng.integers(0, 2**40, S * cap // 3)
    occ = rng.choice(terms, S * cap)  # every term about three times
    valid = rng.random(S * cap) < 0.85
    hi = np.where(valid, occ >> 31, 12345).astype(np.int32).reshape(S, cap)
    lo = (occ & (2**31 - 1)).astype(np.int32).reshape(S, cap)
    valid = valid.reshape(S, cap)
    body = j_sharded_dict("d", S, cap, base=1000)
    want = jax.jit(jax.vmap(body, axis_name="d"))(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    got = sharded_dictionary_fn(
        [torch.as_tensor(h) for h in hi], [torch.as_tensor(v) for v in lo],
        [torch.as_tensor(v) for v in valid], [CPU] * S, cap, 1000)
    (occ_w, table_w, ovf_w, cnt_w), (occ_g, table_g, ovf_g, cnt_g) = want, got
    np.testing.assert_array_equal(torch.stack(occ_g).numpy(),
                                  np.asarray(occ_w))
    for k in range(6):
        np.testing.assert_array_equal(
            torch.stack([t[k] for t in table_g]).numpy(),
            np.asarray(table_w[k]), err_msg=f"table plane {k}")
    np.testing.assert_array_equal(torch.stack(ovf_g).numpy(),
                                  np.asarray(ovf_w))
    np.testing.assert_array_equal(torch.stack(cnt_g).numpy(),
                                  np.asarray(cnt_w))
    ids = torch.stack(occ_g).numpy()[valid]
    assert ids.min() >= 1000 and int(torch.stack(cnt_g).sum()) == len(
        np.unique(occ.reshape(S, cap)[valid]))


@pytest.fixture(scope="module")
def stores():
    """(raw, single store, 4-shard store) of one small random store, all
    on the CPU."""
    raw = generate_random_abox(lubm_ontology(), n_instances=400,
                               n_type_triples=400, n_prop_triples=700,
                               seed=21)
    return (raw, KnowledgeBase.build(raw, device="cpu"),
            ShardedKB.build(raw, n_shards=4, device="cpu"))


def _engine(S, mode, repartition=False):
    """An engine of ``S`` with the combine chosen."""
    return ShardedQueryEngine(skb=S, mode=mode,
                              use_repartition_join=repartition)


@pytest.mark.parametrize("mode", MODES)
def test_forced_device_path_matches_loop_and_single(stores, mode):
    """Each query through the device path, with both combines for the
    two-group one, equals the single store row for row; every group run
    is counted, and a repartition only where it combines two groups."""
    _, K, S = stores
    eng = _engine(S, mode)
    for pats in QUERIES:
        sel = _sel(pats)
        want, _ = K.query(pats, select=sel, mode=mode)
        assert want.shape[0] > 0
        n_groups = len(plan_groups(pats, mode, S.tbox))
        for repartition in (False, True):
            eng.use_repartition_join = repartition
            runs0 = dict(eng.cache_stats)
            got, _ = eng.run(pats, select=sel)
            np.testing.assert_array_equal(got, want)
            assert eng.cache_stats["group_runs"] == (
                runs0["group_runs"] + n_groups)
            assert eng.cache_stats["repartition_runs"] == (
                runs0["repartition_runs"] + (repartition and n_groups > 1))


def test_sharded_server_and_pins_on_the_device_path(stores):
    """The sharded server's counts and members equal the single store's
    QueryServer; a pinned read through the device path equals the live
    one."""
    _, K, S = stores
    names, props = CLASSES[:4], PROPS[:4]
    srv, one = ShardedQueryServer(S, topk=8), QueryServer(K, topk=8)
    for (cg, mg), (cw, mw) in ((srv.class_members(names),
                                one.class_members(names)),
                               (srv.class_prop_join(names, props),
                                one.class_prop_join(names, props))):
        np.testing.assert_array_equal(cg, cw)
        np.testing.assert_array_equal(mg, mw)
        assert int(cg.sum()) > 0
    pats = QUERIES[2]
    with SnapshotRegistry(S).pin() as pin:
        eng = pin.snapshot._sharded_engine("litemat")
        got, _ = pin.query(pats, select=_sel(pats))
        assert eng.cache_stats["group_runs"] == 2
    np.testing.assert_array_equal(got, K.query(pats, select=_sel(pats))[0])


@pytest.mark.parametrize("exc", [FaultError, RuntimeError])
def test_device_fault_falls_back_only_on_fault_error(stores, exc):
    """A failure injected at ``shard.exchange`` over the device path's
    on-device results: ``FaultError`` falls back to the host fold
    (counted, traced), any other error propagates, the combine never
    degrading quietly."""
    _, K, S = stores
    eng = _engine(S, "litemat", repartition=True)
    pats = QUERIES[2]
    want, _ = K.query(pats, select=_sel(pats))
    fb = REGISTRY.counter("shard/exchange_faults")
    fb0 = fb.value
    with faults.inject() as inj:
        inj.arm("shard.exchange", exc=exc, times=1)
        if exc is not FaultError:
            with pytest.raises(exc):
                eng.run(pats, select=_sel(pats))
            assert eng.cache_stats["exchange_faults"] == 0
            return
        got, _ = eng.run(pats, select=_sel(pats))
        assert inj.fired("shard.exchange") == 1
    np.testing.assert_array_equal(got, want)
    assert eng.cache_stats["exchange_faults"] == 1 and fb.value == fb0 + 1
    assert eng.cache_stats["repartition_runs"] == 0
    again, _ = eng.run(pats, select=_sel(pats))  # the fault is spent
    np.testing.assert_array_equal(again, want)
    assert eng.cache_stats["repartition_runs"] == 1


def test_sharded_encode_ingest_matches_host_encode():
    """Ingest of three parts into 4 shards through the sharded dictionary
    encode against a host-encode control: the same new terms, rows on
    their subject's shard, and every mode's answers in fingerprint space
    (the ids differ: owner order, not fingerprint rank)."""
    onto = lubm_ontology()
    parts = [generate_random_abox(onto, n_instances=120, n_type_triples=150,
                                  n_prop_triples=150, seed=30 + i,
                                  instance_offset=40_000 * i)
             for i in range(3)]
    parts.append(RawDataset(parts[0].s[:40], parts[0].p[:40],
                            parts[1].o[:40], onto=onto))  # known terms only
    sharded = ShardedKB.ingest(parts, n_shards=4, device="cpu",
                               use_sharded_encode=True)
    host = ShardedKB.ingest(parts, n_shards=4, device="cpu",
                            use_sharded_encode=False)
    assert sharded._sharded_encode_on() and not host._sharded_encode_on()
    assert sharded.n_new_terms == host.n_new_terms > 0
    np.testing.assert_array_equal(np.sort(sharded._dyn.fps),
                                  np.sort(host._dyn.fps))
    assert sharded._dyn.next_id == host._dyn.next_id
    assert not np.array_equal(sharded._dyn.ids, host._dyn.ids)
    assert_partitioned(sharded)
    for mode in MODES:
        for pats in QUERIES:
            want, _ = host.query(pats, select=_sel(pats), mode=mode)
            got, _ = sharded.query(pats, select=_sel(pats), mode=mode)
            assert _fp(sharded, got) == _fp(host, want), (mode, pats)


def test_placement_and_auto_rules():
    """Shard i lives on ``devices[i % n]``; the sharded encode turns on by
    itself only with a device per shard; devices resolve with their
    index, each once."""
    cards = [torch.device("cuda", k) for k in range(3)]
    assert _resolve_devices([0, "cuda:1", torch.device("cuda", 1), 2,
                             "cpu"]) == [*cards, CPU]
    for n_shards, auto in ((3, True), (8, False), (1, False)):
        S = ShardedKB(shards=[], dtb=None, n_shards=n_shards,
                      device=cards[0], devices=cards[:n_shards])
        assert S.shard_devices() == [cards[i % 3] for i in range(n_shards)]
        S.use_sharded_encode = None
        assert S._sharded_encode_on() is auto
        S.use_sharded_encode = True
        assert S._sharded_encode_on()
    S = ShardedKB(shards=[], dtb=None, n_shards=4, device=CPU, devices=[CPU])
    assert not S._sharded_encode_on()  # a built store keeps the host encode
