"""Port parity, device-resident delta buckets: the O(delta) contract of
``DeviceStoreCache``, as tests/test_delta_device.py pins it for the JAX
package, on the port's CPU tensors.

  * post-mutation refresh moves O(delta) rows: the transfer counters and
    the delta-bucket shapes are identical on a 1x and a 4x base, and equal
    to the reference's counters for the same mutations;
  * growth inside a power-of-two bucket reallocates nothing, and the base
    arrays keep their identity across versions;
  * deletes reach the device as point scatters, in place — yet a view
    handed out earlier keeps its own snapshot: a pinned view's buffers
    are copied before a scatter, and an older view gets a one-off build.

Everything compared is integer: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

from repro.core.engine import KnowledgeBase as JKB
from repro.core.query import Pattern as JPattern
from repro.core.tbox import Ontology as JOntology
from repro.rdf.generator import RawDataset as JRaw
from repro.rdf.generator import generate_random_abox as j_gen
from repro_torch.core.engine import KnowledgeBase as TKB
from repro_torch.core.query import Pattern
from repro_torch.core.tbox import RDF_TYPE, Ontology
from repro_torch.rdf.generator import RawDataset, generate_random_abox
from repro_torch.utils.hashing import fingerprint_string, mix64

torch.set_num_threads(2)


def _spec() -> dict:
    concepts = [f"C{i}" for i in range(7)]
    props = [f"p{i}" for i in range(4)]
    return dict(
        concepts=concepts, properties=props,
        subclass=[(concepts[i], concepts[max(0, i - 2)]) for i in range(1, 7)],
        subprop=[(props[1], props[0])],
        domain={props[0]: [concepts[1]]},
        range_={props[3]: [concepts[2]]},
    )


def _kb(onto, scale: int, seed: int = 0) -> TKB:
    raw = generate_random_abox(onto, n_instances=40 * scale,
                               n_type_triples=60 * scale,
                               n_prop_triples=50 * scale, seed=seed)
    return TKB.build(raw, device="cpu")


def _disjoint_delta(onto, seed: int, raw_cls=RawDataset, n_inst=30,
                    n_type=20, n_prop=15):
    """A delta whose instance terms are disjoint from every base's, so a
    delete's re-derivation frontier cannot touch the base."""
    rng = np.random.default_rng(seed)
    inst = mix64(np.int64(777), np.arange(n_inst) + 1_000_000, 0, 0)
    cfps = np.array([fingerprint_string(c) for c in onto.concepts])
    pfps = np.array([fingerprint_string(p) for p in onto.properties])
    s = np.concatenate([inst[rng.integers(0, n_inst, n_type)],
                        inst[rng.integers(0, n_inst, n_prop)]])
    p = np.concatenate([np.full(n_type, fingerprint_string(RDF_TYPE)),
                        pfps[rng.integers(0, len(pfps), n_prop)]])
    o = np.concatenate([cfps[rng.integers(0, len(cfps), n_type)],
                        inst[rng.integers(0, n_inst, n_prop)]])
    return raw_cls(s=s, p=p, o=o, onto=onto)


def _mutate(K, extra):
    """One fixed-size insert + one fixed-size delete (same on every base)."""
    K.insert(extra, auto_compact=False)
    K.delete((extra.s[:5], extra.p[:5], extra.o[:5]), auto_compact=False)


QUERY = [Pattern("?x", "rdf:type", "C1")]


@pytest.mark.parametrize("mode", ["litemat", "full", "rewrite"])
def test_warmup_transfer_independent_of_base_size(mode):
    """Same delta on a 1x and a 4x base -> identical transfer stats and
    bucket shapes, equal to the reference's for the same mutations."""
    onto = Ontology(**_spec())
    snaps = {}
    for scale in (1, 4):
        K = _kb(onto, scale)
        K.answers(QUERY, mode=mode)  # build base state pre-mutation
        cache = K.dev_cache(mode)
        before = dict(cache.stats)
        _mutate(K, _disjoint_delta(onto, seed=99))
        K.answers(QUERY, mode=mode)  # first post-mutation query: syncs
        after = dict(cache.stats)
        snaps[scale] = ({k: after[k] - before[k] for k in after},
                        {k: cache.buffer_shapes(k) for k in ("scan", "pos")
                         if cache.buffer_shapes(k)})
    (stats1, shapes1), (stats4, shapes4) = snaps[1], snaps[4]
    for key in ("upload_delta_rows", "upload_alive_rows", "delta_allocs"):
        assert stats1[key] == stats4[key], (key, stats1, stats4)
    assert shapes1 == shapes4
    assert stats1["stale_view_builds"] == stats4["stale_view_builds"] == 0

    # the reference moves the same delta rows for the same mutations
    jonto = JOntology(**_spec())
    J = JKB.build(j_gen(jonto, n_instances=40, n_type_triples=60,
                        n_prop_triples=50, seed=0))
    J.answers([JPattern("?x", "rdf:type", "C1")], mode=mode)
    jcache = J.dev_cache(mode)
    jbefore = dict(jcache.stats)
    _mutate(J, _disjoint_delta(jonto, seed=99, raw_cls=JRaw))
    J.answers([JPattern("?x", "rdf:type", "C1")], mode=mode)
    for key in ("upload_delta_rows", "upload_alive_rows", "delta_allocs",
                "upload_base_alive_rows", "kill_scatter_rows",
                "alive_privatize_rows", "base_rebuilds"):
        assert stats1[key] == jcache.stats[key] - jbefore[key], key
    assert shapes1 == {k: jcache.buffer_shapes(k) for k in ("scan", "pos")
                       if jcache.buffer_shapes(k)}


def test_bucket_growth_reuses_buffers():
    """Delta growth inside a pow2 bucket reallocates nothing; the base
    arrays keep their identity across every version."""
    onto = Ontology(**_spec())
    K = _kb(onto, 1)
    K.answers(QUERY)
    cache = K.dev_cache("litemat")
    base0 = K.view("litemat").dev("pos").base

    def tiny(seed, n):
        return generate_random_abox(onto, n_instances=5, n_type_triples=n,
                                    n_prop_triples=0, seed=seed)

    K.insert(tiny(1, 3), auto_compact=False)
    K.answers(QUERY)
    allocs0 = cache.stats["delta_allocs"]
    shape0, cap0 = cache.buffer_shapes("pos")
    K.insert(tiny(2, 2), auto_compact=False)  # grow WITHIN the bucket
    K.answers(QUERY)
    assert cache.stats["delta_allocs"] == allocs0
    assert cache.buffer_shapes("pos") == (shape0, cap0)
    lite_delta = K.delta.log("litemat").n
    K.insert(generate_random_abox(onto, n_instances=40,
                                  n_type_triples=4 * cap0, n_prop_triples=0,
                                  seed=3), auto_compact=False)
    K.answers(QUERY)
    assert K.delta.log("litemat").n > cap0 >= lite_delta
    assert cache.stats["delta_allocs"] > allocs0
    shape1, cap1 = cache.buffer_shapes("pos")
    assert cap1 > cap0 and shape1[0] == cap1
    assert K.view("litemat").dev("pos").base is base0  # never re-concatenated


def test_delete_scatters_in_place_without_mask_uploads():
    """Deletes after the first reach the device as point scatters into
    the SAME resident buffer: no base-sized upload or copy."""
    onto = Ontology(**_spec())
    K = _kb(onto, 2)
    extra = generate_random_abox(onto, n_instances=30, n_type_triples=20,
                                 n_prop_triples=15, seed=7)
    _mutate(K, extra)
    K.answers(QUERY)
    cache = K.dev_cache("litemat")
    ptr = K.view("litemat").dev("pos").base_alive.data_ptr()
    before = dict(cache.stats)
    K.delete((extra.s[5:9], extra.p[5:9], extra.o[5:9]), auto_compact=False)
    K.answers(QUERY)
    after = dict(cache.stats)
    assert after["kill_scatter_rows"] > before["kill_scatter_rows"]
    assert K.view("litemat").dev("pos").base_alive.data_ptr() == ptr
    for key in ("upload_base_alive_rows", "alive_privatize_rows",
                "lease_copy_rows"):
        assert after[key] == before[key], key


def test_scatter_leaves_earlier_views_unchanged():
    """A pinned view's resident mask is copied before the next scatter,
    and an older unpinned view is served a one-off build of its own
    version: neither sees a later delete."""
    onto = Ontology(**_spec())
    K = _kb(onto, 2)
    extra = generate_random_abox(onto, n_instances=30, n_type_triples=20,
                                 n_prop_triples=15, seed=8)
    _mutate(K, extra)
    pinned = K.view("litemat")
    pinned.pinned = True
    ds_pinned = pinned.dev("pos")
    mask0 = ds_pinned.base_alive.clone()
    old_answers = K.answers(QUERY)
    cache = K.dev_cache("litemat")
    copies = cache.stats["lease_copy_rows"]
    K.delete((extra.s[5:12], extra.p[5:12], extra.o[5:12]),
             auto_compact=False)
    K.answers(QUERY)  # the live view syncs: scatter into a private copy
    assert cache.stats["lease_copy_rows"] > copies
    assert torch.equal(ds_pinned.base_alive, mask0)
    assert not torch.equal(K.view("litemat").dev("pos").base_alive, mask0)

    stale = cache.stats["stale_view_builds"]
    again = pinned.dev("pos")  # older than the resident state: one-off
    assert cache.stats["stale_view_builds"] == stale + 1
    assert torch.equal(again.base_alive, mask0)
    assert torch.equal(again.delta_alive, ds_pinned.delta_alive)
    from repro_torch.core.query import QueryEngine
    eng = QueryEngine(kb=K.kb, spo=K.lite_spo, mode="litemat", dtb=K.dtb,
                      view=pinned)
    assert {tuple(r) for r in eng.run(QUERY)[0].tolist()} == old_answers


def test_pre_compaction_view_never_rewinds_cache():
    """A view from before a compaction is served one-off builds; the
    resident state stays on the new base."""
    onto = Ontology(**_spec())
    K = _kb(onto, 1)
    K.insert(_disjoint_delta(onto, seed=51), auto_compact=False)
    old = K.view("litemat")
    old.dev("pos")
    K.compact()
    K.answers(QUERY)
    cache = K.dev_cache("litemat")
    rebuilds = cache.stats["base_rebuilds"]
    live = K.view("litemat").dev("pos").base
    for _ in range(3):
        old.dev("pos")
        assert K.view("litemat").dev("pos").base is live
    assert cache.stats["base_rebuilds"] == rebuilds
    assert cache.stats["stale_view_builds"] >= 3
