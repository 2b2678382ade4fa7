"""Port parity, host foundations: generators, TBox encoding, pair64, intervals.

The same inputs, made from seeds with numpy, go through the JAX package
(``repro``) and the PyTorch port (``repro_torch``); everything compared is
integer, so the tolerance is zero throughout.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import intervals as j_iv
from repro.core import tbox as j_tbox
from repro.rdf import generator as j_gen
from repro.utils import pair64 as j_pair64
from repro_torch.core import intervals as t_iv
from repro_torch.core import tbox as t_tbox
from repro_torch.rdf import generator as t_gen
from repro_torch.utils import pair64 as t_pair64

torch.set_num_threads(2)


def dag_ontology(seed: int, n_concepts: int = 40, n_props: int = 12):
    """(JAX Ontology, port Ontology) of one random DAG ontology.

    Up to three parents per concept (multiple inheritance -> spill
    intervals), one equivalence cycle, sub-properties and domain/range
    axioms, all drawn from ``seed``.
    """
    rng = np.random.default_rng(seed)
    concepts = [f"C{i}" for i in range(n_concepts)]
    props = [f"p{i}" for i in range(n_props)]
    subclass = []
    for i in range(1, n_concepts):
        k = int(rng.integers(1, min(3, i) + 1))
        for par in rng.choice(i, size=k, replace=False):
            subclass.append((concepts[i], concepts[int(par)]))
    subclass += [(concepts[1], concepts[2]), (concepts[2], concepts[1])]
    subprop = [(props[i], props[int(rng.integers(0, i))])
               for i in range(1, n_props)]
    domain = {props[i]: [concepts[int(rng.integers(0, n_concepts))]]
              for i in range(n_props) if rng.random() < 0.7}
    range_ = {props[i]: [concepts[int(rng.integers(0, n_concepts))]]
              for i in range(n_props) if rng.random() < 0.6}

    def make(mod):
        return mod.Ontology(concepts=list(concepts), properties=list(props),
                            subclass=list(subclass), subprop=list(subprop),
                            domain={k: list(v) for k, v in domain.items()},
                            range_={k: list(v) for k, v in range_.items()})

    return make(j_tbox), make(t_tbox)


def _port_onto(onto):
    return t_tbox.Ontology(concepts=list(onto.concepts),
                           properties=list(onto.properties),
                           subclass=list(onto.subclass),
                           subprop=list(onto.subprop),
                           domain={k: list(v) for k, v in onto.domain.items()},
                           range_={k: list(v) for k, v in onto.range_.items()})


def _same_raw(a, b):
    for col in ("s", "p", "o"):
        x, y = getattr(a, col), getattr(b, col)
        assert x.dtype == y.dtype == np.int64
        assert np.array_equal(x, y), col


def test_generate_lubm_fingerprints_match():
    _same_raw(j_gen.generate_lubm(1, seed=0), t_gen.generate_lubm(1, seed=0))


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_random_abox_matches(seed):
    j_onto = j_gen.generate_deep_ontology(n_concepts=120, seed=seed)
    t_onto = t_gen.generate_deep_ontology(n_concepts=120, seed=seed)
    assert j_onto == j_tbox.Ontology(**vars(_port_onto(t_onto)))
    _same_raw(j_gen.generate_random_abox(j_onto, 500, 400, 900, seed=seed),
              t_gen.generate_random_abox(t_onto, 500, 400, 900, seed=seed))


def _same_hierarchy(a, b):
    assert a.total_bits == b.total_bits
    assert a.ids_big == b.ids_big
    assert a.spill_big == b.spill_big
    assert a.tax.names == b.tax.names
    for f in ("ids", "used_bits", "bounds", "sorted_ids", "sorted_bounds",
              "sorted_used", "sorted_ancestors", "sorted_spill_lo",
              "sorted_spill_hi", "ids_wide", "bounds_wide"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _same_tbox(a, b):
    _same_hierarchy(a.concepts, b.concepts)
    _same_hierarchy(a.properties, b.properties)
    assert a.rdf_type_id == b.rdf_type_id
    assert a.instance_base == b.instance_base
    for f in ("dr_prop_ids", "domain_table", "range_table"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _ontologies():
    from repro.rdf.vocab import lubm_ontology as j_lubm
    from repro_torch.rdf.vocab import lubm_ontology as t_lubm

    yield "lubm", j_lubm(), t_lubm()
    for seed in (1, 2):
        yield f"dag{seed}", *dag_ontology(seed)
    deep = j_gen.generate_deep_ontology(n_concepts=300, seed=5, max_depth=9)
    yield "deep", deep, _port_onto(deep)


@pytest.mark.parametrize("parallel", [False, True])
def test_tbox_ids_bounds_spills_match(parallel):
    for name, j_onto, t_onto in _ontologies():
        ja = j_tbox.build_tbox(j_onto, parallel=parallel)
        tb = t_tbox.build_tbox(t_onto, parallel=parallel)
        _same_tbox(ja, tb)
        if name.startswith("dag"):  # the DAG ontologies carry spills
            assert ja.concepts.spill_big


def test_parallel_encoder_matches_reference_parallel():
    for _, j_onto, _ in _ontologies():
        tax = j_tbox.build_taxonomy(j_onto.concepts, j_onto.subclass)
        _same_hierarchy(j_tbox.encode_hierarchy_parallel(tax),
                        t_tbox.encode_hierarchy_parallel(tax))


def _pairs(rng, n, lo_hi=6):
    """Random (hi, lo) planes with many duplicates and sentinel rows."""
    hi = rng.integers(0, lo_hi, n).astype(np.int32)
    lo = rng.integers(0, 50, n).astype(np.int32)
    hi[rng.random(n) < 0.05] = np.iinfo(np.int32).max
    return hi, lo


@pytest.mark.parametrize("n_table", [1, 7, 300])
def test_pair64_search_lookup_sort_match(n_table):
    rng = np.random.default_rng(n_table)
    th, tl = _pairs(rng, n_table)
    order = np.lexsort((tl, th))
    th, tl = th[order], tl[order]
    qh, ql = _pairs(rng, 200)
    vals = rng.integers(-5, 99, n_table).astype(np.int32)
    J = [jnp.asarray(a) for a in (th, tl, qh, ql, vals)]
    T = [torch.as_tensor(a) for a in (th, tl, qh, ql, vals)]
    for side in ("left", "right"):
        want = np.asarray(j_pair64.searchsorted_pair(*J[:4], side=side))
        got = t_pair64.searchsorted_pair(*T[:4], side=side)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), side
    if n_table == 1:  # the reference cannot search an empty table; the
        empty = T[0][:0]  # port puts every query at 0
        assert not t_pair64.searchsorted_pair(empty, empty, T[2], T[3]).any()
    jv, jh = j_pair64.lookup_pair(J[0], J[1], J[4], J[2], J[3])
    tv, th_ = t_pair64.lookup_pair(T[0], T[1], T[4], T[2], T[3])
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(th_.numpy(), np.asarray(jh))
    jhs, jls, _ = j_pair64.sort_pairs(J[2], J[3])
    ths, tls, _ = t_pair64.sort_pairs(T[2], T[3])
    assert np.array_equal(ths.numpy(), np.asarray(jhs))
    assert np.array_equal(tls.numpy(), np.asarray(jls))
    assert np.array_equal(t_pair64.unique_mask_sorted(ths, tls).numpy(),
                          np.asarray(j_pair64.unique_mask_sorted(jhs, jls)))


def test_pair64_host_split_combine_match():
    fp = np.random.default_rng(0).integers(0, 1 << 61, 1000, dtype=np.int64)
    for a, b in zip(j_pair64.split_np(fp), t_pair64.split_np(fp)):
        assert np.array_equal(a, b)
    assert np.array_equal(t_pair64.combine_np(*t_pair64.split_np(fp)), fp)


def test_intervals_match():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1 << 14, 300).astype(np.int32)
    used = rng.integers(0, 15, 300).astype(np.int32)
    for fn in ("bound_of", "ancestor_at"):
        want = np.asarray(getattr(j_iv, fn)(jnp.asarray(ids), jnp.asarray(used), 14))
        got = getattr(t_iv, fn)(torch.as_tensor(ids), torch.as_tensor(used), 14)
        assert np.array_equal(got.numpy(), want), fn
        host = getattr(t_iv, fn)(ids, used, 14)
        assert isinstance(host, np.ndarray) and np.array_equal(host, want), fn
    table = np.unique(ids)
    q = rng.integers(0, 1 << 14, 400).astype(np.int32)
    want = np.asarray(j_iv.lookup_index(jnp.asarray(table), jnp.asarray(q)))
    assert np.array_equal(
        t_iv.lookup_index(torch.as_tensor(table), torch.as_tensor(q)).numpy(), want)
    a = rng.integers(0, 3, (200, 3)).astype(np.int32)
    b = rng.integers(0, 3, (200, 3)).astype(np.int32)
    for fn in ("lex_lt", "lex_le"):
        want = np.asarray(getattr(j_iv, fn)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(t_iv, fn)(torch.as_tensor(a), torch.as_tensor(b))
        assert np.array_equal(got.numpy(), want), fn
    assert j_iv.unpack_wide(j_iv.pack_wide(12345678901, 3)) == \
        t_iv.unpack_wide(t_iv.pack_wide(12345678901, 3)) == 12345678901
