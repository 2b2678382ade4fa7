"""Port parity, rewrite mode: the K4 member-compaction kernel's plain
version against the JAX package's ``ops.rewrite_member_compact`` (Pallas
in interpret mode on the CPU), and Q1–Q4 in rewrite mode on LUBM-1 (seed 7,
the shared ``lubm_kb`` fixture) through ``KnowledgeBase.build`` and
``KnowledgeBase.from_numpy``: the rows in order, explain(), the plan
cache's counters, and the paper's completeness check rewrite == litemat ==
full.  Everything compared is integer: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import query as j_query
from repro.core.query import QueryEngine as JQueryEngine
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
from repro_torch.core.query import Pattern
from repro_torch.core.query import QueryEngine as TQueryEngine
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import stream_compact as t_sc
from repro_torch.rdf.generator import generate_lubm
from repro_torch.rdf.vocab import lubm_ontology

from test_torch_query import _norm_selectivity, _state

torch.set_num_threads(2)
I32_MAX = np.iinfo(np.int32).max
ANSWERS = {"Q1": 752, "Q2": 14184, "Q3": 752, "Q4": 25}  # seed 7, LUBM-1


def _set(ids, cap):
    out = np.full(cap, I32_MAX, np.int32)
    ids = np.unique(np.asarray(ids, np.int32))
    out[: ids.shape[0]] = ids
    return out


def _rows(n, seed):
    """Seeded [n, 3] rows: predicates 0..13, some INVALID rows and objects."""
    rng = np.random.default_rng(seed)
    spo = rng.integers(0, 3000, (n, 3)).astype(np.int32)
    spo[:, 1] = rng.integers(0, 14, n)
    spo[rng.random(n) < 0.05] = I32_MAX  # INVALID subject rows
    spo[rng.random(n) < 0.05, 2] = I32_MAX  # INVALID objects
    return spo, rng.random(n) < 0.9


SETS = {
    "small": ([3, 5, 9, 2500], [1, 7], [2, 6, 11]),
    "all_pad": ([], [], []),
    "large": (np.arange(0, 3000, 3), np.arange(0, 14, 3), np.arange(1, 3000, 2)),
}


@pytest.mark.parametrize("sets", list(SETS))
@pytest.mark.parametrize("n,block", [(0, 512), (1300, 512), (9000, 4096)])
def test_member_compact_matches_reference(sets, n, block):
    mem_ids, dom_ids, rng_ids = SETS[sets]
    caps = [max(8, 1 << int(np.ceil(np.log2(max(len(x), 1)))))
            for x in (mem_ids, dom_ids, rng_ids)]
    mem, dom, rng = (_set(x, c) for x, c in zip((mem_ids, dom_ids, rng_ids), caps))
    spo, alive = _rows(n, seed=n + len(mem_ids))
    tid, cap = 4, 2048
    for has_dom in (False, True):
        for has_rng in (False, True):
            want = j_ops.rewrite_member_compact(
                jnp.asarray(spo), jnp.asarray(alive), jnp.int32(tid),
                jnp.asarray(mem), jnp.asarray(dom), jnp.asarray(rng), cap,
                has_dom, has_rng, block=block)
            got = t_ops.rewrite_member_compact(
                torch.as_tensor(spo), torch.as_tensor(alive), tid,
                torch.as_tensor(mem), torch.as_tensor(dom),
                torch.as_tensor(rng), cap, has_dom, has_rng, block=block)
            assert len(got) == len(want) == (6 if has_rng else 3)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))

            # the plain oracle: the reference's type-rewrite masks, then
            # ref_stream_compact of each stream
            m_s, m_o = j_query._type_rewrite_masks_dyn(
                jnp.asarray(spo), jnp.asarray(alive), jnp.asarray(mem),
                jnp.int32(tid), jnp.asarray(dom), jnp.asarray(rng), has_dom,
                has_rng)
            tiles = t_ref.ref_member_compact(
                torch.as_tensor(spo), torch.as_tensor(alive), tid,
                torch.as_tensor(mem), torch.as_tensor(dom),
                torch.as_tensor(rng), has_dom, has_rng, block)
            masks = [m_s] + ([m_o] if has_rng else [])
            for (local, counts), m in zip(tiles, masks):
                pad = block if n == 0 else (-n) % block
                mp = np.concatenate([np.asarray(m), np.zeros(pad, bool)])
                wl, wc = j_ref.ref_stream_compact(jnp.asarray(mp), block)
                np.testing.assert_array_equal(local.numpy(), np.asarray(wl))
                np.testing.assert_array_equal(counts.numpy(), np.asarray(wc))


@pytest.mark.parametrize("n,cap,has_dom,has_rng", [
    (0, 8, True, True),  # an empty store, both streams
    (5000, 64, True, True),  # two streams, caps under both totals
    (5000, 4096, True, False)])  # the subject stream alone, cap over it
def test_member_compact_plain_matches_reference_ops(n, cap, has_dom, has_rng):
    """K4's plain version against the JAX ``ops.rewrite_member_compact``
    (its Pallas kernel in interpret mode)."""
    mem, dom, rng = (_set(x, 8) for x in ([3, 5, 9, 2500], [1, 7], [2, 6, 7]))
    spo, alive = _rows(n, seed=n + 11)
    tid = 4
    want = j_ops.rewrite_member_compact(
        jnp.asarray(spo), jnp.asarray(alive), jnp.int32(tid), jnp.asarray(mem),
        jnp.asarray(dom), jnp.asarray(rng), cap, has_dom, has_rng)
    t = torch.as_tensor(spo)
    got = t_sc.member_compact_plain(
        t[:, 0], t[:, 1], t[:, 2], torch.as_tensor(alive), tid,
        torch.as_tensor(mem), torch.as_tensor(dom), torch.as_tensor(rng),
        has_dom, has_rng, cap)
    got = [x for triple in got for x in triple]
    assert len(got) == len(want) == (6 if has_rng else 3)
    if n and cap < 100:
        assert int(want[2]) > cap and int(want[5]) > cap
    for g, w in zip(got, want):
        assert g.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(bool): torch.bool}[np.asarray(w).dtype]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pass_counter_keys_match_reference():
    assert set(t_ops.reset_pass_counters()) == set(j_ops.reset_pass_counters())
    assert list(t_ops.pass_counters) == list(j_ops.pass_counters)


@pytest.fixture(scope="module")
def kbs(lubm_kb):
    jkb, _ = lubm_kb
    built = KnowledgeBase.build(generate_lubm(1, seed=7), device="cpu")
    loaded = KnowledgeBase.from_numpy(_state(jkb), lubm_ontology(), device="cpu")
    return jkb, built, loaded


@pytest.fixture(scope="module")
def reference_rewrite(kbs):
    """The reference's rewrite rows, explain() and engine state per
    use_index (rewrite plans scan either way)."""
    jkb = kbs[0]
    out = {}
    for use_index in (True, False):
        j = JQueryEngine(kb=jkb.kb, spo=jkb.kb.spo, mode="rewrite",
                         dtb=jkb.dtb, use_index=use_index)
        rows = {q: j.run(p)[0] for q, p in PAPER_QUERIES.items()}
        explain = {q: j.explain(p) for q, p in PAPER_QUERIES.items()}
        out[use_index] = (rows, explain, dict(j.cache_stats),
                          _norm_selectivity(j.observed_selectivity))
    return out


@pytest.mark.parametrize("use_index", [True, False])
@pytest.mark.parametrize("which", ["built", "from_numpy"])
def test_rewrite_engine_matches_reference(kbs, reference_rewrite, use_index,
                                          which):
    tkb = kbs[1] if which == "built" else kbs[2]
    rows_j, explain_j, stats_j, sel_j = reference_rewrite[use_index]
    t = TQueryEngine(kb=tkb.kb, spo=tkb.kb.spo, mode="rewrite", dtb=tkb.dtb,
                     use_index=use_index)
    for q, pats in PAPER_QUERIES.items():
        rows, _ = t.run(pats)
        assert rows.dtype == np.int32
        assert rows.shape[0] == ANSWERS[q], q
        np.testing.assert_array_equal(rows, rows_j[q], err_msg=q)
    for q, pats in PAPER_QUERIES.items():
        ex = t.explain(pats)
        assert ex == explain_j[q], q
        assert all(p["strategy"] == "scan" for p in ex["patterns"]), q
    assert t.cache_stats == stats_j
    assert _norm_selectivity(t.observed_selectivity) == sel_j


def test_rewrite_plans_alike_with_and_without_index(reference_rewrite):
    """Rewrite mode is scan-only: use_index=True and False plan alike."""
    for q in PAPER_QUERIES:
        assert reference_rewrite[True][1][q] == reference_rewrite[False][1][q]


def test_rewrite_equals_litemat_equals_full(kbs):
    """The paper's completeness check, through the port's facade."""
    tkb = kbs[1]
    for q, pats in PAPER_QUERIES.items():
        res = {m: tkb.answers(pats, mode=m) for m in ("litemat", "full", "rewrite")}
        assert res["litemat"] == res["full"] == res["rewrite"], q
        assert len(res["rewrite"]) == ANSWERS[q], q


def test_rewrite_dual_branch_is_one_member_pass(kbs):
    """(?x rdf:type Person) has domain AND range branches: one fused
    member-compaction pass (K4) emits both streams; the only mask
    compaction is DISTINCT's, and the answers equal litemat's and the
    reference's."""
    jkb, tkb, _ = kbs
    q = [Pattern("?x", "rdf:type", "Person")]
    want = tkb.answers(q, mode="litemat")
    eng = TQueryEngine(kb=tkb.kb, spo=tkb.kb.spo, mode="rewrite", dtb=tkb.dtb)
    sig = eng._lower(*eng._prepare(q)[0])[0]
    assert sig.extra_caps[2] and sig.extra_caps[3]  # has_dom and has_rng
    t_ops.reset_pass_counters()
    launches = t_sc.member_compact.launches
    rows, _ = eng.run(q)
    assert t_ops.pass_counters["member_compact"] == 1, t_ops.pass_counters
    assert t_ops.pass_counters["dual_compact"] == 0, t_ops.pass_counters
    assert t_ops.pass_counters["compact"] <= 1, t_ops.pass_counters
    assert t_sc.member_compact.launches == launches  # CPU: the plain version
    assert {tuple(r) for r in rows.tolist()} == want
    assert len(want) > 0
    jeng = JQueryEngine(kb=jkb.kb, spo=jkb.kb.spo, mode="rewrite", dtb=jkb.dtb)
    np.testing.assert_array_equal(rows, jeng.run(
        [j_query.Pattern("?x", "rdf:type", "Person")])[0])
