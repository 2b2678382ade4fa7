"""Port parity, the whole slice: LUBM-1 (seed 7, the shared ``lubm_kb``
fixture) built and queried by the JAX package and by the port on the CPU.
This file runs the litemat mode; tests/test_torch_query_full.py imports its
fixtures and engine tests and runs them in full mode (``MODE``), so each
file stays short under the suite's one-file-per-worker scheduling.

Checked equal: store sizes, the encoded / lite / full stores, dictionary
tables and stats; Q1–Q4 answers (the rows themselves, in order) in litemat
and full modes, indexed and scan; explain() output; the plan cache's
counters and the observed selectivities — both through
``KnowledgeBase.build`` and through ``KnowledgeBase.from_numpy`` on the
reference's arrays.  Everything compared is integer (or the same float
formula over equal integers): the tolerance is zero.
"""
import numpy as np
import pytest
import torch

from repro.core.query import QueryEngine as JQueryEngine
from repro_torch.core.engine import PAPER_QUERIES, KnowledgeBase
from repro_torch.core.query import QueryEngine as TQueryEngine
from repro_torch.rdf.generator import generate_lubm
from repro_torch.rdf.vocab import lubm_ontology

torch.set_num_threads(2)

MODE = "litemat"
ANSWERS = {"Q1": 752, "Q2": 14184, "Q3": 752, "Q4": 25}  # seed 7, LUBM-1
PLANS = {"Q1": [("slice", "pos")], "Q2": [("slice", "pos")],
         "Q3": [("slice", "pos"), ("inl", "pso")],
         "Q4": [("slice", "pos"), ("inl", "pso"), ("slice", "pos")]}


def _arrays(kb):
    return {"spo": np.asarray(kb.kb.spo), "lite_spo": np.asarray(kb.lite_spo),
            "full_spo": np.asarray(kb.full_spo)}


def _state(jkb) -> dict:
    """The reference KnowledgeBase as the numpy state ``from_numpy`` takes."""
    planes = ("fp_hi", "fp_lo", "ids", "rev_ids", "rev_hi", "rev_lo", "count")
    return {**_arrays(jkb),
            "tables": [{f: np.asarray(getattr(t, f)) for f in planes}
                       for t in jkb.kb.tables],
            "n_instance_terms": jkb.kb.n_instance_terms,
            "lite_stats": jkb.lite_stats, "full_stats": jkb.full_stats}


@pytest.fixture(scope="module")
def kbs(lubm_kb):
    jkb, _ = lubm_kb
    built = KnowledgeBase.build(generate_lubm(1, seed=7), device="cpu")
    loaded = KnowledgeBase.from_numpy(_state(jkb), lubm_ontology(), device="cpu")
    return jkb, built, loaded


def _norm_selectivity(sel: dict) -> dict:
    """observed_selectivity keyed by package-neutral fields (the reference's
    const keys carry a 4th, member-set slot that litemat/full leave None)."""
    out = {}
    for (sig, bucket), v in sel.items():
        b = tuple(tuple(None if t is None else tuple(t[:3]) for t in ck)
                  for ck in bucket)
        out[(sig.strategy, sig.store, sig.pvars, sig.n_pids, b)] = v
    return out


def _engines(jkb, tkb, mode, use_index):
    """Fresh engines of both packages over the same store."""
    store = "lite_spo" if mode == "litemat" else "full_spo"
    j = JQueryEngine(kb=jkb.kb, spo=getattr(jkb, store), mode=mode,
                     dtb=jkb.dtb, use_index=use_index)
    t = TQueryEngine(kb=tkb.kb, spo=getattr(tkb, store), mode=mode,
                     dtb=tkb.dtb, use_index=use_index)
    return j, t


@pytest.fixture(scope="module")
def reference_runs(kbs, request):
    """The reference's rows, explain() and engine state per use_index, in
    the calling module's ``MODE``."""
    jkb = kbs[0]
    out = {}
    for use_index in (True, False):
        j, _ = _engines(jkb, kbs[1], request.module.MODE, use_index)
        rows = {q: j.run(p)[0] for q, p in PAPER_QUERIES.items()}
        explain = {q: j.explain(p) for q, p in PAPER_QUERIES.items()}
        out[use_index] = (rows, explain, dict(j.cache_stats),
                          _norm_selectivity(j.observed_selectivity))
    return out


def test_build_without_device_raises_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KnowledgeBase.build(generate_lubm(1, seed=7))


def test_build_matches_reference(kbs):
    jkb, tkb, _ = kbs
    assert tkb.sizes() == jkb.sizes()
    want = _arrays(jkb)
    for name, got in _arrays_t(tkb).items():
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    for jt, tt in zip(jkb.kb.tables, tkb.kb.tables):
        for f in ("fp_hi", "fp_lo", "ids", "rev_ids", "rev_hi", "rev_lo", "count"):
            np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                          np.asarray(getattr(jt, f)), err_msg=f)
    assert tkb.kb.n_instance_terms == jkb.kb.n_instance_terms
    assert tkb.lite_stats == jkb.lite_stats
    assert list(tkb.lite_stats) == list(jkb.lite_stats)
    assert tkb.full_stats == jkb.full_stats


def _arrays_t(tkb):
    return {"spo": tkb.kb.spo.numpy(), "lite_spo": tkb.lite_spo.numpy(),
            "full_spo": tkb.full_spo.numpy()}


@pytest.mark.parametrize("use_index", [True, False])
@pytest.mark.parametrize("which", ["built", "from_numpy"])
def test_engine_matches_reference(kbs, reference_runs, use_index, which, request):
    mode = request.module.MODE
    tkb = kbs[1] if which == "built" else kbs[2]
    rows_j, explain_j, stats_j, sel_j = reference_runs[use_index]
    _, t = _engines(kbs[0], tkb, mode, use_index)
    for q, pats in PAPER_QUERIES.items():
        rows, _ = t.run(pats)
        assert rows.dtype == np.int32
        assert rows.shape[0] == ANSWERS[q], q
        np.testing.assert_array_equal(rows, rows_j[q], err_msg=q)
    for q, pats in PAPER_QUERIES.items():
        ex = t.explain(pats)
        assert ex == explain_j[q], q
        if use_index:
            assert [(p["strategy"], p["store"]) for p in ex["patterns"]] == PLANS[q]
    assert t.cache_stats == stats_j
    assert _norm_selectivity(t.observed_selectivity) == sel_j


@pytest.mark.parametrize("which", ["built", "from_numpy"])
def test_facade_answers_match(kbs, reference_runs, which, request):
    mode = request.module.MODE
    tkb = kbs[1] if which == "built" else kbs[2]
    for use_index in (True, False):
        rows_j = reference_runs[use_index][0]
        for q, pats in PAPER_QUERIES.items():
            got = tkb.answers(pats, mode=mode, use_index=use_index)
            assert got == {tuple(r) for r in rows_j[q].tolist()}, q
    tkb.prewarm(modes=(mode,))
    assert tkb.prewarm(modes=(mode,)) == 0  # every plan is cached now
