"""Port parity, the build path: dictionary / ABox encoding and lite + full
materialization, on random ABoxes over the LUBM ontology and over DAG
ontologies with multiple inheritance (spill intervals) and an equivalence
cycle.  The JAX package and the port get the same numpy inputs; stores,
dictionary tables and stats must be identical (integers: zero tolerance,
``added_pct`` is the same Python float formula).
"""
import numpy as np
import pytest
import torch

from repro.core import abox as j_abox
from repro.core import closure as j_closure
from repro.core import materialize as j_mat
from repro.core import tbox as j_tbox
from repro.rdf import generator as j_gen
from repro.rdf.vocab import lubm_ontology as j_lubm
from repro_torch.core import abox as t_abox
from repro_torch.core import closure as t_closure
from repro_torch.core import materialize as t_mat
from repro_torch.core import tbox as t_tbox
from repro_torch.rdf.vocab import lubm_ontology as t_lubm
from test_torch_foundations import dag_ontology

torch.set_num_threads(2)

TABLE_PLANES = ("fp_hi", "fp_lo", "ids", "rev_ids", "rev_hi", "rev_lo", "count")


def _case(name):
    """(JAX raw, JAX tbox, port tbox) of one small random ABox."""
    if name == "lubm":
        j_onto, t_onto = j_lubm(), t_lubm()
    else:
        j_onto, t_onto = dag_ontology(int(name[-1]))
    raw = j_gen.generate_random_abox(j_onto, n_instances=400, n_type_triples=300,
                                     n_prop_triples=900, seed=5)
    return raw, j_tbox.build_tbox(j_onto), t_tbox.build_tbox(t_onto)


def _same_tables(j_tables, t_tables):
    assert len(j_tables) == len(t_tables)
    for jt, tt in zip(j_tables, t_tables):
        for f in TABLE_PLANES:
            got = getattr(tt, f)
            assert got.dtype == torch.int32, f
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jt, f)),
                                          err_msg=f)


@pytest.mark.parametrize("name", ["lubm", "dag3", "dag4"])
def test_encode_materialize_match(name):
    raw, j_tb, t_tb = _case(name)
    jkb = j_abox.encode_obe(raw, j_tb)
    tkb = t_abox.encode_obe(raw, t_tb, device="cpu")
    assert tkb.spo.dtype == torch.int32
    np.testing.assert_array_equal(tkb.spo.numpy(), np.asarray(jkb.spo))
    assert tkb.n_instance_terms == jkb.n_instance_terms
    _same_tables(jkb.tables, tkb.tables)
    _same_tables([jkb.table], [tkb.table])  # merged dictionary
    names = ["C3", "p1", "nope"] if name != "lubm" else ["Chair", "worksFor", "x"]
    assert np.array_equal(tkb.locate(names), jkb.locate(names))
    ids = np.asarray(jkb.spo)[:5].reshape(-1)
    assert tkb.extract(ids) == jkb.extract(ids)

    j_dtb = j_mat.DeviceTBox.build(j_tb)
    t_dtb = t_mat.DeviceTBox.build(t_tb, device="cpu")
    for f in ("concept_sorted_ids", "concept_sorted_bounds", "concept_spill_lo",
              "concept_spill_hi", "concept_ancestors", "prop_sorted_ids",
              "prop_ancestors", "dr_prop_ids", "domain_table", "range_table"):
        np.testing.assert_array_equal(getattr(t_dtb, f).numpy(),
                                      np.asarray(getattr(j_dtb, f)), err_msg=f)

    j_inst, j_conc, j_expl = j_mat.candidate_types(jkb.spo, j_dtb)
    t_inst, t_conc, t_expl = t_mat.candidate_types(tkb.spo, t_dtb)
    for g, w in ((t_inst, j_inst), (t_conc, j_conc), (t_expl, j_expl)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    for j_fn, t_fn in ((j_mat.lite_materialize, t_mat.lite_materialize),
                       (j_closure.full_materialize, t_closure.full_materialize)):
        j_out, j_valid, j_stats = j_fn(jkb, j_dtb)
        t_out, t_valid, t_stats = t_fn(tkb, t_dtb)
        got = t_mat.compact_rows(t_out, t_valid)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j_mat.compact_rows(j_out, j_valid)))
        assert t_stats == j_stats
        assert list(t_stats) == list(j_stats)


def test_encode_sae_matches():
    raw, _, _ = _case("lubm")
    jkb = j_abox.encode_sae(raw)
    tkb = t_abox.encode_sae(raw, device="cpu")
    np.testing.assert_array_equal(tkb.spo.numpy(), np.asarray(jkb.spo))
    assert tkb.n_instance_terms == jkb.n_instance_terms
    _same_tables(jkb.tables, tkb.tables)


def test_spill_intervals_reach_msc():
    """The DAG cases really exercise spills: some candidate is dropped only
    by a spill interval, in both packages alike."""
    raw, j_tb, t_tb = _case("dag3")
    assert any(t_tb.concepts.spill_big.values())
    tkb = t_abox.encode_obe(raw, t_tb, device="cpu")
    t_dtb = t_mat.DeviceTBox.build(t_tb, device="cpu")
    inst, conc, expl = t_mat.candidate_types(tkb.spo, t_dtb)
    no_spill = t_mat.DeviceTBox(**{
        **vars(t_dtb),
        "concept_spill_lo": torch.zeros_like(t_dtb.concept_spill_lo),
        "concept_spill_hi": torch.zeros_like(t_dtb.concept_spill_hi)})
    kept = t_mat.msc_select(inst, conc, expl, t_dtb)[2].sum()
    kept_without = t_mat.msc_select(inst, conc, expl, no_spill)[2].sum()
    assert kept < kept_without
