"""Port parity, the QueryServer: the batched class-membership (Q1) and
class-property semi-join (Q3) plans over the (object, subject)-sorted type
index, against the reference's QueryServer on the same store.

LUBM-1 (seed 7: the shared ``lubm_kb`` fixture, the port building the same
raw triples on the CPU) and a small ontology with a multi-parent concept
(spill intervals).  Counts and member planes are equal array for array;
the port's counts also equal its own ``KnowledgeBase.answers``; views are
rebuilt when the store's version moves.  Integer outputs: the tolerance is
zero.
"""
import numpy as np
import pytest
import torch

from repro.core.tbox import Ontology as JOntology
from repro.rdf.generator import generate_random_abox as j_gen
from repro.serving.engine import QueryServer as JQueryServer
from repro_torch.core.engine import KnowledgeBase
from repro_torch.core.index import TypeIndex
from repro_torch.core.query import Pattern
from repro_torch.core.tbox import Ontology
from repro_torch.launch.serve import CLASSES, PROPS
from repro_torch.rdf.generator import generate_lubm, generate_random_abox
from repro_torch.serving.engine import QueryServer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def kbs(lubm_kb):
    jkb, raw = lubm_kb
    return jkb, KnowledgeBase.build(generate_lubm(1, seed=7), device="cpu")


def _same(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_type_index_matches_reference(kbs):
    from repro.core.index import TypeIndex as JTypeIndex

    jkb, tkb = kbs
    tid = int(tkb.dtb.rdf_type_id)
    j = JTypeIndex.build(jkb.lite_spo, tid)
    t = TypeIndex.build(tkb.lite_spo, tid)
    np.testing.assert_array_equal(t.subj.numpy(), np.asarray(j.subj))
    np.testing.assert_array_equal(t.obj.numpy(), np.asarray(j.obj))
    assert t.n == j.n
    for lo, hi in ((0, 1), (3, 40), (-5, 2**31 - 1), (7, 7)):
        assert t.range_of(lo, hi) == j.range_of(lo, hi)


@pytest.mark.parametrize("topk", [8, 32])
def test_class_members_and_prop_join_match_reference(kbs, topk):
    """launch/serve.py's traffic shape: classes x properties in one batch,
    both plans, counts and members equal to the reference's."""
    jkb, tkb = kbs
    j, t = JQueryServer(jkb, topk=topk), QueryServer(tkb, topk=topk)
    names = CLASSES + CLASSES[::-1]
    _same(t.class_members(names), j.class_members(names))
    props = [PROPS[i % len(PROPS)] for i in range(len(names))]
    _same(t.class_prop_join(names, props), j.class_prop_join(names, props))


def test_counts_equal_engine_answers(kbs):
    _, tkb = kbs
    srv = QueryServer(tkb, topk=8)
    names = ["Professor", "Student", "Department", "Chair"]
    counts, members = srv.class_members(names)
    for name, cnt, mem in zip(names, counts, members):
        want = {r[0] for r in tkb.answers([Pattern("?x", "rdf:type", name)])}
        assert int(cnt) == len(want), name
        got = {int(v) for v in mem if v >= 0}
        assert got <= want and len(got) == min(8, len(want))
    counts, _ = srv.class_prop_join(["Professor"], ["worksFor"])
    want = tkb.answers([Pattern("?x", "rdf:type", "Professor"),
                        Pattern("?x", "worksFor", "?y")], select=("?x",))
    assert int(counts[0]) == len(want)


def test_spill_intervals_match_reference():
    """A concept with two parents gets a spill interval; both servers honor
    it, as the engines do."""
    spec = dict(concepts=["A", "B", "C", "D"], properties=["p0"],
                subclass=[("C", "A"), ("C", "B"), ("D", "B")], subprop=[],
                domain={}, range_={})
    from repro.core.engine import KnowledgeBase as JKnowledgeBase

    jkb = JKnowledgeBase.build(j_gen(JOntology(**spec), n_instances=30,
                                     n_type_triples=60, n_prop_triples=20,
                                     seed=3))
    tkb = KnowledgeBase.build(
        generate_random_abox(Ontology(**spec), n_instances=30,
                             n_type_triples=60, n_prop_triples=20, seed=3),
        device="cpu")
    j, t = JQueryServer(jkb, topk=32), QueryServer(tkb, topk=32)
    names = ["A", "B", "C", "D"]
    _same(t.class_members(names), j.class_members(names))
    _same(t.class_prop_join(["B", "A"], ["p0", "p0"]),
          j.class_prop_join(["B", "A"], ["p0", "p0"]))
    counts, _ = t.class_members(names)
    for name, cnt in zip(names, counts):
        want = {r[0] for r in tkb.answers([Pattern("?x", "rdf:type", name)])}
        assert int(cnt) == len(want), name


def test_empty_and_repeated_batches(kbs):
    jkb, tkb = kbs
    t, j = QueryServer(tkb, topk=4), JQueryServer(jkb, topk=4)
    _same(t.class_members(["Department", "Department"]),
          j.class_members(["Department", "Department"]))
    counts, members = t.class_members([])
    assert counts.shape == (0,) and members.shape == (0, 4)
    counts, members = t.class_prop_join([], [])
    assert counts.shape == (0,) and members.shape == (0, 4)


def test_views_rebuild_on_version_change():
    """A delete bumps the version: the next call rebuilds every view at the
    new version; invalidate() catches an out-of-API store swap."""
    raw = generate_lubm(1, seed=7)
    K = KnowledgeBase.build(raw, device="cpu")
    srv = QueryServer(K, topk=8)
    srv.class_members(["Professor"])
    v0 = srv.served_version
    s, p, o = np.asarray(raw.s), np.asarray(raw.p), np.asarray(raw.o)
    K.delete((s[:400], p[:400], o[:400]), auto_compact=False)
    after, _ = srv.class_members(["Professor"])
    assert srv.served_version == K.version != v0
    want = {r[0] for r in K.answers([Pattern("?x", "rdf:type", "Professor")])}
    assert int(after[0]) == len(want)

    old = K.lite_spo
    try:
        keep = old[:, 1] != int(K.dtb.rdf_type_id)
        K.lite_spo = old[keep]
        K._delta = None  # the swapped store is the whole store
        stale, _ = srv.class_members(["Professor"])
        assert int(stale[0]) == int(after[0])  # the views predate the swap
        srv.invalidate()
        fresh, _ = srv.class_members(["Professor"])
        assert int(fresh[0]) == 0
    finally:
        K.lite_spo = old
