"""Port parity, the live store: seeded insert / delete / compact sequences
run step by step through the JAX package and the port on small
``generate_random_abox`` stores, as tests/test_update.py runs them.

After every step, each query in every mode returns the same rows in both
packages (ids are allocated by the same rule, so they agree), and the
answers in fingerprint space equal ``tests/oracle.py``'s ``NaiveKB``; the
``sizes()``, ``delta_ratio`` and the insert/delete/compact stats dicts are
equal.  tests/test_torch_live_ops.py runs the edges (device compaction,
faults, ``from_numpy`` mid-sequence) on the same helpers.  Everything
compared is integer: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

from oracle import NaiveKB, query_vars

from repro.core.engine import KnowledgeBase as JKB
from repro.core.query import Pattern as JPattern
from repro.core.tbox import Ontology as JOntology
from repro.rdf.generator import generate_random_abox as j_gen
from repro_torch.core.engine import KnowledgeBase as TKB
from repro_torch.core.query import Pattern as TPattern
from repro_torch.core.tbox import Ontology as TOntology
from repro_torch.rdf.generator import generate_random_abox as t_gen
from repro_torch.utils import pair64

torch.set_num_threads(2)
MODES = ("litemat", "full", "rewrite")
PLANES = ("fp_hi", "fp_lo", "ids", "rev_ids", "rev_hi", "rev_lo", "count")


def _onto_spec(seed: int) -> dict:
    """One DAG ontology (spills via a second parent, sub-properties,
    domain/range axioms) as Ontology keyword arguments."""
    rng = np.random.default_rng(seed)
    nc, npr = int(rng.integers(5, 10)), int(rng.integers(2, 5))
    concepts = [f"C{i}" for i in range(nc)]
    props = [f"p{i}" for i in range(npr)]
    subclass = [(concepts[i], concepts[int(rng.integers(0, i))])
                for i in range(1, nc)]
    if nc > 4:
        subclass.append((concepts[nc - 1], concepts[1]))
    subprop = [(props[i], props[int(rng.integers(0, i))])
               for i in range(1, npr)]
    domain = {props[0]: [concepts[1]]} if rng.random() < 0.7 else {}
    range_ = {props[-1]: [concepts[2]]} if rng.random() < 0.7 else {}
    return dict(concepts=concepts, properties=props, subclass=subclass,
                subprop=subprop, domain=domain, range_=range_)


def _queries(spec):
    c, p = spec["concepts"], spec["properties"]
    return [
        [("?x", "rdf:type", c[0])],
        [("?x", "rdf:type", c[1])],
        [("?x", p[0], "?y")],
        [("?x", "rdf:type", c[0]), ("?x", p[0], "?y")],
    ]


class Pair:
    """The same store in both packages, mutated in lockstep."""

    def __init__(self, spec, n_inst, n_type, n_prop, seed):
        self.spec = spec
        self.jonto, self.tonto = JOntology(**spec), TOntology(**spec)
        self.j = JKB.build(j_gen(self.jonto, n_inst, n_type, n_prop, seed=seed))
        raw = t_gen(self.tonto, n_inst, n_type, n_prop, seed=seed)
        self.t = TKB.build(raw, device="cpu")
        self.naive = NaiveKB(self.jonto)
        self.naive.insert(raw)
        self.cur = [raw.s.copy(), raw.p.copy(), raw.o.copy()]

    def insert(self, n_inst, n_type, n_prop, seed, auto_compact=False):
        sj = self.j.insert(j_gen(self.jonto, n_inst, n_type, n_prop, seed=seed),
                           auto_compact=auto_compact)
        extra = t_gen(self.tonto, n_inst, n_type, n_prop, seed=seed)
        st = self.t.insert(extra, auto_compact=auto_compact)
        assert st == sj
        self.naive.insert(extra)
        self.cur = [np.concatenate([c, e]) for c, e in
                    zip(self.cur, (extra.s, extra.p, extra.o))]

    def delete(self, idx):
        cols = tuple(c[idx] for c in self.cur)
        assert self.t.delete(cols, auto_compact=False) == \
            self.j.delete(cols, auto_compact=False)
        self.naive.delete(cols)
        gone = set(zip(*(c.tolist() for c in cols)))
        keep = np.array([t not in gone for t in zip(*(c.tolist() for c in self.cur))],
                        dtype=bool)
        self.cur = [c[keep] for c in self.cur]

    def compact(self, device=None):
        assert self.t.compact(device=device) == self.j.compact()
        self.naive.compact()

    def check(self, modes=MODES, queries=None, use_index=(True,),
              rows=True):
        """The port's answers equal NaiveKB's on every query and mode, and
        (``rows``) the reference's rows; sizes and ratios are equal."""
        for q in queries or _queries(self.spec):
            sel = query_vars([JPattern(*t) for t in q])
            want = self.naive.answers([JPattern(*t) for t in q], sel)
            for mode in modes:
                if not rows:  # serve the mode: its lazy derivation runs
                    self.j.view(mode)
                for ui in use_index:
                    rt, _ = self.t.query([TPattern(*t) for t in q], mode=mode,
                                         use_index=ui, select=sel)
                    assert _answers_fp(self.t, rt) == want, (mode, q)
                    if rows:
                        rj, _ = self.j.query([JPattern(*t) for t in q],
                                             mode=mode, use_index=ui,
                                             select=sel)
                        np.testing.assert_array_equal(rt, rj,
                                                      err_msg=f"{mode} {q}")
        assert self.t.sizes() == self.j.sizes()
        assert self.t.delta_ratio == self.j.delta_ratio
        assert self.t.version == self.j.version
        assert self.t.mat_counts == self.j.mat_counts
        assert self.t.n_live_triples() == self.j.n_live_triples()


def _answers_fp(kb, rows) -> set:
    """Answer rows with ids mapped back to term fingerprints."""
    if rows.size == 0:
        return set()
    hi, lo, hit = kb.kb.table.extract_fp(torch.as_tensor(rows.reshape(-1)))
    fps = pair64.combine_np(hi.numpy(), lo.numpy())
    fps = np.where(hit.numpy(), fps, rows.reshape(-1))
    return {tuple(r) for r in fps.reshape(rows.shape).tolist()}


@pytest.mark.parametrize("seed", [0, 1])
def test_update_sequence_matches_reference_and_oracle(seed):
    """insert, delete, a seeded third step, compact — after each step the
    port's answers equal NaiveKB's in all three modes and its sizes, ratio
    and stats equal the reference's; its rows equal the reference's at the
    end of the overlay's life (indexed, and two queries on the scan path)
    and after the compaction."""
    rng = np.random.default_rng(seed)
    spec = _onto_spec(seed)
    pair = Pair(spec, 100, 150, 120, seed)
    ops = ("insert", "delete", rng.choice(["insert", "delete"]), "compact")
    for step, op in enumerate(ops):
        if op == "insert":
            pair.insert(int(rng.integers(40, 150)), int(rng.integers(30, 100)),
                        int(rng.integers(30, 100)), seed=1000 * seed + step)
        elif op == "delete":
            n = pair.cur[0].shape[0]
            pair.delete(rng.choice(n, size=max(n // 10, 1), replace=False))
        else:
            pair.compact()
        last_overlay = step == len(ops) - 2
        pair.check(rows=last_overlay or op == "compact")
        if last_overlay:  # the scan path over the live store, too
            pair.check(queries=_queries(spec)[:2], use_index=(False,))


@pytest.mark.parametrize("seed", [0, 3])
def test_inl_plans_follow_reference_through_updates(seed):
    """The planner's INL choice and its observed-row feedback stay the
    reference's through insert, delete and compact: after every step,
    explain() of two INL-shaped joins (a subject probe of PSO, an object
    probe of POS) is the same dict in both packages, in litemat and full."""
    spec = _onto_spec(seed)
    c, p = spec["concepts"], spec["properties"]
    joins = ([("?x", "rdf:type", c[-1]), ("?x", p[0], "?y")],
             [("?x", "rdf:type", c[-1]), ("?y", p[-1], "?x")])
    pair = Pair(spec, 200, 40, 600, seed)

    def same_plans(step):
        for q in joins:
            for mode in ("litemat", "full"):
                ej = pair.j.engine(mode).explain([JPattern(*t) for t in q])
                et = pair.t.engine(mode).explain([TPattern(*t) for t in q])
                assert et == ej, (step, mode, q)
                if step == "build":
                    assert ej["patterns"][1]["strategy"] == "inl", (mode, q)

    same_plans("build")
    pair.insert(80, 20, 300, seed=seed + 50)
    same_plans("insert")
    n = pair.cur[0].shape[0]
    pair.delete(np.arange(0, n, 9))
    same_plans("delete")
    pair.compact()
    same_plans("compact")


def test_lazy_materialization_per_mode():
    """Serving one mode derives only that mode's delta."""
    pair = Pair(_onto_spec(11), 60, 80, 60, 11)
    pair.insert(40, 25, 20, seed=12)
    assert pair.t.mat_counts == {"litemat": 0, "full": 0}
    pair.check(modes=("litemat",), queries=_queries(pair.spec)[:1])
    assert pair.t.mat_counts == pair.j.mat_counts == {"litemat": 1, "full": 0}
    pair.check(modes=("full",), queries=_queries(pair.spec)[:1])
    assert pair.t.mat_counts == pair.j.mat_counts == {"litemat": 1, "full": 1}


def test_dictionary_growth_and_version():
    """New terms take ids past n_instance_terms (the same ids as the
    reference's), the base store is untouched, and every mutation bumps
    the version; deleting absent triples is a no-op."""
    pair = Pair(_onto_spec(6), 30, 40, 30, 6)
    t, j = pair.t, pair.j
    old = t.kb.spo.clone()
    pair.insert(90, 50, 20, seed=99)
    assert t.kb.n_instance_terms == j.kb.n_instance_terms
    assert torch.equal(t.kb.spo, old)
    np.testing.assert_array_equal(t.delta.log("rewrite").rows,
                                  j.delta.log("rewrite").rows)
    for jt, tt in zip(j.kb.tables, t.kb.tables):
        for f in PLANES:
            np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                          np.asarray(getattr(jt, f)), err_msg=f)
    missing = np.array([123456789], dtype=np.int64)
    assert t.delete((missing, missing, missing)) == {"n_deleted": 0}
    assert t.version == 1
    pair.compact()
    assert t.version == j.version == 2
    assert t.compact() == {"compacted": False}
