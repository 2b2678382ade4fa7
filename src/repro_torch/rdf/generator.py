"""Synthetic RDF dataset generators (LUBM-style + stress ontologies).

The paper evaluates on LUBM1K/LUBM10K (133M / 1.3B triples) plus DBPedia and
Wikidata dumps.  We reproduce the *generator* side: a vectorized LUBM-like
ABox builder whose per-university triple count (~130K) and type/property/
literal mix match the benchmark, and random deep/wide ontology generators
that stand in for DBPedia (depth > 6 branches) and Wikidata (>200K concepts,
deep enough to need wide ids).

Terms are produced directly as structural 63-bit fingerprints (mix64 of
small int tuples) so that building millions of triples never materializes
millions of Python strings; renderable IRI strings are kept optionally
(``keep_strings``) for locate/extract round-trip tests — the same
driver/executor split as the paper's Spark pipeline.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.tbox import RDF_TYPE, Ontology
from repro_torch.rdf.vocab import lubm_ontology
from repro_torch.utils.hashing import fingerprint_string, mix64

# entity kinds (structural fingerprint name-spaces)
(K_UNIV, K_DEPT, K_RG, K_FP, K_AP, K_ASP, K_LECT, K_UG, K_GR, K_CRS, K_GCRS,
 K_PUB, K_RES) = range(1, 14)
K_LIT = 20  # literal namespace: mix64(K_LIT, field, owner_fp)

FACULTY_CONCEPT = {
    K_FP: "FullProfessor",
    K_AP: "AssociateProfessor",
    K_ASP: "AssistantProfessor",
    K_LECT: "Lecturer",
}
_KIND_LABEL = {
    K_UNIV: "University", K_DEPT: "Department", K_RG: "ResearchGroup",
    K_FP: "FullProfessor", K_AP: "AssociateProfessor",
    K_ASP: "AssistantProfessor", K_LECT: "Lecturer",
    K_UG: "UndergraduateStudent", K_GR: "GraduateStudent",
    K_CRS: "Course", K_GCRS: "GraduateCourse", K_PUB: "Publication",
    K_RES: "Research",
}
_LIT_FIELDS = {1: "emailAddress", 2: "name", 3: "telephone", 4: "researchInterest"}


@dataclass
class RawDataset:
    """Unencoded triples as parallel fingerprint columns (the 'string' KB)."""

    s: np.ndarray  # int64[N]
    p: np.ndarray  # int64[N]
    o: np.ndarray  # int64[N]
    onto: Ontology
    term_strings: dict | None = None  # fp -> IRI/literal string
    meta: dict | None = None

    @property
    def n_triples(self) -> int:
        return int(self.s.shape[0])

    def triples(self) -> np.ndarray:
        return np.stack([self.s, self.p, self.o], axis=1)


class _TripleSink:
    def __init__(self):
        self.s, self.p, self.o = [], [], []

    def add(self, s, p, o):
        s, p, o = np.broadcast_arrays(
            np.asarray(s, dtype=np.int64),
            np.asarray(p, dtype=np.int64),
            np.asarray(o, dtype=np.int64),
        )
        self.s.append(s.ravel())
        self.p.append(p.ravel())
        self.o.append(o.ravel())

    def arrays(self):
        return (
            np.concatenate(self.s) if self.s else np.zeros(0, np.int64),
            np.concatenate(self.p) if self.p else np.zeros(0, np.int64),
            np.concatenate(self.o) if self.o else np.zeros(0, np.int64),
        )


def _ent(kind, u, d, i):
    return mix64(np.int64(kind), np.int64(u), np.int64(d), np.int64(i))


def _lit(field, owner_fp):
    return mix64(np.int64(K_LIT), np.int64(field), np.asarray(owner_fp, dtype=np.int64))


def generate_lubm(
    n_universities: int = 1,
    seed: int = 0,
    keep_strings: bool = False,
    literals: bool = True,
    univ_offset: int = 0,
) -> RawDataset:
    """LUBM-like ABox: ~130K triples per university (cf. paper Table III).

    ``univ_offset`` shifts the university index space: universities are
    numbered ``[univ_offset, univ_offset + n_universities)``, so a dataset
    generated at a disjoint offset is a pure-growth *delta* over a base KB
    (every entity term is new) — the shape incremental-update benchmarks
    and tests feed to ``KnowledgeBase.insert``.
    """
    onto = lubm_ontology()
    rng = np.random.default_rng(seed)
    sink = _TripleSink()

    cfp = {c: fingerprint_string(c) for c in onto.concepts}
    pfp = {p: fingerprint_string(p) for p in onto.properties + [RDF_TYPE]}
    TYPE = pfp[RDF_TYPE]

    univs = _ent(K_UNIV, univ_offset + np.arange(n_universities), 0, 0)
    sink.add(univs, TYPE, cfp["University"])

    for u in range(univ_offset, univ_offset + n_universities):
        n_dept = int(rng.integers(15, 26))
        for d in range(n_dept):
            dept = _ent(K_DEPT, u, d, 0)
            sink.add(dept, TYPE, cfp["Department"])
            sink.add(dept, pfp["subOrganizationOf"], univs[u - univ_offset])

            n_rg = int(rng.integers(10, 21))
            rgs = _ent(K_RG, u, d, np.arange(n_rg))
            sink.add(rgs, TYPE, cfp["ResearchGroup"])
            sink.add(rgs, pfp["subOrganizationOf"], dept)
            res = _ent(K_RES, u, d, np.arange(n_rg))
            sink.add(res, TYPE, cfp["Research"])
            sink.add(rgs, pfp["researchProject"], res)

            # ---- faculty -------------------------------------------------
            fac_kind_counts = {
                K_FP: int(rng.integers(7, 11)),
                K_AP: int(rng.integers(10, 15)),
                K_ASP: int(rng.integers(8, 12)),
                K_LECT: int(rng.integers(5, 8)),
            }
            fac_fps, prof_fps = [], []
            for kind, cnt in fac_kind_counts.items():
                f = _ent(kind, u, d, np.arange(cnt))
                fac_fps.append(f)
                if kind in (K_FP, K_AP, K_ASP):
                    prof_fps.append(f)
                sink.add(f, TYPE, cfp[FACULTY_CONCEPT[kind]])
            faculty = np.concatenate(fac_fps)
            professors = np.concatenate(prof_fps)
            nf = faculty.shape[0]
            sink.add(faculty, pfp["worksFor"], dept)
            # the chair heads the department — NO explicit Chair type: the
            # paper's Q4 relies on it being derivable from domain(headOf).
            sink.add(faculty[:1], pfp["headOf"], dept)
            for prop in ("undergraduateDegreeFrom", "mastersDegreeFrom", "doctoralDegreeFrom"):
                sink.add(faculty, pfp[prop], univs[rng.integers(0, n_universities, nf)])

            # ---- courses -------------------------------------------------
            n_crs = nf * 2
            n_gcrs = max(nf, 1)
            courses = _ent(K_CRS, u, d, np.arange(n_crs))
            gcourses = _ent(K_GCRS, u, d, np.arange(n_gcrs))
            sink.add(courses, TYPE, cfp["Course"])
            sink.add(gcourses, TYPE, cfp["GraduateCourse"])
            sink.add(faculty, pfp["teacherOf"], courses[rng.permutation(n_crs)[:nf]])
            sink.add(faculty, pfp["teacherOf"], gcourses[rng.integers(0, n_gcrs, nf)])

            # ---- publications --------------------------------------------
            pubs_per = rng.integers(5, 16, nf)
            n_pub = int(pubs_per.sum())
            pubs = _ent(K_PUB, u, d, np.arange(n_pub))
            pub_cls = rng.choice(
                [cfp["JournalArticle"], cfp["ConferencePaper"], cfp["TechnicalReport"], cfp["Book"]],
                size=n_pub,
            )
            sink.add(pubs, TYPE, pub_cls)
            sink.add(pubs, pfp["publicationAuthor"], np.repeat(faculty, pubs_per))

            # ---- students ------------------------------------------------
            n_ug = nf * int(rng.integers(8, 15))
            n_gr = nf * int(rng.integers(3, 5))
            ug = _ent(K_UG, u, d, np.arange(n_ug))
            gr = _ent(K_GR, u, d, np.arange(n_gr))
            sink.add(ug, TYPE, cfp["UndergraduateStudent"])
            sink.add(gr, TYPE, cfp["GraduateStudent"])
            sink.add(ug, pfp["memberOf"], dept)
            sink.add(gr, pfp["memberOf"], dept)
            # course loads
            for _ in range(3):
                sink.add(ug, pfp["takesCourse"], courses[rng.integers(0, n_crs, n_ug)])
            for _ in range(2):
                sink.add(gr, pfp["takesCourse"], gcourses[rng.integers(0, n_gcrs, n_gr)])
            # advisors: all grads, 1/5 of undergrads
            sink.add(gr, pfp["advisor"], professors[rng.integers(0, professors.shape[0], n_gr)])
            ug_adv = ug[rng.random(n_ug) < 0.2]
            sink.add(ug_adv, pfp["advisor"], professors[rng.integers(0, professors.shape[0], ug_adv.shape[0])])
            sink.add(gr, pfp["undergraduateDegreeFrom"], univs[rng.integers(0, n_universities, n_gr)])
            # 1/5 of grads TA a course (type TeachingAssistant is *derived*)
            tas = gr[rng.random(n_gr) < 0.2]
            sink.add(tas, pfp["teachingAssistantOf"], courses[rng.integers(0, n_crs, tas.shape[0])])

            # ---- literals ------------------------------------------------
            if literals:
                people = np.concatenate([faculty, ug, gr])
                for field, prop in ((1, "emailAddress"), (2, "name"), (3, "telephone")):
                    sink.add(people, pfp[prop], _lit(field, people))
                sink.add(faculty, pfp["researchInterest"], _lit(4, faculty))

    s, p, o = sink.arrays()
    term_strings = (
        _build_strings(onto, s, p, o, n_universities, univ_offset)
        if keep_strings else None)
    return RawDataset(
        s=s, p=p, o=o, onto=onto, term_strings=term_strings,
        meta=dict(kind="lubm", n_universities=n_universities, seed=seed,
                  univ_offset=univ_offset),
    )


def _build_strings(onto, s, p, o, n_univ, univ_offset: int = 0) -> dict:
    """fp -> string map (only for keep_strings scales)."""
    out = {}
    for c in onto.concepts:
        out[fingerprint_string(c)] = f"ub:{c}"
    for pr in onto.properties + [RDF_TYPE]:
        out[fingerprint_string(pr)] = f"ub:{pr}"
    # regenerate structural names by brute-force enumeration of the id space
    # actually observed in the dataset
    seen = set(np.concatenate([s, p, o]).tolist())
    for kind, label in _KIND_LABEL.items():
        for u in range(univ_offset, univ_offset + n_univ):
            for d in range(64):
                fps = _ent(kind, u, d, np.arange(4096))
                hit = [i for i, f in enumerate(fps.tolist()) if f in seen]
                for i in hit:
                    out[int(fps[i])] = (
                        f"http://www.Department{d}.University{u}.edu/{label}{i}"
                        if kind not in (K_UNIV,)
                        else f"http://www.University{u}.edu"
                    )
                if not hit and d > 0:
                    break
    # literals
    for field, prop in _LIT_FIELDS.items():
        owners = np.array([f for f in seen], dtype=np.int64)
        lits = _lit(field, owners)
        for owner, lf in zip(owners.tolist(), lits.tolist()):
            if lf in seen:
                out[lf] = f'"{prop}_of_{owner & 0xffff:x}"'
    return out


# ---------------------------------------------------------------------------
# Stress ontologies (DBPedia-like depth, Wikidata-like width)
# ---------------------------------------------------------------------------


def generate_deep_ontology(
    n_concepts: int = 800,
    n_properties: int = 60,
    max_children: int = 9,
    depth_bias: float = 0.6,
    n_subprop: int = 25,
    n_domain: int = 30,
    n_range: int = 28,
    seed: int = 0,
    max_depth: int | None = None,
) -> Ontology:
    """Random ontology with deep branches (DBPedia/Wikidata stand-in).

    ``depth_bias`` > 0.5 prefers attaching to recently created (deep)
    concepts, producing branches of depth > 6 like DBPedia's (the regime
    where the paper's full-materialization baseline blows up by 13–58%).
    """
    rng = np.random.default_rng(seed)
    concepts = [f"C{i}" for i in range(n_concepts)]
    child_count = np.zeros(n_concepts, dtype=np.int64)
    depth = np.zeros(n_concepts, dtype=np.int64)
    subclass = []
    for i in range(1, n_concepts):
        for _ in range(64):
            if rng.random() < depth_bias:
                lo = max(0, i - max(1, i // 4))
                parent = int(rng.integers(lo, i))
            else:
                parent = int(rng.integers(0, i))
            ok_depth = max_depth is None or depth[parent] + 1 < max_depth
            if child_count[parent] < max_children and ok_depth:
                break
        else:
            parent = 0
        child_count[parent] += 1
        depth[i] = depth[parent] + 1
        subclass.append((concepts[i], concepts[parent]))

    props = [f"p{i}" for i in range(n_properties)]
    subprop = []
    for i in range(1, min(n_subprop + 1, n_properties)):
        subprop.append((props[i], props[int(rng.integers(0, i))]))
    domain = {
        props[int(i)]: [concepts[int(rng.integers(0, n_concepts))]]
        for i in rng.permutation(n_properties)[:n_domain]
    }
    range_ = {
        props[int(i)]: [concepts[int(rng.integers(0, n_concepts))]]
        for i in rng.permutation(n_properties)[:n_range]
    }
    return Ontology(
        concepts=concepts, properties=props, subclass=subclass,
        subprop=subprop, domain=domain, range_=range_,
    )


def generate_random_abox(
    onto: Ontology,
    n_instances: int = 10_000,
    n_type_triples: int = 8_000,
    n_prop_triples: int = 30_000,
    seed: int = 0,
    instance_offset: int = 0,
) -> RawDataset:
    """Uniform random ABox over an arbitrary ontology (property tests).

    ``instance_offset`` shifts the instance fingerprint space (the random
    analogue of ``generate_lubm``'s ``univ_offset``): a dataset generated at
    a disjoint offset is a pure-growth delta over a base KB — every
    instance term is new, so update benchmarks/tests can pin O(delta)
    behavior without the delta aliasing base instances.
    """
    rng = np.random.default_rng(seed)
    cfps = np.array([fingerprint_string(c) for c in onto.concepts], dtype=np.int64)
    pfps = np.array([fingerprint_string(p) for p in onto.properties], dtype=np.int64)
    TYPE = fingerprint_string(RDF_TYPE)
    inst = mix64(np.int64(99), np.arange(n_instances) + instance_offset, 0, 0)

    sink = _TripleSink()
    sink.add(
        inst[rng.integers(0, n_instances, n_type_triples)],
        TYPE,
        cfps[rng.integers(0, len(cfps), n_type_triples)],
    )
    sink.add(
        inst[rng.integers(0, n_instances, n_prop_triples)],
        pfps[rng.integers(0, len(pfps), n_prop_triples)],
        inst[rng.integers(0, n_instances, n_prop_triples)],
    )
    s, p, o = sink.arrays()
    return RawDataset(s=s, p=p, o=o, onto=onto, meta=dict(kind="random", seed=seed))
