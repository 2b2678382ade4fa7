"""The LUBM-like ABox generator, frozen for the benchmark.

A copy of the program's ``rdf/generator.py::generate_lubm`` (literals on,
no term strings) with the hashing it needs from ``utils/hashing.py``, so
that a change to the program cannot move the benchmark's input.  Terms are
structural 61-bit fingerprints (``mix64`` of small integer tuples); class and
property terms are ``fingerprint_string`` of their names.  About 108-116 K
triples a university.
"""
from __future__ import annotations

import hashlib

import numpy as np

from litemat_bench.frozen import ontology as onto

_MASK61 = (1 << 61) - 1
_MASK64 = (1 << 64) - 1

(K_UNIV, K_DEPT, K_RG, K_FP, K_AP, K_ASP, K_LECT, K_UG, K_GR, K_CRS, K_GCRS,
 K_PUB, K_RES) = range(1, 14)
K_LIT = 20

FACULTY_CONCEPT = {
    K_FP: "FullProfessor",
    K_AP: "AssociateProfessor",
    K_ASP: "AssistantProfessor",
    K_LECT: "Lecturer",
}


def _splitmix64(x):
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(_MASK64)
        z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(_MASK64)
        z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(_MASK64)
        return z ^ (z >> np.uint64(31))


def mix64(*parts) -> np.ndarray:
    """Structural fingerprint of small-int tuples -> int64 in [0, 2**61)."""
    acc = np.uint64(0x243F6A8885A308D3)
    for p in parts:
        p64 = np.asarray(p, dtype=np.uint64)
        with np.errstate(over="ignore"):
            acc = _splitmix64(acc ^ _splitmix64(p64))
    return (acc & np.uint64(_MASK61)).astype(np.int64)


def fingerprint_string(term: str) -> int:
    """Fingerprint of a term's name (classes, properties, rdf:type)."""
    h = hashlib.blake2b(term.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(h, "little") & _MASK61


class _Sink:
    def __init__(self):
        self.s, self.p, self.o = [], [], []

    def add(self, s, p, o):
        s, p, o = np.broadcast_arrays(np.asarray(s, dtype=np.int64),
                                      np.asarray(p, dtype=np.int64),
                                      np.asarray(o, dtype=np.int64))
        self.s.append(s.ravel())
        self.p.append(p.ravel())
        self.o.append(o.ravel())

    def arrays(self):
        return tuple(np.concatenate(c) if c else np.zeros(0, np.int64)
                     for c in (self.s, self.p, self.o))


def _ent(kind, u, d, i):
    return mix64(np.int64(kind), np.int64(u), np.int64(d), np.int64(i))


def _lit(field, owner_fp):
    return mix64(np.int64(K_LIT), np.int64(field),
                 np.asarray(owner_fp, dtype=np.int64))


def generate_lubm(n_universities: int, seed: int = 0):
    """LUBM(n_universities, seed) as int64 fingerprint columns (s, p, o)."""
    rng = np.random.default_rng(seed)
    sink = _Sink()
    cfp = {c: fingerprint_string(c) for c in onto.CONCEPTS}
    pfp = {p: fingerprint_string(p) for p in onto.PROPERTIES + [onto.RDF_TYPE]}
    TYPE = pfp[onto.RDF_TYPE]

    univs = _ent(K_UNIV, np.arange(n_universities), 0, 0)
    sink.add(univs, TYPE, cfp["University"])

    for u in range(n_universities):
        n_dept = int(rng.integers(15, 26))
        for d in range(n_dept):
            dept = _ent(K_DEPT, u, d, 0)
            sink.add(dept, TYPE, cfp["Department"])
            sink.add(dept, pfp["subOrganizationOf"], univs[u])

            n_rg = int(rng.integers(10, 21))
            rgs = _ent(K_RG, u, d, np.arange(n_rg))
            sink.add(rgs, TYPE, cfp["ResearchGroup"])
            sink.add(rgs, pfp["subOrganizationOf"], dept)
            res = _ent(K_RES, u, d, np.arange(n_rg))
            sink.add(res, TYPE, cfp["Research"])
            sink.add(rgs, pfp["researchProject"], res)

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
            sink.add(faculty[:1], pfp["headOf"], dept)
            for prop in ("undergraduateDegreeFrom", "mastersDegreeFrom",
                         "doctoralDegreeFrom"):
                sink.add(faculty, pfp[prop],
                         univs[rng.integers(0, n_universities, nf)])

            n_crs = nf * 2
            n_gcrs = max(nf, 1)
            courses = _ent(K_CRS, u, d, np.arange(n_crs))
            gcourses = _ent(K_GCRS, u, d, np.arange(n_gcrs))
            sink.add(courses, TYPE, cfp["Course"])
            sink.add(gcourses, TYPE, cfp["GraduateCourse"])
            sink.add(faculty, pfp["teacherOf"],
                     courses[rng.permutation(n_crs)[:nf]])
            sink.add(faculty, pfp["teacherOf"],
                     gcourses[rng.integers(0, n_gcrs, nf)])

            pubs_per = rng.integers(5, 16, nf)
            n_pub = int(pubs_per.sum())
            pubs = _ent(K_PUB, u, d, np.arange(n_pub))
            pub_cls = rng.choice(
                [cfp["JournalArticle"], cfp["ConferencePaper"],
                 cfp["TechnicalReport"], cfp["Book"]], size=n_pub)
            sink.add(pubs, TYPE, pub_cls)
            sink.add(pubs, pfp["publicationAuthor"],
                     np.repeat(faculty, pubs_per))

            n_ug = nf * int(rng.integers(8, 15))
            n_gr = nf * int(rng.integers(3, 5))
            ug = _ent(K_UG, u, d, np.arange(n_ug))
            gr = _ent(K_GR, u, d, np.arange(n_gr))
            sink.add(ug, TYPE, cfp["UndergraduateStudent"])
            sink.add(gr, TYPE, cfp["GraduateStudent"])
            sink.add(ug, pfp["memberOf"], dept)
            sink.add(gr, pfp["memberOf"], dept)
            for _ in range(3):
                sink.add(ug, pfp["takesCourse"],
                         courses[rng.integers(0, n_crs, n_ug)])
            for _ in range(2):
                sink.add(gr, pfp["takesCourse"],
                         gcourses[rng.integers(0, n_gcrs, n_gr)])
            sink.add(gr, pfp["advisor"],
                     professors[rng.integers(0, professors.shape[0], n_gr)])
            ug_adv = ug[rng.random(n_ug) < 0.2]
            sink.add(ug_adv, pfp["advisor"],
                     professors[rng.integers(0, professors.shape[0],
                                             ug_adv.shape[0])])
            sink.add(gr, pfp["undergraduateDegreeFrom"],
                     univs[rng.integers(0, n_universities, n_gr)])
            tas = gr[rng.random(n_gr) < 0.2]
            sink.add(tas, pfp["teachingAssistantOf"],
                     courses[rng.integers(0, n_crs, tas.shape[0])])

            people = np.concatenate([faculty, ug, gr])
            for field, prop in ((1, "emailAddress"), (2, "name"),
                                (3, "telephone")):
                sink.add(people, pfp[prop], _lit(field, people))
            sink.add(faculty, pfp["researchInterest"], _lit(4, faculty))

    return sink.arrays()
