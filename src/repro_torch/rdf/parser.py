"""Minimal N-Triples reader/writer (host-side string world).

Covers the N-Triples subset needed to ingest real dumps: IRIs, blank nodes,
plain/typed/lang-tagged literals, comments.  Ontology axioms
(rdfs:subClassOf / subPropertyOf / domain / range) found in the stream are
split out into an ``Ontology`` — the TBox/ABox separation the paper performs
before encoding.
"""
from __future__ import annotations

import re

import numpy as np

from repro_torch.core.tbox import RDF_TYPE, Ontology
from repro_torch.rdf.generator import RawDataset
from repro_torch.utils.hashing import fingerprint_string

RDF_TYPE_IRI = "http://www.w3.org/1999/02/22-rdf-syntax-ns#type"
RDFS = "http://www.w3.org/2000/01/rdf-schema#"
SUBCLASS_IRI = RDFS + "subClassOf"
SUBPROP_IRI = RDFS + "subPropertyOf"
DOMAIN_IRI = RDFS + "domain"
RANGE_IRI = RDFS + "range"

_TERM = re.compile(
    r"""\s*(?:
        <(?P<iri>[^>]*)> |
        (?P<bnode>_:[A-Za-z0-9]+) |
        (?P<lit>"(?:[^"\\]|\\.)*"(?:\^\^<[^>]*>|@[A-Za-z0-9\-]+)?)
    )""",
    re.X,
)


def _parse_line(line: str):
    terms = []
    pos = 0
    for _ in range(3):
        m = _TERM.match(line, pos)
        if not m:
            return None
        terms.append(m.group("iri") or m.group("bnode") or m.group("lit"))
        if m.group("iri") is not None:
            terms[-1] = "<" + terms[-1] + ">"
        pos = m.end()
    if line[pos:].strip() != ".":
        return None
    return tuple(terms)


def parse_ntriples(text: str, extract_ontology: bool = True):
    """Parse N-Triples text -> (RawDataset, Ontology).

    Schema triples (subClassOf/subPropertyOf/domain/range) go to the
    Ontology; everything else becomes fingerprinted ABox columns.
    """
    subclass, subprop = [], []
    domain, range_ = {}, {}
    concepts, properties = set(), set()
    s_col, p_col, o_col = [], [], []
    strings: dict = {}

    def fp(term: str) -> int:
        f = fingerprint_string(term)
        strings[f] = term
        return f

    # rdf:type is normalized to its canonical alias so the TBox term map
    # (which registers "rdf:type") always resolves it
    type_fp = fp(RDF_TYPE)
    strings[fingerprint_string("<" + RDF_TYPE_IRI + ">")] = RDF_TYPE

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parsed = _parse_line(line)
        if parsed is None:
            raise ValueError(f"unparsable N-Triples line: {raw!r}")
        s, p, o = parsed
        bare_p = p.strip("<>")
        if extract_ontology and bare_p in (SUBCLASS_IRI, SUBPROP_IRI, DOMAIN_IRI, RANGE_IRI):
            if bare_p == SUBCLASS_IRI:
                subclass.append((s, o))
                concepts.update((s, o))
            elif bare_p == SUBPROP_IRI:
                subprop.append((s, o))
                properties.update((s, o))
            elif bare_p == DOMAIN_IRI:
                domain.setdefault(s, []).append(o)
                properties.add(s)
                concepts.add(o)
            else:
                range_.setdefault(s, []).append(o)
                properties.add(s)
                concepts.add(o)
            continue
        pf = type_fp if bare_p == RDF_TYPE_IRI else fp(p)
        s_col.append(fp(s))
        p_col.append(pf)
        o_col.append(fp(o))
        if bare_p == RDF_TYPE_IRI:
            concepts.add(o)
        else:
            properties.add(p)

    onto = Ontology(
        concepts=sorted(concepts),
        properties=sorted(properties),
        subclass=subclass,
        subprop=subprop,
        domain=domain,
        range_=range_,
    )
    ds = RawDataset(
        s=np.array(s_col, dtype=np.int64),
        p=np.array(p_col, dtype=np.int64),
        o=np.array(o_col, dtype=np.int64),
        onto=onto,
        term_strings=strings,
        meta=dict(kind="ntriples"),
    )
    return ds, onto


def write_ntriples(ds: RawDataset) -> str:
    """RawDataset (with term_strings) -> N-Triples text."""
    if ds.term_strings is None:
        raise ValueError("dataset has no term strings to render")
    ts = ds.term_strings
    type_fp = fingerprint_string(RDF_TYPE)

    def render(f: int) -> str:
        if int(f) == type_fp:
            return "<" + RDF_TYPE_IRI + ">"
        t = ts.get(int(f), f"<urn:fp:{int(f):x}>")
        if t.startswith(("<", '"', "_:")):
            return t
        return f"<urn:repro:{t}>"

    lines = []
    for s, p, o in zip(ds.s.tolist(), ds.p.tolist(), ds.o.tolist()):
        lines.append(f"{render(s)} {render(p)} {render(o)} .")
    return "\n".join(lines) + "\n"
