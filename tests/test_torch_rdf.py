"""Port parity, the N-Triples parser and writer (``rdf/parser.py``).

The same text goes through both packages' ``parse_ntriples``: the paper's
Example 1 with a blank node and a language-tagged literal, and the
writer's rendering of ``generate_lubm(1, seed=0, keep_strings=True)``
(136,826 lines).  The fingerprint columns, the ``term_strings`` map and
the split-out ``Ontology`` are equal; both writers render the same text; the writer
round trip keeps the triple set; the port's Example 1 answers on the CPU
equal the reference's in all three modes, compared as term strings (ids
are an implementation's own).  Everything compared is exact.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.engine import KnowledgeBase as JKnowledgeBase
from repro.core.query import Pattern as JPattern
from repro.rdf.generator import generate_lubm as j_generate_lubm
from repro.rdf.parser import parse_ntriples as j_parse
from repro.rdf.parser import write_ntriples as j_write
from repro_torch.core.engine import KnowledgeBase
from repro_torch.core.query import Pattern
from repro_torch.rdf.generator import generate_lubm
from repro_torch.rdf.parser import parse_ntriples, write_ntriples

# the paper's Example 1 (Professor <= FacultyMember, domain(teaches) =
# FacultyMember), with a subclass chain, a blank node and a literal
NT = """
# a tiny TBox + ABox in N-Triples
<http://ex/Professor> <http://www.w3.org/2000/01/rdf-schema#subClassOf> <http://ex/FacultyMember> .
<http://ex/FacultyMember> <http://www.w3.org/2000/01/rdf-schema#subClassOf> <http://ex/Person> .
<http://ex/teaches> <http://www.w3.org/2000/01/rdf-schema#domain> <http://ex/FacultyMember> .
<http://ex/advises> <http://www.w3.org/2000/01/rdf-schema#subPropertyOf> <http://ex/knows> .
<http://ex/advises> <http://www.w3.org/2000/01/rdf-schema#range> <http://ex/Person> .
<http://ex/bernd> <http://www.w3.org/1999/02/22-rdf-syntax-ns#type> <http://ex/Professor> .
<http://ex/hubert> <http://ex/teaches> <http://ex/course1> .
<http://ex/bernd> <http://ex/advises> <http://ex/anna> .
_:b1 <http://ex/name> "anonymous"@en .
<http://ex/course1> <http://ex/title> "Databases"^^<http://www.w3.org/2001/XMLSchema#string> .
"""


@pytest.fixture(scope="module")
def lubm_text():
    text = write_ntriples(generate_lubm(1, seed=0, keep_strings=True))
    assert text == j_write(j_generate_lubm(1, seed=0, keep_strings=True))
    return text


def _same_parse(text, extract_ontology=True):
    ds, onto = parse_ntriples(text, extract_ontology=extract_ontology)
    jds, jonto = j_parse(text, extract_ontology=extract_ontology)
    for col in ("s", "p", "o"):
        got, want = getattr(ds, col), getattr(jds, col)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert ds.term_strings == jds.term_strings
    assert ds.meta == jds.meta
    assert dataclasses.asdict(onto) == dataclasses.asdict(jonto)
    assert dataclasses.asdict(ds.onto) == dataclasses.asdict(jds.onto)
    return ds, onto


@pytest.mark.parametrize("extract_ontology", [True, False])
def test_parse_example_matches_reference(extract_ontology):
    ds, onto = _same_parse(NT, extract_ontology)
    if extract_ontology:
        assert ds.n_triples == 5
        assert onto.stats() == dict(n_concepts=3, n_properties=5,
                                    n_subclass=2, n_subprop=1, n_domain=1,
                                    n_range=1)
    else:
        assert ds.n_triples == 10


def test_parse_lubm_writer_output_matches_reference(lubm_text):
    ds, _ = _same_parse(lubm_text)
    assert ds.n_triples == 136_826
    # the writer emits no TBox axioms: every line is an ABox triple
    assert ds.n_triples == lubm_text.count("\n")


def test_writer_roundtrip(lubm_text):
    """parse -> write gives the text back; write -> parse keeps the
    triple set, in fingerprints and in term strings."""
    ds, _ = parse_ntriples(lubm_text)
    assert write_ntriples(ds) == lubm_text
    ex, _ = parse_ntriples(NT)
    ex2, _ = parse_ntriples(write_ntriples(ex))
    assert set(map(tuple, ex.triples().tolist())) == \
        set(map(tuple, ex2.triples().tolist()))
    for d in (ex, ex2):
        assert all(int(f) in d.term_strings for f in d.triples().ravel())


def test_unparsable_line_raises_as_reference():
    bad = NT + "<http://ex/a> <http://ex/b> .\n"
    with pytest.raises(ValueError) as want:
        j_parse(bad)
    with pytest.raises(ValueError) as got:
        parse_ntriples(bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no term strings"):
        write_ntriples(dataclasses.replace(parse_ntriples(NT)[0],
                                           term_strings=None))


def test_example_answers_match_reference():
    """bernd (explicit) and hubert (domain-derived) are FacultyMembers in
    every mode, in both packages; Person adds anna (range-derived)."""
    K = KnowledgeBase.build(parse_ntriples(NT)[0], device="cpu")
    J = JKnowledgeBase.build(j_parse(NT)[0])
    for cls in ("<http://ex/FacultyMember>", "<http://ex/Person>"):
        for mode in ("litemat", "full", "rewrite"):
            got = K.answers([Pattern("?x", "rdf:type", cls)], mode=mode)
            want = J.answers([JPattern("?x", "rdf:type", cls)], mode=mode)
            got = sorted(K.kb.extract([r[0] for r in got]))
            want = sorted(J.kb.extract([r[0] for r in want]))
            assert got == want, (cls, mode)
            if cls == "<http://ex/FacultyMember>":
                assert got == ["<http://ex/bernd>", "<http://ex/hubert>"]
            else:
                assert "<http://ex/anna>" in got
    assert K.sizes() == J.sizes()
