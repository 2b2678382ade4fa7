"""Quickstart on the PyTorch port: the LiteMat pipeline on the paper's Example 1.

    PYTHONPATH=src python examples/quickstart_torch.py               # CUDA
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Parses N-Triples, encodes the TBox into intervals, materializes, and
answers ``?x rdf:type FacultyMember`` in the three modes.  The port runs
on the GPU unless ``--device`` names another torch device.
"""
import argparse

from repro_torch.core.engine import KnowledgeBase
from repro_torch.core.query import Pattern
from repro_torch.rdf.parser import parse_ntriples

# The paper's Example 1: Professor <= FacultyMember, domain(teaches) =
# FacultyMember; bernd is an explicit Professor, hubert only teaches.
NT = """
<http://ex/Professor> <http://www.w3.org/2000/01/rdf-schema#subClassOf> <http://ex/FacultyMember> .
<http://ex/teaches> <http://www.w3.org/2000/01/rdf-schema#domain> <http://ex/FacultyMember> .
<http://ex/bernd> <http://www.w3.org/1999/02/22-rdf-syntax-ns#type> <http://ex/Professor> .
<http://ex/hubert> <http://ex/teaches> <http://ex/course1> .
"""

MODES = ("litemat", "full", "rewrite")
QUERY = [Pattern("?x", "rdf:type", "<http://ex/FacultyMember>")]


def run(device=None, verbose: bool = True) -> dict:
    """Example 1 end to end on ``device`` (None: CUDA); returns each
    mode's answers as sorted term strings."""
    ds, onto = parse_ntriples(NT)
    K = KnowledgeBase.build(ds, device=device)
    out = {}
    for mode in MODES:
        rows = sorted(K.answers(QUERY, mode=mode))
        out[mode] = sorted(K.kb.extract([r[0] for r in rows]))
    if verbose:
        print(f"parsed {ds.n_triples} ABox triples; ontology: {onto.stats()}")
        print(f"device: {K.device}; store sizes: {K.sizes()}")
        print("concept encoding:")
        enc = K.kb.tbox.concepts
        for name in enc.tax.names:
            if name.startswith("__"):
                continue
            (lo, hi), _ = enc.interval_of(name)
            print(f"  {name:<28} id={lo:>4} interval=[{lo}, {hi})")
        # 'SELECT ?x WHERE { ?x rdf:type FacultyMember }' — the naive store
        # has NO FacultyMember triples; LiteMat answers via ONE interval
        # compare.
        for mode in MODES:
            print(f"{mode:>8}: {out[mode]}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args()
    out = run(args.device)
    for mode in MODES:
        if len(out[mode]) != 2:
            raise SystemExit(f"{mode}: {out[mode]}, expected bernd + hubert")
    print("OK — both bernd and hubert are FacultyMembers under RDFS entailment")


if __name__ == "__main__":
    main()
