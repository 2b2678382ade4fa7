"""The plain reference: RDFS entailment over raw fingerprint columns.

Plain PyTorch (any device), worked out from the raw (s, p, o) fingerprint
columns and the frozen ontology alone; it imports nothing of the program and
takes nothing the program made.  It follows the rules the paper targets:
rdfs2/3 (domain, range, through every super-property), rdfs5/7
(subPropertyOf) and rdfs9/11 (subClassOf), over the ontology's own terms (no
``owl:Thing``).

* ``candidates``: every (instance, concept) that a triple states or
  implies: explicit types, the effective domains of a triple's predicate
  for its subject, and the effective ranges for its object.
* ``members`` / ``join_subjects``: the facet answers, as sets of
  fingerprints (set semantics).
* ``lite_store``: the raw non-type triples as they are (a multiset) plus one
  type triple for each most specific concept of an instance, by an explicit
  expansion of every candidate's strict superclasses (no interval codes).
* ``full_store``: the deduplicated closure under all the rules.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from litemat_bench.frozen import ontology as onto
from litemat_bench.frozen.generator import fingerprint_string


def _closure(names, edges):
    """name -> list of its ancestors, itself included (transitive)."""
    up = {n: [] for n in names}
    for sub, sup in edges:
        up[sub].append(sup)
    out = {}
    for n in names:
        seen, stack = {n}, [n]
        while stack:
            for s in up[stack.pop()]:
                if s not in seen:
                    seen.add(s)
                    stack.append(s)
        out[n] = sorted(seen)
    return out


@dataclass
class Vocabulary:
    """The frozen ontology as index tables on one device."""

    device: torch.device
    concepts: list
    properties: list  # the ontology's properties, then rdf:type
    concept_fp: torch.Tensor  # int64[C], by concept index
    property_fp: torch.Tensor  # int64[P]
    type_fp: int
    concept_up: dict  # concept index -> ancestor indices (self included)
    property_up: dict  # property index -> ancestor indices (self included)
    eff_domain: dict  # property index -> concept indices
    eff_range: dict

    @classmethod
    def build(cls, device) -> "Vocabulary":
        device = torch.device(device)
        concepts = list(onto.CONCEPTS)
        props = list(onto.PROPERTIES) + [onto.RDF_TYPE]
        ci = {c: i for i, c in enumerate(concepts)}
        pi = {p: i for i, p in enumerate(props)}
        cup = _closure(concepts, onto.SUBCLASS)
        pup = _closure(props, onto.SUBPROP)
        dom, rng = {}, {}
        for p in props:
            d = {c for q in pup[p] for c in onto.DOMAIN.get(q, [])}
            r = {c for q in pup[p] for c in onto.RANGE.get(q, [])}
            if d:
                dom[pi[p]] = sorted(ci[c] for c in d)
            if r:
                rng[pi[p]] = sorted(ci[c] for c in r)
        return cls(
            device=device, concepts=concepts, properties=props,
            concept_fp=torch.tensor([fingerprint_string(c) for c in concepts],
                                    dtype=torch.int64, device=device),
            property_fp=torch.tensor([fingerprint_string(p) for p in props],
                                     dtype=torch.int64, device=device),
            type_fp=fingerprint_string(onto.RDF_TYPE),
            concept_up={ci[c]: [ci[a] for a in cup[c]] for c in concepts},
            property_up={pi[p]: [pi[a] for a in pup[p]] for p in props},
            eff_domain=dom, eff_range=rng)

    def concept_index(self, name: str) -> int:
        return self.concepts.index(name)

    def property_index(self, name: str) -> int:
        return self.properties.index(name)

    def below_concept(self, c: int) -> list:
        """Concept indices d with c among d's ancestors (c included)."""
        return [d for d, up in self.concept_up.items() if c in up]

    def below_property(self, p: int) -> list:
        return [q for q, up in self.property_up.items() if p in up]


def _lookup(fps: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Index of each value in the (unsorted, distinct) ``fps``; raises when
    a value is not there."""
    order = torch.argsort(fps)
    srt = fps[order]
    pos = torch.searchsorted(srt, values).clamp(max=srt.shape[0] - 1)
    if not bool((srt[pos] == values).all()):
        raise ValueError("a term outside the ontology")
    return order[pos]


@dataclass
class Entailment:
    """Reference state over one raw dataset."""

    voc: Vocabulary
    s: torch.Tensor
    p: torch.Tensor
    o: torch.Tensor
    pidx: torch.Tensor  # property index of each row
    inst: torch.Tensor  # candidate instances (fingerprints)
    conc: torch.Tensor  # candidate concepts (indices)

    @classmethod
    def build(cls, s, p, o, device) -> "Entailment":
        voc = Vocabulary.build(device)
        s, p, o = (torch.as_tensor(c, device=voc.device) for c in (s, p, o))
        pidx = _lookup(voc.property_fp, p)
        tidx = voc.property_index(onto.RDF_TYPE)
        is_type = pidx == tidx
        insts = [s[is_type]]
        concs = [_lookup(voc.concept_fp, o[is_type])]
        for j in range(len(voc.properties)):
            if j == tidx or (j not in voc.eff_domain and j not in voc.eff_range):
                continue
            rows = pidx == j
            for c in voc.eff_domain.get(j, []):
                insts.append(s[rows])
                concs.append(torch.full_like(insts[-1], c))
            for c in voc.eff_range.get(j, []):
                insts.append(o[rows])
                concs.append(torch.full_like(insts[-1], c))
        return cls(voc=voc, s=s, p=p, o=o, pidx=pidx,
                   inst=torch.cat(insts), conc=torch.cat(concs))

    # -- facets -------------------------------------------------------------
    def members(self, concept: str) -> torch.Tensor:
        """Sorted distinct fingerprints of every instance of ``concept``."""
        below = torch.tensor(self.voc.below_concept(
            self.voc.concept_index(concept)), device=self.voc.device)
        return torch.unique(self.inst[torch.isin(self.conc, below)])

    def join_subjects(self, prop: str) -> torch.Tensor:
        """Sorted distinct subjects of a triple whose predicate is ``prop``
        or one of its sub-properties."""
        below = torch.tensor(self.voc.below_property(
            self.voc.property_index(prop)), device=self.voc.device)
        return torch.unique(self.s[torch.isin(self.pidx, below)])

    # -- stores -------------------------------------------------------------
    def _unique_candidates(self):
        """Distinct (instance, concept) candidates as (fingerprint, index)."""
        nc = len(self.voc.concepts)
        xs, xi = torch.unique(self.inst, return_inverse=True)
        key = torch.unique(xi * nc + self.conc)
        return xs, key // nc, key % nc, nc

    def most_specific(self):
        """(instance fingerprints, concept indices) of the candidates that no
        other candidate of the same instance lies strictly below."""
        xs, xi, c, nc = self._unique_candidates()
        dominated = []
        for d, ups in self.voc.concept_up.items():
            rows = xi[c == d]
            for a in ups:
                if a != d:
                    dominated.append(rows * nc + a)
        key = xi * nc + c
        keep = ~torch.isin(key, torch.cat(dominated)) if dominated else \
            torch.ones_like(key, dtype=torch.bool)
        return xs[xi[keep]], c[keep]

    def lite_store(self) -> torch.Tensor:
        """int64[N, 3] fingerprint rows: the raw non-type rows (duplicates
        kept) and one type row per most specific concept."""
        nt = self.pidx != self.voc.property_index(onto.RDF_TYPE)
        x, c = self.most_specific()
        ty = torch.stack([x, torch.full_like(x, self.voc.type_fp),
                          self.voc.concept_fp[c]], 1)
        return torch.cat([torch.stack([self.s[nt], self.p[nt], self.o[nt]],
                                      1), ty])

    def full_store(self, distinct: bool = True) -> torch.Tensor:
        """int64[M, 3]: every entailed triple, each once (``distinct=False``
        keeps every derivation: the control of a later dedup shortcut)."""
        tidx = self.voc.property_index(onto.RDF_TYPE)
        parts = [torch.stack([self.s, self.p, self.o], 1)]
        for q, ups in self.voc.property_up.items():
            if q == tidx:
                continue
            rows = self.pidx == q
            for a in ups:
                if a != q:
                    parts.append(torch.stack([
                        self.s[rows],
                        torch.full_like(self.s[rows],
                                        int(self.voc.property_fp[a])),
                        self.o[rows]], 1))
        for c, ups in self.voc.concept_up.items():
            x = self.inst[self.conc == c]
            for a in ups:
                parts.append(torch.stack([
                    x, torch.full_like(x, self.voc.type_fp),
                    torch.full_like(x, int(self.voc.concept_fp[a]))], 1))
        rows = torch.cat(parts)
        if not distinct:
            return rows
        rows = rows[lexsort_rows(rows)]
        return rows[_first_of_runs(rows)]


def lexsort_rows(x: torch.Tensor) -> torch.Tensor:
    """Permutation that orders the rows of ``x`` lexicographically."""
    order = torch.arange(x.shape[0], device=x.device)
    for col in reversed(range(x.shape[1])):
        order = order[torch.sort(x[order, col], stable=True).indices]
    return order


def _first_of_runs(xs: torch.Tensor) -> torch.Tensor:
    """Mask of the rows of a sorted ``xs`` that differ from the row before."""
    new = torch.ones(xs.shape[0], dtype=torch.bool, device=xs.device)
    new[1:] = (xs[1:] != xs[:-1]).any(1)
    return new


def multiset_difference(a: torch.Tensor, b: torch.Tensor) -> int:
    """Rows in ``a`` or ``b`` beyond what the other holds, counting each
    row with its multiplicity (0 iff the two are equal as multisets)."""
    x = torch.cat([a, b])
    if x.shape[0] == 0:
        return 0
    tag = torch.cat([torch.ones(a.shape[0], dtype=torch.int64,
                                device=x.device),
                     -torch.ones(b.shape[0], dtype=torch.int64,
                                 device=x.device)])
    order = lexsort_rows(x)
    xs, ts = x[order], tag[order]
    group = torch.cumsum(_first_of_runs(xs).to(torch.int64), 0) - 1
    sums = torch.zeros(int(group[-1]) + 1, dtype=torch.int64,
                       device=x.device).index_add_(0, group, ts)
    return int(sums.abs().sum())
