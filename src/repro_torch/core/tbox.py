"""TBox encoding — the paper's §III.A, plus a parallel (torch) encoder.

Given a classified Taxonomy (hierarchy.py), assign each entity a prefix-
coded integer id:

  * a node with N primary children reserves ``ceil(log2(N+1))`` bits for its
    child slots (local code 0 = the node itself, children get 1..N),
  * ids are left-aligned in ``total_bits`` and zero-padded on the right,
  * descendants of A therefore occupy exactly ``[idA, idA + 2**(total_bits -
    used_bits(A)))`` — the paper's ``bound`` function.

Two encoders produce bit-identical results:

  * ``encode_hierarchy``          — host numpy / Python bigints (reference;
                                     also the only path for >62-bit codes).
  * ``encode_hierarchy_parallel`` — level-synchronous torch implementation
                                     (segment ranks + prefix reductions) that
                                     removes the paper's single-machine TBox
                                     bottleneck (their Wikidata case: 122 s).

Multiple inheritance: the tree encoder covers primary edges; every secondary
edge contributes *spill intervals* (extra [lo, hi) ranges per concept) so
that ``subsumes(a, b)`` remains complete on DAGs (DESIGN.md §2.2).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.hierarchy import ROOT, Taxonomy, build_taxonomy
from repro_torch.core.intervals import pack_wide, words_needed

MAX_NARROW_BITS = 62  # beyond this we only keep bigint + wide-word forms


# ---------------------------------------------------------------------------
# Ontology (host axiom container — what the .owl file boils down to)
# ---------------------------------------------------------------------------


@dataclass
class Ontology:
    """RDFS-level ontology: hierarchies + property domain/range axioms."""

    concepts: list
    properties: list
    subclass: list = field(default_factory=list)  # (sub, sup) names
    subprop: list = field(default_factory=list)  # (sub, sup) names
    domain: dict = field(default_factory=dict)  # prop -> set/list of concepts
    range_: dict = field(default_factory=dict)  # prop -> set/list of concepts

    def stats(self):
        return dict(
            n_concepts=len(self.concepts),
            n_properties=len(self.properties),
            n_subclass=len(self.subclass),
            n_subprop=len(self.subprop),
            n_domain=sum(len(v) for v in self.domain.values()),
            n_range=sum(len(v) for v in self.range_.values()),
        )


# ---------------------------------------------------------------------------
# Encoded hierarchy
# ---------------------------------------------------------------------------


@dataclass
class EncodedHierarchy:
    """One encoded entity hierarchy (concepts or properties)."""

    tax: Taxonomy
    total_bits: int
    ids: np.ndarray  # int64[C] in node order (valid iff total_bits <= 62)
    used_bits: np.ndarray  # int32[C] in node order
    bounds: np.ndarray  # int64[C] in node order
    # device-friendly, sorted-by-id views -----------------------------------
    sorted_ids: np.ndarray
    sorted_bounds: np.ndarray
    sorted_used: np.ndarray
    sorted_ancestors: np.ndarray  # int64[C, D] DAG-ancestor ids, -1 padded
    sorted_spill_lo: np.ndarray  # int64[C, S] secondary-edge intervals
    sorted_spill_hi: np.ndarray
    # wide form (always present; required when total_bits > 62) -------------
    ids_big: list  # Python bigints, node order (exact for any width)
    wide_words: int
    ids_wide: np.ndarray  # int32[C, W]
    bounds_wide: np.ndarray  # int32[C, W]
    spill_big: dict  # node -> [(lo, hi) bigints] secondary-edge intervals

    def __post_init__(self):
        self.narrow = self.total_bits <= MAX_NARROW_BITS
        self.name_to_id = {n: self.ids_big[i] for i, n in enumerate(self.tax.names)}
        self._id_to_node = {v: i for i, v in enumerate(self.ids_big)}

    # -- host conveniences ---------------------------------------------------
    @property
    def n(self) -> int:
        return self.tax.n

    def id_of(self, name: str) -> int:
        return self.name_to_id[self.tax.merged.get(name, name)]

    def name_of(self, ident: int) -> str:
        return self.tax.names[self._id_to_node[int(ident)]]

    def interval_of(self, name: str):
        """Primary [lo, hi) + spill intervals — everything name subsumes."""
        node = self.tax.idx_of(name)
        lo = self.ids_big[node]
        hi = lo + (1 << (self.total_bits - int(self.used_bits[node])))
        spills = [(a, b) for a, b in self.spill_big.get(node, []) if a < b]
        return (lo, hi), spills

    def subsumees(self, name: str):
        """All entity ids subsumed by ``name`` (incl. itself) — host oracle."""
        (lo, hi), spills = self.interval_of(name)
        out = []
        for v in self.ids_big:
            if lo <= v < hi or any(a <= v < b for a, b in spills):
                out.append(v)
        return sorted(set(out))

    def max_spills(self) -> int:
        return int(self.sorted_spill_lo.shape[1])


def _child_lists(tax: Taxonomy):
    ch = [[] for _ in range(tax.n)]
    for i, p in enumerate(tax.parent.tolist()):
        if p >= 0:
            ch[p].append(i)
    return ch


def _bit_length(n: int) -> int:
    return int(n).bit_length()


def encode_hierarchy(tax: Taxonomy) -> EncodedHierarchy:
    """Reference (host) encoder: two passes, exactly the paper's algorithm."""
    n = tax.n
    children = _child_lists(tax)
    width = np.array([_bit_length(len(c)) for c in children], dtype=np.int32)

    # pass 1: used_bits top-down
    used = np.zeros(n, dtype=np.int32)
    order = np.argsort(tax.depth, kind="stable")  # parents before children
    for v in order.tolist():
        p = int(tax.parent[v])
        if p >= 0:
            used[v] = used[p] + width[p]
    total = max(1, int(used.max()))

    # pass 2: ids top-down (bigints so >62-bit codes are exact)
    rank_of = {}
    for p, ch in enumerate(children):
        for k, v in enumerate(ch):
            rank_of[v] = k + 1  # local code, 1-based
    ids_big = [0] * n
    for v in order.tolist():
        p = int(tax.parent[v])
        if p < 0:
            continue
        ids_big[v] = ids_big[p] | (rank_of[v] << (total - int(used[v])))

    bounds_big = [ids_big[i] + (1 << (total - int(used[i]))) for i in range(n)]
    return _finalize(tax, total, used, ids_big, bounds_big)


def encode_hierarchy_parallel(tax: Taxonomy) -> EncodedHierarchy:
    """Level-synchronous parallel encoder (tensor ops; beyond-paper).

    Identical output to ``encode_hierarchy``.  Each level is O(nodes at
    level) of segment-rank + gather work — no sequential DFS.  Restricted to
    total_bits <= 31 (int32 ids); wider hierarchies use the host path.
    """
    n = tax.n
    parent = torch.as_tensor(tax.parent, dtype=torch.int64)
    is_child = parent >= 0
    par0 = parent.clamp(min=0)

    # children counts per node -> per-node slot width
    counts = torch.zeros(n, dtype=torch.int64).index_add_(
        0, par0, is_child.to(torch.int64))
    # width = bit_length(count) = #{k : 2^k <= count} — exact integer form
    powers = torch.ones(31, dtype=torch.int64) << torch.arange(
        31)
    width = (counts[:, None] >= powers[None, :]).sum(1)

    # local rank of each child within its parent (1-based), by node index —
    # matches the host encoder's sorted-children order; roots sort last
    parent_key = torch.where(is_child, parent, torch.full_like(parent, n))
    perm = torch.sort(parent_key * n + torch.arange(n)).indices
    sorted_parent = parent_key[perm]
    first_pos = torch.searchsorted(sorted_parent, sorted_parent)
    rank_sorted = torch.arange(n) - first_pos + 1
    rank = torch.zeros(n, dtype=torch.int64)
    rank[perm] = rank_sorted

    # level loop: used_bits then ids (gather from parents, already final)
    max_depth = int(tax.depth.max()) if n > 1 else 0
    used = torch.zeros(n, dtype=torch.int64)
    for _ in range(max_depth):
        cand = torch.where(is_child, used[par0] + width[par0],
                           torch.zeros_like(used))
        used = torch.where(is_child, cand, used)  # level l final after l iters
    total = max(1, int(used.max()))
    if total > 31:
        raise ValueError(f"parallel encoder limited to 31 bits, need {total}; use encode_hierarchy")

    ids = torch.zeros(n, dtype=torch.int64)
    for _ in range(max_depth):
        cand = ids[par0] | (rank << (total - used))
        ids = torch.where(is_child, cand, ids)

    used_np = used.cpu().numpy().astype(np.int32)
    ids_big = [int(v) for v in ids.cpu().tolist()]
    bounds_big = [ids_big[i] + (1 << (total - int(used_np[i]))) for i in range(n)]
    return _finalize(tax, total, used_np, ids_big, bounds_big)


def _finalize(tax: Taxonomy, total: int, used: np.ndarray, ids_big: list, bounds_big: list):
    n = tax.n
    narrow = total <= MAX_NARROW_BITS
    ids = np.array(ids_big, dtype=np.int64) if narrow else np.zeros(n, dtype=np.int64)
    bounds = np.array(bounds_big, dtype=np.int64) if narrow else np.zeros(n, dtype=np.int64)

    # wide packed form (always computed; exercised by tests + >62-bit path)
    W = words_needed(total)
    ids_wide = np.stack([pack_wide(v, W) for v in ids_big])
    bounds_wide = np.stack([pack_wide(v, W) for v in bounds_big])

    order = (
        np.argsort(ids, kind="stable")
        if narrow
        else np.array(sorted(range(n), key=lambda i: ids_big[i]), dtype=np.int64)
    )
    sorted_ids = ids[order]
    sorted_bounds = bounds[order]
    sorted_used = used[order]

    # DAG-ancestor table (ids, -1 padded), in sorted-by-id row order --------
    tmp_tax = tax
    anc_sets = [sorted(tmp_tax.dag_ancestors(i)) for i in range(n)]
    D = max(1, max(len(a) for a in anc_sets))
    anc_tbl = np.full((n, D), -1, dtype=np.int64)
    for i, a in enumerate(anc_sets):
        for j, node in enumerate(a):
            anc_tbl[i, j] = ids[node] if narrow else -1
    sorted_ancestors = anc_tbl[order]

    # spill intervals from secondary edges ----------------------------------
    spill: dict = {i: [] for i in range(n)}
    for child, sec_parent in tax.secondary:
        lo_c, hi_c = int(ids_big[child]), int(bounds_big[child])
        # child's subtree must also count as descendants of sec_parent and
        # of every DAG ancestor of sec_parent whose interval misses it.
        targets = {sec_parent} | tax.dag_ancestors(sec_parent)
        for t in targets:
            lo_t, hi_t = int(ids_big[t]), int(bounds_big[t])
            if not (lo_t <= lo_c and hi_c <= hi_t):
                ivs = spill[t]
                if not any(a <= lo_c and hi_c <= b for a, b in ivs):
                    ivs.append((lo_c, hi_c))
    S = max(1, max((len(v) for v in spill.values()), default=0))
    spill_lo = np.zeros((n, S), dtype=np.int64)
    spill_hi = np.zeros((n, S), dtype=np.int64)
    if narrow:  # int64 tables only exist on the narrow path
        for i, ivs in spill.items():
            for j, (a, b) in enumerate(sorted(ivs)):
                spill_lo[i, j] = a
                spill_hi[i, j] = b

    return EncodedHierarchy(
        tax=tax,
        total_bits=total,
        ids=ids,
        used_bits=used,
        bounds=bounds,
        sorted_ids=sorted_ids,
        sorted_bounds=sorted_bounds,
        sorted_used=sorted_used,
        sorted_ancestors=sorted_ancestors,
        sorted_spill_lo=spill_lo[order],
        sorted_spill_hi=spill_hi[order],
        ids_big=ids_big,
        wide_words=W,
        ids_wide=ids_wide,
        bounds_wide=bounds_wide,
        spill_big={i: sorted(v) for i, v in spill.items() if v},
    )


# ---------------------------------------------------------------------------
# Full TBox = concept hierarchy + property hierarchy + domain/range tables
# ---------------------------------------------------------------------------

RDF_TYPE = "rdf:type"
PROP_ROOT = "__prop_root__"


@dataclass
class TBox:
    concepts: EncodedHierarchy
    properties: EncodedHierarchy
    rdf_type_id: int
    # domain/range: sorted by property id, padded with -1
    dr_prop_ids: np.ndarray  # int64[Pdr]
    domain_table: np.ndarray  # int64[Pdr, Kd]
    range_table: np.ndarray  # int64[Pdr, Kr]
    instance_base: int

    def concept_id(self, name: str) -> int:
        return self.concepts.id_of(name)

    def property_id(self, name: str) -> int:
        return self.properties.id_of(name)

    def summary(self) -> dict:
        return dict(
            concept_bits=self.concepts.total_bits,
            property_bits=self.properties.total_bits,
            n_concepts=self.concepts.n,
            n_properties=self.properties.n,
            instance_base=self.instance_base,
            max_concept_spills=self.concepts.max_spills(),
        )


def build_tbox(onto: Ontology, parallel: bool = False) -> TBox:
    """Classify + encode an Ontology into device-ready TBox tables."""
    ctax = build_taxonomy(onto.concepts, onto.subclass, root_name=ROOT)
    props = list(onto.properties)
    if RDF_TYPE not in props:
        props.append(RDF_TYPE)
    ptax = build_taxonomy(props, onto.subprop, root_name=PROP_ROOT)

    def enc(tax):
        if parallel:
            try:
                return encode_hierarchy_parallel(tax)
            except ValueError:  # >31-bit codes: fall back to bigint host path
                pass
        return encode_hierarchy(tax)

    cenc = enc(ctax)
    penc = enc(ptax)

    # domain/range tables, sorted by property id ----------------------------
    dr_props = sorted(set(onto.domain) | set(onto.range_), key=penc.id_of)
    Kd = max(1, max((len(onto.domain.get(p, ())) for p in dr_props), default=0))
    Kr = max(1, max((len(onto.range_.get(p, ())) for p in dr_props), default=0))
    P = max(1, len(dr_props))
    dr_prop_ids = np.full((P,), -1, dtype=np.int64)
    domain_table = np.full((P, Kd), -1, dtype=np.int64)
    range_table = np.full((P, Kr), -1, dtype=np.int64)
    if cenc.narrow and penc.narrow:  # int64 tables need narrow ids; wide
        for i, p in enumerate(dr_props):  # hierarchies keep axioms host-side
            dr_prop_ids[i] = penc.id_of(p)
            for j, c in enumerate(sorted(onto.domain.get(p, ()), key=cenc.id_of)):
                domain_table[i, j] = cenc.id_of(c)
            for j, c in enumerate(sorted(onto.range_.get(p, ()), key=cenc.id_of)):
                range_table[i, j] = cenc.id_of(c)

    instance_base = 1 << max(cenc.total_bits, penc.total_bits)
    return TBox(
        concepts=cenc,
        properties=penc,
        rdf_type_id=penc.id_of(RDF_TYPE),
        dr_prop_ids=dr_prop_ids,
        domain_table=domain_table,
        range_table=range_table,
        instance_base=instance_base,
    )
