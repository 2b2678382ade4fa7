"""Lite materialization — the paper's §IV, vectorized.

Per instance, gather *candidate concepts* (explicit rdf:type objects plus
concepts implied by rdfs:domain / rdfs:range of the properties the instance
occurs with), then keep only the Most Specific Concepts: thanks to the
interval encoding, after sorting candidates a concept is redundant iff a
candidate of the same instance falls strictly inside its subsumption
interval — one sort + binary searches over the whole dataset.

RDFS subtlety the paper glosses over: ``domain`` axioms of *super*-properties
also apply (rdfs7 ∘ rdfs2/3).  We fold that in by precomputing *effective*
domain/range tables per property (union over its property-DAG ancestors) on
the host — properties are few — so the device pass stays one lookup per
triple.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.tbox import TBox

INVALID = int(np.iinfo(np.int32).max)  # sorts to the end


def _search(sorted_ids: torch.Tensor, values: torch.Tensor):
    """(clamped insertion position, exact-hit mask) in a sorted id table."""
    pos = torch.searchsorted(sorted_ids, values.contiguous()).clamp(
        0, sorted_ids.shape[0] - 1)
    return pos, sorted_ids[pos] == values


@dataclass(frozen=True)
class DeviceTBox:
    """The TBox tables the device passes need, as int32 tensors."""

    rdf_type_id: int
    concept_sorted_ids: torch.Tensor  # int32[C]
    concept_sorted_bounds: torch.Tensor  # int32[C]
    concept_spill_lo: torch.Tensor  # int32[C, S]
    concept_spill_hi: torch.Tensor
    concept_ancestors: torch.Tensor  # int32[C, D], -1 padded (DAG ancestors)
    prop_sorted_ids: torch.Tensor  # int32[P]
    prop_ancestors: torch.Tensor  # int32[P, DP], -1 padded
    dr_prop_ids: torch.Tensor  # int32[Pdr] sorted (effective tables)
    domain_table: torch.Tensor  # int32[Pdr, Kd], -1 padded
    range_table: torch.Tensor  # int32[Pdr, Kr], -1 padded

    @staticmethod
    def build(tbox: TBox, device=None) -> "DeviceTBox":
        c = tbox.concepts
        p = tbox.properties
        if c.total_bits > 30 or p.total_bits > 30:
            raise ValueError(
                "device path needs narrow (<=30 bit) ids; use the wide-id host path"
            )
        # effective domain/range: union over property-DAG ancestors ---------
        pid_of_node = {i: int(p.ids[i]) for i in range(p.n)}
        direct_dom = {int(k): [int(v) for v in row if v >= 0]
                      for k, row in zip(tbox.dr_prop_ids, tbox.domain_table)}
        direct_rng = {int(k): [int(v) for v in row if v >= 0]
                      for k, row in zip(tbox.dr_prop_ids, tbox.range_table)}
        eff_dom, eff_rng = {}, {}
        for node in range(p.n):
            pid = pid_of_node[node]
            chain = [node, *sorted(p.tax.dag_ancestors(node))]
            dom = sorted({d for a in chain for d in direct_dom.get(pid_of_node[a], [])})
            rng = sorted({r for a in chain for r in direct_rng.get(pid_of_node[a], [])})
            if dom:
                eff_dom[pid] = dom
            if rng:
                eff_rng[pid] = rng
        keys = sorted(set(eff_dom) | set(eff_rng))
        Kd = max(1, max((len(v) for v in eff_dom.values()), default=0))
        Kr = max(1, max((len(v) for v in eff_rng.values()), default=0))
        P = max(1, len(keys))
        dr_ids = np.full((P,), -1, dtype=np.int32)
        dom_tbl = np.full((P, Kd), -1, dtype=np.int32)
        rng_tbl = np.full((P, Kr), -1, dtype=np.int32)
        for i, k in enumerate(keys):
            dr_ids[i] = k
            for j, v in enumerate(eff_dom.get(k, [])):
                dom_tbl[i, j] = v
            for j, v in enumerate(eff_rng.get(k, [])):
                rng_tbl[i, j] = v

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                   device=device)

        return DeviceTBox(
            rdf_type_id=int(tbox.rdf_type_id),
            concept_sorted_ids=t(c.sorted_ids),
            concept_sorted_bounds=t(c.sorted_bounds),
            concept_spill_lo=t(c.sorted_spill_lo),
            concept_spill_hi=t(c.sorted_spill_hi),
            concept_ancestors=t(c.sorted_ancestors),
            prop_sorted_ids=t(p.sorted_ids),
            prop_ancestors=t(p.sorted_ancestors),
            dr_prop_ids=t(dr_ids),
            domain_table=t(dom_tbl),
            range_table=t(rng_tbl),
        )


def concept_bounds(dtb: DeviceTBox, concept_ids):
    """bound() for concept-id arrays via the sorted TBox table.

    Unknown ids (instances/literals) get bound = id + 1 (leaf semantics).
    """
    pos, hit = _search(dtb.concept_sorted_ids, concept_ids)
    return (torch.where(hit, dtb.concept_sorted_bounds[pos], concept_ids + 1),
            pos, hit)


# ---------------------------------------------------------------------------
# Candidate generation + MSC
# ---------------------------------------------------------------------------


def candidate_types(spo, dtb: DeviceTBox):
    """(instance, concept, explicit) candidate rows, INVALID-padded.

    Row layout (static): N explicit + N*Kd domain + N*Kr range candidates.
    """
    s, p, o = spo[:, 0], spo[:, 1], spo[:, 2]
    is_type = p == dtb.rdf_type_id
    inv = torch.full_like(s, INVALID)

    inst_e = torch.where(is_type, s, inv)
    conc_e = torch.where(is_type, o, inv)

    pos, hit = _search(dtb.dr_prop_ids, p)
    p_hit = hit & ~is_type
    doms = dtb.domain_table[pos]  # (N, Kd)
    rngs = dtb.range_table[pos]  # (N, Kr)
    dom_ok = p_hit[:, None] & (doms >= 0)
    rng_ok = p_hit[:, None] & (rngs >= 0)
    inst_d = torch.where(dom_ok, s[:, None], INVALID).reshape(-1)
    conc_d = torch.where(dom_ok, doms, INVALID).reshape(-1)
    inst_r = torch.where(rng_ok, o[:, None], INVALID).reshape(-1)
    conc_r = torch.where(rng_ok, rngs, INVALID).reshape(-1)

    inst = torch.cat([inst_e, inst_d, inst_r])
    conc = torch.cat([conc_e, conc_d, conc_r])
    explicit = torch.cat([is_type, torch.zeros_like(dom_ok).reshape(-1),
                          torch.zeros_like(rng_ok).reshape(-1)])
    return inst, conc, explicit


def _pair_key31(a, b):
    """(a, b) order of non-negative int32 pairs as one int64 key."""
    return (a.to(torch.int64) << 31) | b.to(torch.int64)


def msc_select(inst, conc, explicit, dtb: DeviceTBox):
    """One-pass MSC over (instance, concept) candidates.

    Returns (inst_s, conc_s, keep, uniq_explicit, dropped_explicit,
    added_implicit) — all aligned to the sorted candidate order.
    """
    # sort by (instance, concept, explicit-first) so duplicate heads carry
    # explicitness; INVALID rows sink to the end.  Ids are non-negative
    # int32, so the three keys pack into one int64.
    key = ((inst.to(torch.int64) << 32) | (conc.to(torch.int64) << 1)
           | (~explicit).to(torch.int64))
    perm = torch.sort(key, stable=True).indices
    inst_s, conc_s, expl_s = inst[perm], conc[perm], explicit[perm]
    valid = inst_s != INVALID

    first = torch.ones_like(valid)
    first[1:] = (inst_s[1:] != inst_s[:-1]) | (conc_s[1:] != conc_s[:-1])
    uniq = first & valid

    bounds, cpos, chit = concept_bounds(dtb, conc_s)
    bounds = torch.where(valid, bounds, conc_s)  # freeze padding rows
    # a unique candidate c is dropped iff some candidate of the same instance
    # lies strictly inside (c, bound(c)): rows in [R_right(inst, c),
    # R_left(inst, bound)) of the sorted candidates are exactly those
    # descendants, so two binary searches decide the interval test exactly.
    table = _pair_key31(inst_s, conc_s)
    L = torch.searchsorted(table, table, right=True)
    R = torch.searchsorted(table, _pair_key31(inst_s, bounds))
    dropped_by_desc = R > L

    # spill intervals (multiple inheritance): candidate c is also dropped if
    # some candidate of the same instance lies in one of c's spill ranges.
    zero = torch.zeros_like(dtb.concept_spill_lo[cpos])
    sp_lo = torch.where(chit[:, None], dtb.concept_spill_lo[cpos], zero)
    sp_hi = torch.where(chit[:, None], dtb.concept_spill_hi[cpos], zero)
    any_spill_hit = torch.zeros_like(valid)
    for k in range(sp_lo.shape[1]):
        lo_k, hi_k = sp_lo[:, k], sp_hi[:, k]
        has = lo_k < hi_k
        L = torch.searchsorted(table, _pair_key31(inst_s, lo_k))
        R = torch.searchsorted(table, _pair_key31(inst_s, hi_k))
        any_spill_hit |= has & (R > L)

    keep = uniq & ~dropped_by_desc & ~any_spill_hit
    dropped_explicit = int((uniq & expl_s & ~keep).sum())
    added_implicit = int((keep & ~expl_s).sum())
    n_explicit_uniq = int((uniq & expl_s).sum())
    return inst_s, conc_s, keep, n_explicit_uniq, dropped_explicit, added_implicit


def lite_materialize(kb, dtb: DeviceTBox | None = None):
    """kb.spo -> (materialized spo (padded), valid mask, stats dict)."""
    dtb = dtb or DeviceTBox.build(kb.tbox, device=kb.spo.device)
    spo = kb.spo
    inst, conc, explicit = candidate_types(spo, dtb)
    inst_s, conc_s, keep, n_expl, n_drop, n_add = msc_select(
        inst, conc, explicit, dtb)
    del inst, conc, explicit

    # output: non-type triples unchanged + MSC type triples (both padded)
    is_type = spo[:, 1] == dtb.rdf_type_id
    nt = torch.where(is_type[:, None], INVALID, spo)
    inv = torch.full_like(inst_s, INVALID)
    ty = torch.stack([
        torch.where(keep, inst_s, inv),
        torch.where(keep, torch.full_like(inst_s, dtb.rdf_type_id), inv),
        torch.where(keep, conc_s, inv),
    ], dim=1)
    out = torch.cat([nt, ty], dim=0)
    valid = out[:, 0] != INVALID
    stats = dict(  # keys in the reference's order (its jit sorts them)
        n_added_implicit=n_add,
        n_deleted_explicit=n_drop,
        n_explicit_unique=n_expl,
        n_nontype=int((~is_type).sum()),
        n_type_out=int(keep.sum()),
    )
    return out, valid, stats


def compact_rows(rows, valid):
    """Drop padding rows, keeping their order."""
    return rows[valid]
