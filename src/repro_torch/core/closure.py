"""Full RDFS materialization — the paper's baseline (Table V).

Forward-chains the RDFS rules the paper targets (rdfs2/3 domain/range,
rdfs5/7 sub-property, rdfs9/11 sub-class) in one pass: thanks to the prefix
encoding, the sub-class/sub-property closure of an id is just its DAG
ancestor row (precomputed table; pure gathers — no joins), and the one
candidate pass of materialize.py already folds domain/range through
effective property-ancestor tables.  Synthetic roots (our __root__ nodes,
id 0) are not materialized, matching the paper's datasets which never store
owl:Thing types.

Output is a lexicographically sorted triple array with a first-occurrence
mask — the "much longer + bigger store" whose cost Table V measures.  Rows
that derive nothing are dropped before the dedup sort rather than carried
as INVALID padding: they would sort last and fail the mask anyway, so
``compact_rows(out, valid)`` is the same store, and at LUBM-100 the padded
union (40 rows per triple) would not fit beside the sort's scratch.
"""
from __future__ import annotations

import torch

from repro_torch.core.materialize import (
    INVALID, DeviceTBox, _search, candidate_types,
)


def _dedup_rows(s, p, o):
    """Sort rows lexicographically; return sorted cols + first-occurrence mask."""
    # two stable passes: (p, o) as one int64 key, then s
    perm = torch.sort((p.to(torch.int64) << 31) | o.to(torch.int64),
                      stable=True).indices
    perm = perm[torch.sort(s[perm], stable=True).indices]
    s, p, o = s[perm], p[perm], o[perm]
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = (s[1:] != s[:-1]) | (p[1:] != p[:-1]) | (o[1:] != o[:-1])
    return s, p, o, first & (s != INVALID)


def _ancestor_rows(subj, anc, obj, ok):
    """Rows (subj, anc[:, j], obj) wherever ``ok[:, j]``; obj None = anc is o."""
    rows, cols = ok.nonzero(as_tuple=True)
    if obj is None:
        return subj[rows], None, anc[rows, cols]
    return subj[rows], anc[rows, cols], obj[rows]


def full_materialize(kb, dtb: DeviceTBox | None = None):
    """kb.spo -> (closed spo (sorted), first-occurrence mask, stats)."""
    dtb = dtb or DeviceTBox.build(kb.tbox, device=kb.spo.device)
    return full_materialize_rows(kb.spo, dtb)


def full_materialize_rows(spo, dtb: DeviceTBox):
    """Full closure of any encoded rows (a store or a delta batch)."""
    s, p, o = spo[:, 0], spo[:, 1], spo[:, 2]
    is_type = p == dtb.rdf_type_id

    # 1. property closure on non-type triples: (s, anc(p), o) --------------
    ppos, phit = _search(dtb.prop_sorted_ids, p)
    pancs = dtb.prop_ancestors[ppos]  # (N, DP)
    panc_ok = (phit & ~is_type)[:, None] & (pancs > 0)  # no synthetic root
    ps, pp, po = _ancestor_rows(s, pancs, o, panc_ok)

    # 2. type candidates (explicit + effective domain/range) ---------------
    inst, conc, _ = candidate_types(spo, dtb)
    cvalid = inst != INVALID
    inst, conc = inst[cvalid], conc[cvalid]

    # 3. concept closure on every candidate: (inst, type, anc(conc)) -------
    cpos, chit = _search(dtb.concept_sorted_ids, conc)
    cancs = dtb.concept_ancestors[cpos]  # (M, D)
    cs, _, co = _ancestor_rows(inst, cancs, None, chit[:, None] & (cancs > 0))

    # 4. union + dedup ------------------------------------------------------
    all_s = torch.cat([s, ps, inst, cs])
    all_p = torch.cat([p, pp, torch.full_like(inst, dtb.rdf_type_id),
                       torch.full_like(cs, dtb.rdf_type_id)])
    all_o = torch.cat([o, po, conc, co])
    del ps, pp, po, inst, conc, cs, co, cancs
    s_s, p_s, o_s, uniq = _dedup_rows(all_s, all_p, all_o)
    del all_s, all_p, all_o

    # original-dataset unique count (denominator of the paper's "+%")
    n_original_unique = int(_dedup_rows(s, p, o)[3].sum())
    st = dict(n_closure=int(uniq.sum()), n_original_unique=n_original_unique)
    st["added_pct"] = 100.0 * (st["n_closure"] - st["n_original_unique"]) / max(
        st["n_original_unique"], 1
    )
    return torch.stack([s_s, p_s, o_s], dim=1), uniq, st
