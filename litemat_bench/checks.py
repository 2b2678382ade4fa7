"""What decides ``correct``: the program's outputs against the reference.

Every number compared here is exact, so each limit is 0.  Facet answers are
judged one request at a time: the distinct count, and the returned members
(at most ``topk`` distinct instances of the answer, ascending by the
program's ids, ``-1`` behind) after the program's dictionary has decoded them
to fingerprints.  A bulk load is judged by its two stores, decoded the same
way: the lite store as a multiset, the full store as a set.
"""
from __future__ import annotations

import torch

from litemat_bench.reference.rdfs import Entailment, multiset_difference

LIMITS = {"unresolved": 0, "count_mismatches": 0, "member_faults": 0,
          "lite_rows_off": 0, "full_rows_off": 0, "builds_off": 0}


def facet_expected(E: Entailment, keys) -> dict:
    """(kind, class, property) -> sorted fingerprints of the answer (on the
    CPU; worked out on the reference's device)."""
    members, subjects, out = {}, {}, {}
    for kind, cls, prop in keys:
        if cls not in members:
            members[cls] = E.members(cls)
        ans = members[cls]
        if kind == "class_prop_join":
            if prop not in subjects:
                subjects[prop] = E.join_subjects(prop)
            ans = ans[torch.isin(ans, subjects[prop])]
        out[(kind, cls, prop)] = ans.cpu()
    return out


def _members_ok(ids, fps, expected, topk: int) -> bool:
    valid = ids >= 0
    n = int(valid.sum())
    if n != min(expected.shape[0], topk) or bool(valid[n:].any()):
        return False
    ids, fps = ids[:n], fps[:n]
    if n and not bool((ids[1:] > ids[:-1]).all()):
        return False
    if torch.unique(fps).shape[0] != n:
        return False
    pos = torch.searchsorted(expected, fps).clamp(max=max(expected.shape[0] - 1, 0))
    return n == 0 or bool((expected[pos] == fps).all())


def facet_checks(answers, expected: dict, topk: int, unresolved: int) -> dict:
    """``answers``: (key, count, member ids int64[topk], member fingerprints
    int64[topk]) of every request answered ``ok``."""
    counts = members = 0
    for key, count, ids, fps in answers:
        exp = expected[key]
        counts += int(count) != int(exp.shape[0])
        members += not _members_ok(ids, fps, exp, topk)
    return {"unresolved": unresolved, "count_mismatches": counts,
            "member_faults": members}


def control_facet_answers(E: Entailment, keys, expected: dict, topk: int):
    """The reference in the program's place with set semantics dropped: a
    count of every most specific (instance, class) row under the class, as a
    dedup-free plan would count the type index's slice."""
    x, c = E.most_specific()
    bag: dict = {}
    out = []
    for key in keys:
        kind, cls, prop = key
        if key not in bag:
            below = torch.tensor(E.voc.below_concept(E.voc.concept_index(cls)),
                                 device=c.device)
            rows = x[torch.isin(c, below)]
            if kind == "class_prop_join":
                rows = rows[torch.isin(rows, E.join_subjects(prop))]
            bag[key] = int(rows.shape[0])
        exp = expected[key]
        n = min(exp.shape[0], topk)
        ids = torch.full((topk,), -1, dtype=torch.int64)
        ids[:n] = torch.arange(n)
        fps = torch.full((topk,), -1, dtype=torch.int64)
        fps[:n] = exp[:n]
        out.append((key, bag[key], ids, fps))
    return out


def load_checks(E: Entailment, lite_fp, full_fp, build_rows) -> dict:
    """The last build's stores against the reference's, row for row, and
    every build's row counts against the reference's."""
    lite = E.lite_store()
    n_lite = lite.shape[0]
    lite_off = multiset_difference(lite_fp, lite)
    del lite
    full = E.full_store()
    n_full = full.shape[0]
    full_off = multiset_difference(full_fp, full)
    del full
    builds_off = sum((a, b) != (n_lite, n_full) for a, b in build_rows)
    return {"lite_rows_off": lite_off, "full_rows_off": full_off,
            "builds_off": builds_off}
