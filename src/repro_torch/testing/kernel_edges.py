"""Inputs at the edges of the CUDA kernels, shared by the card tests and
``chip_smoke.py``, which hold each kernel against its plain version on
them.  Made on the host from a seed, then moved to ``device``.
"""
from __future__ import annotations

import torch

CLOSURE_C = (1, 2, 44, 8192, 8193, 213_000)  # 8,192 ids are staged whole
CLOSURE_D = (1, 5, 8, 9, 16, 17, 32, 33)  # exact to 8, buckets 16 and 32
CLOSURE_N = (0, 1, 3, 4, 5, 257, 100_003)  # four queries a thread + n % 4


def closure_expand_edges(device, seed: int = 0):
    """``(conc, sorted_ids, anc_table)`` for ``closure_expand`` at every C of
    ``CLOSURE_C`` (past 8,192 ids the kernel stages every step-th id and
    reads the window between two of them from device memory), every D of
    ``CLOSURE_D`` (each template boundary and the generic kernel past 32)
    and every n of ``CLOSURE_N``, each as a view 0-3 ids off 16-byte
    alignment.  The queries are half hits; among them -1, INT32_MIN,
    INT32_MAX, one below the first id, one above the last, and each end.
    A third of the ancestor rows are all -1 and the rest hold some -1s, so
    a hit's -1 is not a miss's."""
    g = torch.Generator().manual_seed(seed)
    big = 1 << 24
    pool_n = max(CLOSURE_N) + 8
    for c in CLOSURE_C:
        gaps = torch.randint(1, 2 * big // c + 1, (c,), generator=g)
        ids = gaps.cumsum(0).to(torch.int32)  # sorted, distinct, < 2**25
        lo, hi = int(ids[0]), int(ids[-1])
        for d in CLOSURE_D:
            anc = torch.randint(-1, 1 << 20, (c, d), generator=g,
                                dtype=torch.int32)
            anc[::3] = -1
            pool = torch.randint(-5, big, (pool_n,), generator=g,
                                 dtype=torch.int32)
            pool[::2] = ids[torch.randint(0, c, ((pool_n + 1) // 2,),
                                          generator=g)]
            pool = pool[torch.randperm(pool_n, generator=g)]
            pool[:8] = torch.tensor([-1, -2**31, 2**31 - 1, lo - 1, hi + 1,
                                     lo, hi, 0], dtype=torch.int32)
            pool[8:16] = pool[:8].flip(0)
            ids_d, anc_d, pool_d = (t.to(device) for t in (ids, anc, pool))
            for n in CLOSURE_N:
                for off in range(4):
                    yield pool_d[off:off + n], ids_d, anc_d


# compact_lookback_group (csrc/stream_compact.cu), which runs the batched
# K2 and K4: the members a CTA compacts (kGroup), the ids of a set it may
# stage (kStageMax) and the bytes of a group's staged sets (kGroupStageBytes)
GROUP, STAGE_MAX, STAGE_BYTES = 16, 2048, 64 << 10


def staged_members(widths) -> int:
    """The leading members of a group whose sets the group kernel stages
    for K4 (the rest are searched in device memory), for members whose
    searched sets have these widths (mem's, and dom's and rng's with their
    branches): sets past STAGE_MAX ids are never staged; of the others, as
    many members' as STAGE_BYTES hold."""
    per = 4 * sum(k for k in widths if k <= STAGE_MAX)
    return GROUP if per == 0 else min(GROUP, STAGE_BYTES // per)


# members of one batched launch: the group boundaries of the batched K2
# and K4 among them
BATCH_B = (1, 2, 3, GROUP - 1, GROUP, GROUP + 1, 2 * GROUP + 1)
BATCH_N = (0, 1, 8191, 8192, 8193, (1 << 21) + 3)  # rows; 8,192 a tile
BATCH_KINDS = ("all-false", "all-true", "differing")
_I32_MIN, _I32_MAX = -2**31, 2**31 - 1


def _caps(n: int):
    return sorted({0, 1, n, n + 5})


def compact_mask_batched_edges(device, seed: int = 0, ns=BATCH_N):
    """``(mask, cap)`` for ``compact_mask_batched``: every B of ``BATCH_B``,
    n of ``ns``, cap of {0, 1, n, n + 5}, members all false, all true, and
    differing (member b set with probability (b + 1) / (B + 1)); the
    differing masks are rows of a wider buffer, 3 bytes off 16-byte
    alignment with a row stride of n + 35, so members sit at different
    offsets from 16 bytes."""
    g = torch.Generator().manual_seed(seed)
    for b in BATCH_B:
        for n in ns:
            prob = (torch.arange(b) + 1.0)[:, None] / (b + 1)
            wide = torch.rand((b, n + 35), generator=g) < prob
            masks = {"all-false": torch.zeros((b, n), dtype=torch.bool),
                     "all-true": torch.ones((b, n), dtype=torch.bool)}
            masks = {k: v.to(device) for k, v in masks.items()}
            masks["differing"] = wide.to(device)[:, 3:n + 3]
            for kind in BATCH_KINDS:
                for cap in _caps(n):
                    yield masks[kind], cap


def _interval_params(kind: str, b: int, g):
    """Per-member (plo, phi, olo, ohi): none, all or differing rows match;
    differing mixes bounds drawn in every field (four distinct values of
    [0, 64]: plo < phi and olo < ohi), inverted, empty and full-range
    ones."""
    if kind == "all-false":  # inverted and empty bounds
        rows = [(40, 10, 0, 64) if i % 2 else (7, 7, 0, 64) for i in range(b)]
    elif kind == "all-true":
        rows = [(_I32_MIN, _I32_MAX, _I32_MIN, _I32_MAX)] * b
    else:
        rows = []
        for i in range(b):
            lo, hi, olo, ohi = (torch.randperm(65, generator=g)[:4]
                                .view(2, 2).sort(1).values.view(-1)
                                .tolist())
            rows.append([(lo, hi, olo, ohi), (50, 10, 0, 64), (9, 9, 0, 64),
                         (_I32_MIN, _I32_MAX, _I32_MIN, _I32_MAX)][i % 4])
    return torch.tensor(rows, dtype=torch.int32)


def masked_interval_batched_edges(device, seed: int = 0, ns=BATCH_N):
    """``(p, o, alive, params, cap)`` for
    ``masked_interval_compact_batched``: p and o strided columns of one
    [n, 3] store of small ids, alive partly false (all true for the
    all-true members), params int32[B, 4] from ``_interval_params``, at
    every B of ``BATCH_B``, n of ``ns`` and cap of the batched edges."""
    g = torch.Generator().manual_seed(seed)
    nmax = max(ns)
    rows = torch.randint(0, 64, (nmax, 3), generator=g,
                         dtype=torch.int32).to(device)
    alive_part = (torch.rand(nmax, generator=g) < 0.9).to(device)
    alive_all = torch.ones(nmax, dtype=torch.bool, device=device)
    for b in BATCH_B:
        for n in ns:
            for kind in BATCH_KINDS:
                params = _interval_params(kind, b, g).to(device)
                alive = (alive_all if kind == "all-true" else alive_part)[:n]
                for cap in _caps(n):
                    yield rows[:n, 1], rows[:n, 2], alive, params, cap


def _member_sets(kind: str, b: int, g, mk: int):
    """Per-member (mem [B, mk], dom [B, 16], rng [B, 16]) sets of a store
    whose p lies in [0, 16) and o in [0, 64): all padding, every p in dom
    and rng (every row hits), or random per member.  Random mem sets past
    ``STAGE_MAX`` slots are drawn from [0, 2**20); the others from
    o's range, member i's with {}, {0, 63}, {0, 64} or {5, 2**20} added
    for i % 4 = 0 .. 3 (the group kernel tests a set that spans under 64
    ids as a mask and searches a wider one); every other member's dom
    holds an id past the mask's reach too."""

    def padded(ids, cap):
        out = torch.full((cap,), _I32_MAX, dtype=torch.int32)
        ids = torch.unique(torch.as_tensor(ids, dtype=torch.int32))[:cap]
        out[: ids.shape[0]] = ids
        return out

    def rand(hi, most, extra=()):
        k = int(torch.randint(0, most + 1, (1,), generator=g))
        return torch.cat([torch.randint(0, hi, (k,), generator=g),
                          torch.tensor(extra, dtype=torch.int64)])

    if kind == "all-false":
        sets = [([], [], [])] * b
    elif kind == "all-true":
        sets = [(range(0, 64, 9), range(16), range(16))] * b
    else:
        sets = [(rand(1 << 20, mk) if mk > STAGE_MAX else
                 rand(64, min(mk, 64) - 2,
                      ((), (0, 63), (0, 64), (5, 1 << 20))[i % 4]),
                 rand(16, 4, (4096 + i,) if i % 2 else ()), rand(16, 2))
                for i in range(b)]
    return [torch.stack([padded(s[i], cap) for s in sets])
            for i, cap in enumerate((mk, 16, 16))]


def member_batched_edges(device, seed: int = 0, ns=BATCH_N):
    """``(s, p, o, alive, tid, mem, dom, rng, has_dom, has_rng, cap)`` for
    ``member_compact_batched``: one [n, 3] store (p in [0, 16), o in
    [0, 64), every 97th subject INVALID, alive partly false), tid 3, sets
    from ``_member_sets`` at every B of ``BATCH_B`` and n of ``ns``; every
    has_dom/has_rng pair below 8,194 rows, both branches past it.  The
    differing members' mem sets hold 8 slots, but 4,096 at B of 3 (past
    ``STAGE_MAX``: searched in device memory, per member) and 2,048 at B
    of GROUP + 1 and 2 GROUP + 1 (staged, but a group's exceed the staging
    budget: its leading members' sets are staged, the others' searched in
    device memory)."""
    g = torch.Generator().manual_seed(seed)
    nmax = max(ns)
    rows = torch.stack([torch.randint(0, 1 << 20, (nmax,), generator=g),
                        torch.randint(0, 16, (nmax,), generator=g),
                        torch.randint(0, 64, (nmax,), generator=g)],
                       1).to(torch.int32)
    rows[::97, 0] = _I32_MAX
    rows = rows.to(device)
    alive = (torch.rand(nmax, generator=g) < 0.9).to(device)
    for b in BATCH_B:
        for n in ns:
            flags = ((True, True),) if n > 8193 else (
                (False, False), (True, False), (False, True), (True, True))
            for kind in BATCH_KINDS:
                mk = 8
                if kind == "differing" and b == 3:
                    mk = 2 * STAGE_MAX
                elif kind == "differing" and b in (GROUP + 1, 2 * GROUP + 1):
                    mk = STAGE_MAX
                mem, dom, rng = (t.to(device)
                                 for t in _member_sets(kind, b, g, mk))
                for hd, hr in flags:
                    for cap in _caps(n):
                        yield (rows[:n, 0], rows[:n, 1], rows[:n, 2],
                               alive[:n], 3, mem, dom, rng, hd, hr, cap)


SHARDED_NS = (0, 1, 8193)  # rows of the sharded path's compaction edges


def sharded_path_edges(device, seed: int = 8):
    """``(kernel, run, plain)`` for every kernel of the sharded path on
    ``device``: ``run()`` calls the wrapper named ``kernel`` and ``plain()``
    its plain version on the same inputs, each returning a list of tensors
    to hold equal.  K1 (solo and batched), K2 and K4 (solo on each
    batched edge's first member, and batched) at n of ``SHARDED_NS``, K3's
    range entry over a strided 100,000-row table with duplicate keys and
    probes past both ends, and K5/K6 (both wrappers) on a long and a short
    run; what the card tests and ``chip_smoke.py`` run on a second card."""
    from repro_torch.kernels import merge_sorted as ms
    from repro_torch.kernels import pair_search as ps
    from repro_torch.kernels import stream_compact as sc
    from repro_torch.utils.pair64 import pair_key

    def flat(streams):
        return [t for st in streams for t in st]

    for mask, cap in compact_mask_batched_edges(device, seed, SHARDED_NS):
        yield ("compact_mask", lambda m=mask[0], c=cap: sc.compact_mask(m, c),
               lambda m=mask[0], c=cap: sc.compact_mask_plain(m, c))
        yield ("compact_mask_batched",
               lambda m=mask, c=cap: sc.compact_mask_batched(m, c),
               lambda m=mask, c=cap: sc.compact_mask_batched_plain(m, c))
    for a in masked_interval_batched_edges(device, seed, SHARDED_NS):
        solo = (*a[:3], a[3][0].tolist(), a[4])
        yield ("masked_interval_compact",
               lambda a=solo: sc.masked_interval_compact(*a),
               lambda a=solo: sc.masked_interval_compact_plain(*a))
        yield ("masked_interval_compact_batched",
               lambda a=a: sc.masked_interval_compact_batched(*a),
               lambda a=a: sc.masked_interval_compact_batched_plain(*a))
    for a in member_batched_edges(device, seed, SHARDED_NS):
        solo = (*a[:5], a[5][0], a[6][0], a[7][0], *a[8:])
        yield ("member_compact",
               lambda a=solo: flat(sc.member_compact(*a)),
               lambda a=solo: flat(sc.member_compact_plain(*a)))
        yield ("member_compact_batched",
               lambda a=a: flat(sc.member_compact_batched(*a)),
               lambda a=a: flat(sc.member_compact_batched_plain(*a)))
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, 40, (100_000, 3), generator=g, dtype=torch.int32)
    rows = rows[torch.sort(rows[:, 1].long() * 64 + rows[:, 0],
                           stable=True).indices].to(device)
    qh = torch.randint(-2, 43, (3000,), generator=g, dtype=torch.int32)
    ql = torch.randint(-2, 43, (3000,), generator=g, dtype=torch.int32)
    qh[:40], ql[40:80] = _I32_MAX, _I32_MAX
    args = (rows[:, 1], rows[:, 0], qh.to(device), ql.to(device))
    yield ("pair_range", lambda: list(ps.pair_range(*args)),
           lambda: list(ps.pair_range_plain(*args)))
    perm = torch.sort(pair_key(args[2], args[3]), stable=True).indices
    ah, al = args[2][perm], args[3][perm]  # the probes as a sorted run
    for runs in ((ah, al, rows[:, 1], rows[:, 0]), (ah[:7], al[:7], ah, al)):
        for name in ("merge_path", "merge_path_resident"):
            yield (name, lambda r=runs, f=getattr(ms, name): [f(*r)],
                   lambda r=runs: [ms.merge_path_plain(*r)])
