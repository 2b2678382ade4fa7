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
