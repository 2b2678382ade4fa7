"""The CUDA kernels against their plain versions, bit for bit.

Needs a CUDA device, nvcc and no JAX: on a machine with a card run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX).  Without a card the
test skips itself.
"""
import pytest
import torch

from repro_torch.kernels import merge_sorted as t_ms
from repro_torch.kernels import pair_search as t_ps
from repro_torch.kernels import stream_compact as t_sc


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each CUDA kernel equals its plain version, bit for bit (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    for n, block in ((0, 512), (3 * 512 + 17, 512), (70_000, 4096)):
        mask = (torch.rand(n, generator=g) < 0.3).to(dev)
        for a, b in zip(t_sc.compact_tiles(mask, block),
                        t_sc.compact_tiles_plain(mask, block)):
            assert torch.equal(a, b)
        rows = torch.randint(0, 50, (n, 3), generator=g, dtype=torch.int32).to(dev)
        prm = (10, 20, 5, 45)
        for a, b in zip(
                t_sc.masked_interval_tiles(rows[:, 1], rows[:, 2], mask, prm, block),
                t_sc.masked_interval_tiles_plain(rows[:, 1], rows[:, 2], mask,
                                                 prm, block)):
            assert torch.equal(a, b)
    rows = torch.randint(0, 100, (200_000, 3), generator=g, dtype=torch.int32)
    rows = rows[torch.sort(rows[:, 1].long() * 128 + rows[:, 0], stable=True).indices]
    rows = rows.to(dev)
    qh = torch.randint(0, 101, (5000,), generator=g, dtype=torch.int32).to(dev)
    ql = torch.randint(0, 101, (5000,), generator=g, dtype=torch.int32).to(dev)
    assert torch.equal(t_ps.pair_search(rows[:, 1], rows[:, 0], qh, ql),
                       t_ps.pair_search_plain(rows[:, 1], rows[:, 0], qh, ql))
    perm = torch.sort(qh.long() * 128 + ql, stable=True).indices
    ah, al = qh[perm], ql[perm]
    for args in ((ah, al, rows[:, 1], rows[:, 0]), (rows[:, 1], rows[:, 0], ah, al),
                 (ah[:7], al[:7], rows[:, 1], rows[:, 0])):
        assert torch.equal(t_ms.merge_path(*args), t_ms.merge_path_plain(*args))


def _member_set(ids, cap):
    out = torch.full((cap,), 2**31 - 1, dtype=torch.int32)
    ids = torch.unique(torch.as_tensor(ids, dtype=torch.int32))
    out[: ids.shape[0]] = ids
    return out


@pytest.mark.cuda
def test_cuda_member_compact_matches_plain():
    """K4 (member_tiles) equals its plain version, bit for bit, on every
    has_dom/has_rng case, empty and all-padding sets, sets larger than the
    staged part, INVALID rows, and 512/4096-row tiles (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    inv = 2**31 - 1
    sets = {
        "small": (_member_set([3, 5, 9], 8), _member_set([1, 7], 8),
                  _member_set([2, 6, 11], 8)),
        "all_pad": (_member_set([], 8), _member_set([], 8), _member_set([], 8)),
        "large": (_member_set(torch.randint(0, 12000, (5000,), generator=g), 8192),
                  _member_set(torch.randint(0, 40, (30,), generator=g), 32),
                  _member_set(torch.randint(0, 12000, (3000,), generator=g), 4096)),
    }
    for n, block in ((0, 512), (1, 512), (3 * 512 + 17, 512), (70_000, 4096)):
        spo = torch.randint(0, 12000, (n, 3), generator=g, dtype=torch.int32)
        spo[:, 1] = torch.randint(0, 14, (n,), generator=g, dtype=torch.int32)
        if n:
            spo[torch.rand(n, generator=g) < 0.05] = inv  # INVALID rows
            spo[torch.rand(n, generator=g) < 0.05, 2] = inv
        alive = torch.rand(n, generator=g) < 0.9
        spo, alive = spo.to(dev), alive.to(dev)
        for mem, dom, rng in sets.values():
            mem, dom, rng = mem.to(dev), dom.to(dev), rng.to(dev)
            for has_dom in (False, True):
                for has_rng in (False, True):
                    args = (spo[:, 0], spo[:, 1], spo[:, 2], alive, 4, mem,
                            dom, rng, has_dom, has_rng, block)
                    got = t_sc.member_tiles(*args)
                    want = t_sc.member_tiles_plain(*args)
                    assert len(got) == len(want) == (2 if has_rng else 1)
                    for (gl, gc), (wl, wc) in zip(got, want):
                        assert torch.equal(gl, wl) and torch.equal(gc, wc)
