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
