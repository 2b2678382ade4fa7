"""The CUDA kernels against their plain versions, bit for bit.

Needs a CUDA device, nvcc and no JAX: on a machine with a card run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX).  Without a card the
test skips itself.
"""
import pytest
import torch

from repro_torch.kernels import build as t_build
from repro_torch.kernels import closure_expand as t_ce
from repro_torch.kernels import interval_filter as t_if
from repro_torch.kernels import merge_sorted as t_ms
from repro_torch.kernels import msc_select as t_msc
from repro_torch.kernels import pair_search as t_ps
from repro_torch.kernels import stream_compact as t_sc
from repro_torch.kernels import ops as t_ops
from repro_torch.testing.kernel_edges import (
    closure_expand_edges, compact_mask_batched_edges,
    masked_interval_batched_edges, member_batched_edges, sharded_path_edges,
)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each CUDA kernel equals its plain version, bit for bit (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    for n, block in ((0, 512), (3 * 512 + 17, 512), (70_000, 4096)):
        mask = (torch.rand(n, generator=g) < 0.3).to(dev)
        for a, b in zip(t_sc.compact_mask(mask, 4096),
                        t_sc.compact_mask_plain(mask, 4096)):
            assert torch.equal(a, b)
        rows = torch.randint(0, 50, (n, 3), generator=g, dtype=torch.int32).to(dev)
        prm = (10, 20, 5, 45)
        for a, b in zip(
                t_sc.masked_interval_compact(rows[:, 1], rows[:, 2], mask, prm,
                                             4096),
                t_sc.masked_interval_compact_plain(rows[:, 1], rows[:, 2], mask,
                                                   prm, 4096)):
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


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _flat(streams):
    return [t for st in streams for t in st]


@pytest.mark.cuda
def test_cuda_member_compact_matches_plain():
    """K4 (member_compact, the single-pass look-back) equals its plain
    version, bit for bit, on every has_dom/has_rng case, empty (all-padding)
    sets of 8 and 1 slots, full and padded sets of 4 and 16 slots (compared
    member by member) and of 32 (searched), sets of 2,048 ids (all staged)
    and larger (searched in device memory), one set for dom and rng (rows
    hit both branches), INVALID subjects and objects, dead rows, n = 0, one
    row, ragged and multi-tile stores, stride-1 columns, and caps at and
    under each stream's total (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    inv = 2**31 - 1
    both = _member_set([2, 6, 7, 11], 4)
    sets = {
        "small": (_member_set([3, 5, 9], 8), _member_set([1, 7], 8),
                  _member_set([2, 6, 11], 8)),
        "all_pad": (_member_set([], 8), _member_set([], 8), _member_set([], 8)),
        "pad1": (_member_set([], 1), _member_set([], 1), _member_set([], 1)),
        "both": (_member_set(torch.arange(0, 8192, 4), 2048), both, both),
        "sixteen": (_member_set(torch.arange(0, 32, 2), 16),
                    _member_set(torch.arange(14), 16),
                    _member_set(torch.arange(1, 14, 2), 16)),
        "large": (_member_set(torch.randint(0, 12000, (5000,), generator=g), 8192),
                  _member_set(torch.randint(0, 40, (30,), generator=g), 32),
                  _member_set(torch.randint(0, 12000, (3000,), generator=g), 4096)),
    }
    for n in (0, 1, 3 * 512 + 17, 70_000):
        spo = torch.randint(0, 12000, (n, 3), generator=g, dtype=torch.int32)
        spo[:, 1] = torch.randint(0, 14, (n,), generator=g, dtype=torch.int32)
        if n:
            spo[torch.rand(n, generator=g) < 0.05] = inv  # INVALID rows
            spo[torch.rand(n, generator=g) < 0.05, 2] = inv
        alive = torch.rand(n, generator=g) < 0.9
        spo, alive = spo.to(dev), alive.to(dev)
        views = [(spo[:, 0], spo[:, 1], spo[:, 2])]
        if n == 70_000:  # stride-1 columns, one of them off 16-byte alignment
            views.append((spo[1:, 0].contiguous(), spo[1:, 1].contiguous(),
                          spo[:, 2].contiguous()[1:]))
        for cols in views:
            m = cols[0].shape[0]
            for mem, dom, rng in sets.values():
                mem, dom, rng = mem.to(dev), dom.to(dev), rng.to(dev)
                for has_dom in (False, True):
                    for has_rng in (False, True):
                        args = (*cols, alive[:m], 4, mem, dom, rng, has_dom,
                                has_rng)
                        totals = [int(t[2]) for t in
                                  t_sc.member_compact_plain(*args, 0)]
                        for cap in {max(totals) + 8, max(min(totals) // 3, 1)}:
                            got = t_sc.member_compact(*args, cap)
                            want = t_sc.member_compact_plain(*args, cap)
                            assert len(got) == (2 if has_rng else 1)
                            _same(_flat(got), _flat(want))


@pytest.mark.cuda
def test_cuda_masked_interval_compact_edges():
    """K2 (masked_interval_compact, the single-pass look-back) equals its
    plain version, bit for bit: n = 0, one row, ragged tiles and 2**17 + 3
    rows; store column views at offsets 0-3 rows, stride-1 columns aligned
    and not; all, no, random and a live head of rows alive; every row, no
    row and some rows in range; caps at and under the total (needs a
    card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    inv = 2**31 - 1
    rows = torch.randint(0, 50, ((1 << 17) + 8, 3), generator=g,
                         dtype=torch.int32).to(dev)
    pc, oc = rows[:, 1].contiguous(), rows[:, 2].contiguous()
    views = [(rows[k:, 1], rows[k:, 2]) for k in range(4)]
    views += [(pc[k:], oc[k:]) for k in (0, 1, 3)]
    for p, o in views:
        for n in (0, 1, 3 * 512 + 17, 5 * 8192 + 1, (1 << 17) + 3):
            pm, om = p[:n], o[:n]
            head = torch.arange(n, device=dev) < n - n // 7
            for alive in (torch.ones(n, dtype=torch.bool, device=dev),
                          torch.zeros(n, dtype=torch.bool, device=dev),
                          (torch.rand(n, generator=g) < 0.5).to(dev), head):
                for prm in ((10, 20, 5, 45), (-2**31, inv, -2**31, inv),
                            (7, 7, 0, 50)):
                    total = int(t_sc.masked_interval_compact_plain(
                        pm, om, alive, prm, 0)[2])
                    for cap in {total + 8, max(total // 3, 1)}:
                        _same(t_sc.masked_interval_compact(pm, om, alive, prm, cap),
                              t_sc.masked_interval_compact_plain(pm, om, alive,
                                                                 prm, cap))


@pytest.mark.cuda
def test_cuda_kernel_api_matches_plain():
    """K7-K11 (dual_compact, interval_tiles, interval_filter, msc_select,
    closure_expand) equal their plain versions, bit for bit: K7 at n = 0,
    n < 16, ragged tiles and 2**24 + 3 rows, all and none matching, caps 0,
    under and over each total, masks at different offsets from 16 bytes
    (``a[1:]`` with ``b[3:]``, ``a[5:]`` with a fresh ``b``); K8 and K9 at
    n = 0 and ragged last tiles; K10 at every template boundary (K = 1, 6,
    8, 9, 16, 17, 32, 33), K = 300 and 7,000 (a group wider than the staged
    part), G = 0 and views off 16-byte alignment; K11 at
    ``kernel_edges.closure_expand_edges``: n = 0, 1, 3, 4, 5, 257 and
    100,003, views 0-3 ids off 16 bytes, C = 1, 2, 44, 8,192, 8,193 (past
    the staged ids) and 213,000, D = 1, 5, 8, 9, 16, 17, 32 and 33 (each
    template boundary and the generic kernel), queries -1, INT32_MIN,
    INT32_MAX and at and beyond each end of the table, ancestor rows of -1
    (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    inv = 2**31 - 1

    def same(got, want):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)

    for n, block in ((0, 512), (1, 512), (3 * 512 + 17, 512), (70_000, 4096)):
        rows = torch.randint(0, 50, (n, 3), generator=g, dtype=torch.int32).to(dev)
        p, o = rows[:, 1], rows[:, 2]
        for prm in ((10, 20, 5, 45), (-2**31, inv, -2**31, inv), (7, 7, 0, 50)):
            same([t_if.interval_filter(p, o, prm)],
                 [t_if.interval_filter_plain(p, o, prm)])
            same(t_sc.interval_tiles(p, o, prm, block),
                 t_sc.interval_tiles_plain(p, o, prm, block))

    def dual(a, b):
        totals = [int(t[2]) for t in t_sc.dual_compact_plain(a, b, 0)]
        for cap in {0, max(totals) + 8, max(min(totals) // 3, 1)}:
            same([t for st in t_sc.dual_compact(a, b, cap) for t in st],
                 [t for st in t_sc.dual_compact_plain(a, b, cap) for t in st])

    big = (torch.rand((1 << 24) + 8, generator=g) < 0.5).to(dev)
    for n in (0, 1, 7, 15, 3 * 512 + 17, 70_000):
        for da, db in ((0.0, 1.0), (0.3, 0.7), (1.0, 0.0)):
            dual((torch.rand(n, generator=g) < da).to(dev),
                 (torch.rand(n, generator=g) < db).to(dev))
        dual(big[1:n + 1], big[3:n + 3])
        dual(big[5:n + 5], (torch.rand(n, generator=g) < 0.3).to(dev))
    dual(big[: (1 << 24) + 3], big[3: (1 << 24) + 6])

    for G, K in ((0, 4), (1, 1), (37, 16), (130, 8), (64, 33), (3, 300),
                 (2, 7000), (1000, 1), (300, 6), (257, 8), (129, 9), (65, 17),
                 (70, 32), (0, 6), (0, 17)):
        conc = torch.randint(-1, 500, (G + 1, K), generator=g, dtype=torch.int32)
        bounds = conc + torch.randint(1, 64, (G + 1, K), generator=g,
                                      dtype=torch.int32)
        conc, bounds = conc.to(dev), bounds.to(dev)
        # a fresh tensor and a view one group in (off 16-byte alignment
        # unless 4K is a multiple of 16)
        for c, b in ((conc[:G].clone(), bounds[:G].clone()),
                     (conc[1:], bounds[1:])):
            same([t_msc.msc_select(c, b)], [t_msc.msc_select_plain(c, b)])

    for C, D, n in ((1, 4, 7), (5, 3, 0), (44, 5, 100_000), (9000, 6, 5000)):
        ids = torch.randperm(1 << 20, generator=g)[:C].sort().values
        ids = ids.to(torch.int32)
        anc = torch.randint(-1, 1 << 20, (C, D), generator=g, dtype=torch.int32)
        q = torch.randint(0, 1 << 20, (n,), generator=g, dtype=torch.int32)
        q[: n // 2] = ids[torch.randint(0, C, (n // 2,), generator=g)]
        if n >= 2:
            q[-2:] = torch.tensor([-1, inv], dtype=torch.int32)
        args = (q.to(dev), ids.to(dev), anc.to(dev))
        same([t_ce.closure_expand(*args)], [t_ce.closure_expand_plain(*args)])
    for args in closure_expand_edges(dev):
        same([t_ce.closure_expand(*args)], [t_ce.closure_expand_plain(*args)])


@pytest.mark.cuda
def test_cuda_compact_mask_and_pair_range_edges():
    """K1's single-pass compaction and K3's range entry equal their plain
    versions, bit for bit, at their edges: n = 0, ragged heads from views at
    offsets 1-15, caps under the total, every row and no row set, 2**24 + 3
    rows (2,049 look-back tiles of 8,192 rows); tables of 1 row, of 2,048
    rows (all staged), just over and strided, probes below and above every
    key, duplicate keys, qlo = INT32_MAX.  Kernels launch on PyTorch's current stream, whose raw
    pointer ``build.stream`` reads (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    assert t_build.stream(dev) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert t_build.stream(dev) == side.cuda_stream
    g = torch.Generator().manual_seed(3)
    inv, imin = 2**31 - 1, -2**31

    def same(got, want):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)

    big = (torch.rand((1 << 24) + 3 + 15, generator=g) < 0.5).to(dev)
    cases = [(big[:0], 16), (big[:1], 1), (big[: (1 << 24) + 3], 1 << 24),
             (torch.ones(70_001, dtype=torch.bool, device=dev), 1 << 17),
             (torch.zeros(70_001, dtype=torch.bool, device=dev), 1 << 17)]
    cases += [(big[k:k + 9000 + k], 4096) for k in range(1, 16)]
    cases += [(big[k:k + 5], 8) for k in (3, 11)]  # head and tail in one
    for mask, cap in cases:
        for c in (cap, max(cap // 3, 1)):  # a cap under the total too
            same(t_sc.compact_mask(mask, c), t_sc.compact_mask_plain(mask, c))

    rows = torch.randint(0, 40, (300_000, 3), generator=g, dtype=torch.int32)
    rows = rows[torch.sort(rows[:, 1].long() * 64 + rows[:, 0], stable=True).indices]
    rows = rows.to(dev)  # duplicate (hi, lo) keys throughout
    qh = torch.randint(-2, 43, (5000,), generator=g, dtype=torch.int32)
    ql = torch.randint(-2, 43, (5000,), generator=g, dtype=torch.int32)
    qh[:50], ql[50:100], ql[100:150] = inv, inv, imin
    qh, ql = qh.to(dev), ql.to(dev)
    for T in (1, 2, 2047, 2048, 2049, 137_457, 300_000):
        args = (rows[:T, 1], rows[:T, 0], qh, ql)
        same(t_ps.pair_range(*args), t_ps.pair_range_plain(*args))
        same([t_ps.pair_search(*args)], [t_ps.pair_search_plain(*args)])


def _dev_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_batched_compactions_match_plain():
    """The batched look-back compactions (K1, K2, K4 with a member axis)
    equal their plain versions (the solo plain version per member), bit for
    bit, at the shared edges of ``kernel_edges``: B = 1, 2, 3 and the
    group boundaries 15, 16, 17, 33; n = 0, 1, 8,191, 8,192, 8,193,
    2**21 + 3; cap = 0, 1, n, n + 5; members all false, all true and
    differing (masks off 16 bytes, K2 bounds differing in every field,
    inverted, empty and full-range, alive partly false, K4 sets past the
    staged 2,048 and groups past the staging budget)."""
    dev = _dev_or_skip()
    for mask, cap in compact_mask_batched_edges(dev):
        _same(t_sc.compact_mask_batched(mask, cap),
              t_sc.compact_mask_batched_plain(mask, cap))
    for args in masked_interval_batched_edges(dev):
        _same(t_sc.masked_interval_compact_batched(*args),
              t_sc.masked_interval_compact_batched_plain(*args))
    for args in member_batched_edges(dev):
        _same(_flat(t_sc.member_compact_batched(*args)),
              _flat(t_sc.member_compact_batched_plain(*args)))


@pytest.mark.cuda
def test_cuda_group_kernel_reads_the_store_once_per_group():
    """The batched K2 and K4 run one CTA per (group of up to 16 members,
    tile of 8,192 rows), counted by the launch's ticket; the batched K1 one
    per (member, tile) (needs a card)."""
    dev = _dev_or_skip()
    n, tiles = 3 * 8192 + 5, 4
    g = torch.Generator().manual_seed(6)
    rows = torch.randint(0, 64, (n, 3), generator=g, dtype=torch.int32).to(dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for b in (1, 15, 16, 17, 33):
        groups = -(-b // 16)
        params = torch.tensor([[0, 32, 0, 64]] * b, dtype=torch.int32,
                              device=dev)
        got = t_sc.masked_interval_compact_batched(rows[:, 1], rows[:, 2],
                                                   alive, params, 64)
        assert t_sc.launched_ctas(got[0], 1) == groups * tiles
        sets = torch.full((b, 8), 2**31 - 1, dtype=torch.int32, device=dev)
        sets[:, 0] = torch.arange(b, dtype=torch.int32, device=dev)
        got = t_sc.member_compact_batched(rows[:, 0], rows[:, 1], rows[:, 2],
                                          alive, 3, sets, sets, sets, True,
                                          True, 64)
        assert t_sc.launched_ctas(got[0][0], 2) == groups * tiles
        mask = (torch.rand((b, n), generator=g) < 0.5).to(dev)
        got = t_sc.compact_mask_batched(mask, 64)
        assert t_sc.launched_ctas(got[0], 1) == b * tiles


@pytest.mark.cuda
def test_cuda_batched_ops_are_one_launch():
    """Each batched ``ops`` entry is one launch of its batched wrapper and
    bumps one pass, whatever B (needs a card)."""
    dev = _dev_or_skip()
    g = torch.Generator().manual_seed(5)
    rows = torch.randint(0, 64, (50_000, 3), generator=g,
                         dtype=torch.int32).to(dev)
    alive = torch.ones(50_000, dtype=torch.bool, device=dev)
    mask = (torch.rand((16, 50_000), generator=g) < 0.5).to(dev)
    params = torch.tensor([[0, 32, 0, 64]] * 16, dtype=torch.int32,
                          device=dev)
    sets = torch.full((16, 8), 2**31 - 1, dtype=torch.int32, device=dev)
    sets[:, 0] = torch.arange(16, dtype=torch.int32, device=dev)
    calls = (
        (lambda: t_ops.compact_indices_batched(mask, 4096),
         t_sc.compact_mask_batched, "compact"),
        (lambda: t_ops.masked_interval_compact_batched(
            rows[:, 1], rows[:, 2], alive, params, 4096),
         t_sc.masked_interval_compact_batched, "compact"),
        (lambda: t_ops.rewrite_member_compact_batched(
            rows, alive, 3, sets, sets, sets, 4096, True, True),
         t_sc.member_compact_batched, "member_compact"),
    )
    for call, wrapper, kind in calls:
        t_ops.reset_pass_counters()
        before = wrapper.launches
        out = call()
        torch.cuda.synchronize()
        assert wrapper.launches - before == 1
        assert t_ops.pass_counters[kind] == 1
        assert sum(t_ops.pass_counters.values()) == 1
        assert out[0].shape == (16, 4096)


@pytest.mark.cuda
def test_cuda_kernels_launch_on_a_second_device():
    """With ``cuda:0`` current on the calling thread and the tensors on the
    last card, every kernel of the sharded path
    (``kernel_edges.sharded_path_edges``: K1, K2 and K4 solo and batched —
    the batched K2's and K4's large shared memory is opted into per device
    — K3's range entry and K5/K6) and K11 (its grid sized for the device)
    launches there, equals its plain version bit for bit and counts its
    launch under that device; the thread's device stays ``cuda:0`` (needs
    two cards)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a shard per card")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    t_build.DEVICE_LAUNCHES.clear()
    names = set()
    for name, run, plain in sharded_path_edges(dev):
        _same(run(), plain())
        names.add(name)
    for args in closure_expand_edges(dev):
        _same([t_ce.closure_expand(*args)], [t_ce.closure_expand_plain(*args)])
    assert torch.cuda.current_device() == 0
    assert {n for n, index in t_build.DEVICE_LAUNCHES
            if index == dev.index} == names | {"closure_expand"}
    assert not any(index == 0 for _, index in t_build.DEVICE_LAUNCHES)
