"""Port parity, kernels: each ported kernel's plain version against the JAX
package's Pallas kernel (interpret mode on the CPU, as its own tests run it)
and its ``ref`` oracle, plus the ops-level helpers around them.

On the CPU every wrapper runs its plain version, so these tests hold the
plain versions to the reference; tests/test_torch_cuda.py holds the CUDA
kernels to the plain versions where a card exists.  All outputs are
integer: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import query as j_query
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core import query as t_query
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import stream_compact as t_sc

torch.set_num_threads(2)
I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _mask(n, density, seed=0):
    return np.random.default_rng(seed).random(n) < density


def _padded(a, block, fill):
    n = a.shape[0]
    pad = block if n == 0 else (-n) % block  # an empty input is one tile
    return np.concatenate([a, np.full(pad, fill, a.dtype)])


@pytest.mark.parametrize("n", [0, 1, 511, 1300, 9000])
@pytest.mark.parametrize("block", [512, 4096])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_stream_compact_tiles_match_reference_oracle(n, block, density):
    m = _mask(n, density, seed=n)
    local, counts = t_sc.compact_tiles_plain(torch.as_tensor(m), block)
    want_l, want_c = j_ref.ref_stream_compact(jnp.asarray(_padded(m, block, False)),
                                              block)
    assert local.dtype == counts.dtype == torch.int32
    _eq(local, want_l)
    _eq(counts, want_c)
    assert t_ref.ref_stream_compact is t_sc.compact_tiles_plain

    # K2's single-pass compaction: the oracle's tiles, read in order, are
    # the global compaction; a cap of half the rows is under the total at
    # high density
    rng = np.random.default_rng(n + 1)
    p = rng.integers(0, 40, n).astype(np.int32)
    o = rng.integers(0, 40, n).astype(np.int32)
    alive = rng.random(n) < 0.8 if density else np.ones(n, bool)
    params = (5, 30, 10, I32_MAX)
    cap = n // 2 + 1
    got = t_sc.masked_interval_compact(
        torch.as_tensor(p), torch.as_tensor(o), torch.as_tensor(alive),
        params, cap)
    hit = (p >= 5) & (p < 30) & (o >= 10) & alive
    want_l, want_c = j_ref.ref_stream_compact(jnp.asarray(_padded(hit, block, False)),
                                              block)
    idx = np.asarray(want_l)[np.asarray(want_l) != I32_MAX]
    total = int(np.asarray(want_c).sum())
    take = np.zeros(cap, np.int32)
    take[:min(cap, total)] = idx[:cap]
    for g, w in zip(got, (take, np.arange(cap) < total, np.int32(total))):
        _eq(g, w)


@pytest.mark.parametrize("n,block,cap", [
    (0, 512, 256), (1300, 512, 1024), (9000, 4096, 256),
    # a 4,096-row tile of the single-pass kernel, one row short and over;
    # 0.3 of the rows are set (~1,229): caps below and above the total
    (4095, 512, 512), (4095, 4096, 2048), (4096, 4096, 512),
    (4096, 512, 2048), (4097, 4096, 512), (4097, 512, 2048)])
def test_compact_indices_match_reference_ops(n, block, cap):
    m = _mask(n, 0.3, seed=7)
    got = t_ops.compact_indices(torch.as_tensor(m), cap, block=block)
    want = j_ops.compact_indices(jnp.asarray(m), cap, block=block)
    assert [g.dtype for g in got] == [torch.int32, torch.bool, torch.int32]
    for g, w in zip(got, want):
        _eq(g, w)
    # the kernel's plain version is the contract, whatever the block
    for g, w in zip(t_sc.compact_mask_plain(torch.as_tensor(m), cap), want):
        _eq(g, w)

    rng = np.random.default_rng(n)
    rows = rng.integers(0, 30, (n, 3)).astype(np.int32)
    alive = rng.random(n) < 0.9
    params = (3, 17, I32_MIN, 25)
    tr = torch.as_tensor(rows)
    got = t_ops.masked_interval_compact(tr[:, 1], tr[:, 2], torch.as_tensor(alive),
                                        params, cap, block=block)
    want = j_ops.masked_interval_compact(
        jnp.asarray(rows[:, 1]), jnp.asarray(rows[:, 2]), jnp.asarray(alive),
        jnp.asarray(np.asarray(params, np.int32)), cap, block=block)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("n,cap", [(0, 8), (5000, 256)])
def test_masked_interval_compact_plain_matches_reference_ops(n, cap):
    """K2's plain version against the JAX ``ops.masked_interval_compact``
    (its Pallas kernel in interpret mode): an empty store, and a cap under
    the total."""
    rng = np.random.default_rng(n + 3)
    rows = rng.integers(0, 30, (n, 3)).astype(np.int32)
    alive = rng.random(n) < 0.9
    params = (3, 17, I32_MIN, 25)
    tr = torch.as_tensor(rows)
    got = t_sc.masked_interval_compact_plain(tr[:, 1], tr[:, 2],
                                             torch.as_tensor(alive), params, cap)
    want = j_ops.masked_interval_compact(
        jnp.asarray(rows[:, 1]), jnp.asarray(rows[:, 2]), jnp.asarray(alive),
        jnp.asarray(np.asarray(params, np.int32)), cap)
    assert n == 0 or int(want[2]) > cap
    assert [g.dtype for g in got] == [torch.int32, torch.bool, torch.int32]
    for g, w in zip(got, want):
        _eq(g, w)


def _sorted_table(rng, T, hi_range=50):
    hi = rng.integers(0, hi_range, T).astype(np.int32)
    lo = rng.integers(0, 1000, T).astype(np.int32)
    order = np.lexsort((lo, hi))
    return hi[order], lo[order]


@pytest.mark.parametrize("T,N", [(1, 7), (300, 1300), (5000, 64),
                                 (2048, 300), (2049, 300)])
def test_pair_search_matches_reference(T, N):
    rng = np.random.default_rng(T)
    hi, lo = _sorted_table(rng, T)
    qh = rng.integers(0, 52, N).astype(np.int32)
    ql = rng.integers(-5, 1005, N).astype(np.int32)
    qh[:3] = I32_MAX  # INVALID probes sort past every real key
    ql[3:6] = I32_MAX  # qlo + 1 wraps to INT32_MIN in the range entry
    ql[6] = I32_MIN
    got = t_ops.pair_search(*map(torch.as_tensor, (hi, lo, qh, ql)))
    assert got.dtype == torch.int32
    want = j_ops.pair_search(*map(jnp.asarray, (hi, lo, qh, ql)))
    _eq(got, want)
    # the range entry: the two searches an INL probe makes, in one call
    ql1 = (ql.astype(np.int64) + 1).astype(np.int32)  # wraps like int32 add
    starts, ends = t_ops.pair_range(*map(torch.as_tensor, (hi, lo, qh, ql)))
    assert starts.dtype == ends.dtype == torch.int32
    _eq(starts, want)
    _eq(ends, j_ops.pair_search(*map(jnp.asarray, (hi, lo, qh, ql1))))
    _eq(t_ref.ref_pair_search(*map(torch.as_tensor, (hi, lo, qh, ql))),
        j_ref.ref_pair_search(*map(jnp.asarray, (hi, lo, qh, ql))))
    empty = torch.zeros(0, dtype=torch.int32)
    _eq(t_ops.pair_search(empty, empty, torch.as_tensor(qh), torch.as_tensor(ql)),
        np.zeros(N, np.int32))
    for bound in t_ops.pair_range(empty, empty, torch.as_tensor(qh),
                                  torch.as_tensor(ql)):
        _eq(bound, np.zeros(N, np.int32))


@pytest.mark.parametrize("T,N,block", [(300, 7, 256), (2048, 2048, 512),
                                       (5000, 1300, 256)])
def test_pair_search_windowed_matches_reference(T, N, block):
    rng = np.random.default_rng(T + N)
    hi, lo = _sorted_table(rng, T)
    qh = rng.integers(0, 52, N).astype(np.int32)
    ql = rng.integers(-5, 1005, N).astype(np.int32)
    got = t_ops.pair_search_windowed(*map(torch.as_tensor, (hi, lo, qh, ql)),
                                     block=block)
    want = j_ops.pair_search_windowed(*map(jnp.asarray, (hi, lo, qh, ql)),
                                      block=block)
    assert got.dtype == torch.int32
    _eq(got, want)
    _eq(got, t_ops.pair_search(*map(torch.as_tensor, (hi, lo, qh, ql))))


@pytest.mark.parametrize("n,m,block,branch", [
    (5, 300, 512, "merge_resident"),
    (1500, 2000, 512, "merge_partitioned"),
    (700, 9, 1024, "merge_resident"),
    (0, 5, 512, None),
    (5, 0, 512, None),
])
def test_merge_gather_matches_reference(n, m, block, branch):
    rng = np.random.default_rng(n * 7 + m)
    b_hi, b_lo = _sorted_table(rng, m, hi_range=8)
    # half of A are exact copies of B keys: ties across the runs
    a_hi, a_lo = _sorted_table(rng, n, hi_range=8)
    k = min(n, m) // 2
    if k:
        pick = np.sort(rng.choice(m, k, replace=False))
        a_hi[:k], a_lo[:k] = b_hi[pick], b_lo[pick]
        order = np.lexsort((a_lo, a_hi))
        a_hi, a_lo = a_hi[order], a_lo[order]
    t_ops.reset_pass_counters()
    args = (a_hi, a_lo, b_hi, b_lo)
    got = t_ops.merge_gather(*map(torch.as_tensor, args), block=block)
    assert got.dtype == torch.int32
    _eq(got, j_ops.merge_gather(*map(jnp.asarray, args), block=block))
    _eq(t_ref.ref_merge_sorted(*map(torch.as_tensor, args)),
        j_ref.ref_merge_sorted(*map(jnp.asarray, args)))
    if branch is not None:
        assert t_ops.pass_counters[branch] == 1
        assert sum(t_ops.pass_counters.values()) == 1


def test_segment_positions_and_two_source_gather_match():
    rng = np.random.default_rng(3)
    starts = rng.integers(0, 500, 9).astype(np.int32)
    lens = rng.integers(0, 40, 9).astype(np.int32)
    for cap in (8, 256):
        got = t_ops.segment_positions(torch.as_tensor(starts),
                                      torch.as_tensor(lens), cap)
        want = j_ops.segment_positions(jnp.asarray(starts), jnp.asarray(lens), cap)
        assert [g.dtype for g in got] == [torch.int32, torch.bool, torch.int32,
                                          torch.int32]
        for g, w in zip(got, want):
            _eq(g, w)
    base = rng.integers(0, 99, (50, 3)).astype(np.int32)
    idx = rng.integers(-3, 60, 40).astype(np.int32)  # out of range: clamped
    _eq(t_ops.two_source_gather(torch.as_tensor(base), None, torch.as_tensor(idx)),
        j_ops.two_source_gather(jnp.asarray(base), None, jnp.asarray(idx)))


@pytest.mark.parametrize("resident_max", [1 << 20, 1500, 64])
def test_inl_ranges_either_side_of_resident_max(resident_max, monkeypatch):
    """INL probes match the reference whether the table takes the resident
    search (the range entry; 1500 = the table's size, still resident) or the
    windowed (merge-path) search."""
    monkeypatch.setattr(j_query, "INL_RESIDENT_MAX", resident_max)
    monkeypatch.setattr(t_query, "INL_RESIDENT_MAX", resident_max)
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 6, (1500, 3)).astype(np.int32)
    rows = rows[np.lexsort((rows[:, 2], rows[:, 0], rows[:, 1]))]  # PSO order
    k = 40
    valid = rng.random(2 * k) < 0.8
    qlo = np.where(valid, rng.integers(0, 7, 2 * k), 0).astype(np.int32)
    qhi = np.where(valid, np.repeat(np.asarray([2, 4], np.int32), k),
                   I32_MAX).astype(np.int32)
    qlo[np.flatnonzero(valid)[:2]] = I32_MAX  # a valid probe whose + 1 wraps
    want = j_query._inl_ranges(jnp.asarray(rows), 1, 0, jnp.asarray(qhi),
                               jnp.asarray(qlo), jnp.asarray(valid))
    t_ops.reset_pass_counters()
    got = t_query._inl_ranges(torch.as_tensor(rows), 1, 0, torch.as_tensor(qhi),
                              torch.as_tensor(qlo), torch.as_tensor(valid))
    for g, w in zip(got, want):
        _eq(g, w)
    # starts and ends: two windowed searches, each one partitioned merge
    windowed = rows.shape[0] > resident_max
    assert t_ops.pass_counters["merge_partitioned"] == (2 if windowed else 0)
