"""Port parity, the kernel API's last five kernels: ``interval_filter``
(K9), ``msc_select`` (K10), ``closure_expand`` (K11), ``interval_compact``
(K8) and ``dual_compact_indices`` (K7) in ``kernels/ops.py``, their
wrappers and ``ref`` oracles, and ``core/query.py::_dual_masked_compact_both``
against the JAX package.

The cases mirror tests/test_kernels.py.  Most compare with the reference's
pure-jnp ``ref_*`` oracles; one or two per kernel run the reference's
``ops`` wrapper (its Pallas kernel in interpret mode), whose compiles are
the expensive part.  Inputs are made with numpy from a seed.  Every output
is an integer or a bool: the tolerance is zero.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.core import query as j_query
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core import query as t_query
from repro_torch.core.engine import KnowledgeBase
from repro_torch.core.query import Pattern
from repro_torch.core.tbox import RDF_TYPE, Ontology
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import stream_compact as t_sc
from repro_torch.kernels.stream_compact import member_masks
from repro_torch.rdf.generator import generate_random_abox
from repro_torch.testing import kernel_edges as ke
from repro_torch.testing.kernel_edges import (
    BATCH_B, CLOSURE_C, CLOSURE_D, closure_expand_edges,
    compact_mask_batched_edges, masked_interval_batched_edges,
    member_batched_edges,
)

from test_torch_delta import _disjoint_delta, _spec
from test_torch_kernels import _eq, _padded

torch.set_num_threads(2)
I32_MAX = np.iinfo(np.int32).max


def _cols(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1000, n).astype(np.int32),
            rng.integers(0, 1 << 20, n).astype(np.int32))


@pytest.mark.parametrize("n", [0, 1, 100, 4096, 5000])
def test_interval_filter_matches_reference(n):
    p, o = _cols(n, seed=n)
    params = (100, 300, 0, 1 << 19)
    got = t_ops.interval_filter(torch.as_tensor(p), torch.as_tensor(o), params)
    want = j_ref.ref_interval_filter(None, jnp.asarray(p), jnp.asarray(o),
                                     *params, 0)
    assert got.dtype == torch.bool
    _eq(got, want)
    _eq(t_ref.ref_interval_filter(None, torch.as_tensor(p), torch.as_tensor(o),
                                  *params, 0), want)
    if n == 100:  # the reference's own wrapper (interpret mode), once
        _eq(got, j_ops.interval_filter(jnp.asarray(p), jnp.asarray(o),
                                       jnp.asarray(params, jnp.int32)))


def _msc_inputs(g, k, seed, hi=500, width=64):
    rng = np.random.default_rng(seed)
    conc = rng.integers(-1, hi, (g, k)).astype(np.int32)
    bounds = conc + rng.integers(1, width, (g, k)).astype(np.int32)
    return conc, bounds


@pytest.mark.parametrize("G,K", [(0, 4), (1, 4), (37, 16), (130, 8), (64, 33)])
def test_msc_select_matches_reference(G, K):
    conc, bounds = _msc_inputs(G, K, seed=G * 100 + K)
    got = t_ops.msc_select(torch.as_tensor(conc), torch.as_tensor(bounds))
    want = j_ref.ref_msc_select(jnp.asarray(conc), jnp.asarray(bounds))
    assert got.dtype == torch.bool and got.shape == (G, K)
    _eq(got, want)
    if (G, K) == (37, 16):  # the reference's own wrapper, once
        _eq(got, j_ops.msc_select(jnp.asarray(conc), jnp.asarray(bounds)))


@given(st.integers(1, 12), st.integers(2, 24), st.integers(0, 2**31 - 2))
@settings(max_examples=25, deadline=None)
def test_msc_select_property(g, k, seed):
    """The reference sees the input -1 padded to one (12, 24) shape, so its
    eager ops compile once; -1 slots are invalid and drop nothing."""
    conc, bounds = _msc_inputs(g, k, seed, hi=100, width=32)
    got = t_ops.msc_select(torch.as_tensor(conc), torch.as_tensor(bounds))
    pc, pb = (np.pad(a, ((0, 12 - g), (0, 24 - k)), constant_values=-1)
              for a in (conc, bounds))
    want = j_ref.ref_msc_select(jnp.asarray(pc), jnp.asarray(pb))
    _eq(got, np.asarray(want)[:g, :k])


@pytest.mark.parametrize("C,D,n", [(5, 3, 0), (1, 4, 7), (5, 3, 10),
                                   (64, 8, 2048), (513, 5, 100),
                                   (44, 1, 257), (44, 9, 101), (44, 16, 4),
                                   (44, 17, 5), (44, 32, 3), (44, 33, 257),
                                   (8193, 8, 1000)])
def test_closure_expand_matches_reference(C, D, n):
    rng = np.random.default_rng(C * 10 + n)
    sorted_ids = np.sort(rng.choice(1 << 20, C, replace=False)).astype(np.int32)
    anc = rng.integers(-1, 1 << 20, (C, D)).astype(np.int32)
    q = rng.integers(0, 1 << 20, n).astype(np.int32)
    q[: n // 2] = sorted_ids[rng.integers(0, C, n // 2)]  # hits
    if n >= 2:
        q[-2:] = (-1, I32_MAX)  # never ids: misses
    args_t = tuple(map(torch.as_tensor, (q, sorted_ids, anc)))
    args_j = tuple(map(jnp.asarray, (q, sorted_ids, anc)))
    got = t_ops.closure_expand(*args_t)
    want = j_ref.ref_closure_expand(*args_j)
    assert got.dtype == torch.int32 and got.shape == (n, D)
    _eq(got, want)
    _eq(t_ref.ref_closure_expand(*args_t), want)
    if (C, D, n) == (5, 3, 10):  # the reference's own wrapper, once
        _eq(got, j_ops.closure_expand(*args_j))


def test_closure_expand_edges_match_reference():
    """The card's K11 edge inputs (``kernel_edges.closure_expand_edges``) at
    n = 257, through the port's entry point on the CPU, equal the
    reference's ``ref_closure_expand``: every C and D the card test covers,
    views 0-3 ids in."""
    seen = set()
    for q, ids, anc in closure_expand_edges("cpu"):
        if q.shape[0] != 257:
            continue
        seen.add((ids.shape[0], anc.shape[1], q.storage_offset()))
        _eq(t_ops.closure_expand(q, ids, anc),
            j_ref.ref_closure_expand(*(jnp.asarray(t.numpy())
                                       for t in (q, ids, anc))))
    assert len(seen) == len(CLOSURE_C) * len(CLOSURE_D) * 4


@pytest.mark.parametrize("n", [0, 5, 513, 4096])
def test_interval_compact_matches_reference(n):
    rng = np.random.default_rng(n)
    p = rng.integers(0, 100, n).astype(np.int32)
    o = rng.integers(0, 1 << 20, n).astype(np.int32)
    params = (10, 40, 0, 1 << 19)
    hit = np.asarray(j_ref.ref_interval_filter(None, jnp.asarray(p),
                                               jnp.asarray(o), *params, 0))
    for block in (512, 4096):
        local, counts = t_sc.interval_tiles(torch.as_tensor(p),
                                            torch.as_tensor(o), params, block)
        want_l, want_c = j_ref.ref_stream_compact(
            jnp.asarray(_padded(hit, block, False)), block)
        _eq(local, want_l)
        _eq(counts, want_c)
    t_ops.reset_pass_counters()
    take, ok, total = t_ops.interval_compact(torch.as_tensor(p),
                                             torch.as_tensor(o), params, 256)
    assert t_ops.pass_counters["compact"] == 1
    assert [t.dtype for t in (take, ok, total)] == [torch.int32, torch.bool,
                                                     torch.int32]
    want = np.flatnonzero(hit)
    assert int(total) == len(want)
    _eq(take[ok], want[:256])
    if n == 513:  # the reference's own wrapper, once
        for g, w in zip((take, ok, total), j_ops.interval_compact(
                jnp.asarray(p), jnp.asarray(o),
                jnp.asarray(params, jnp.int32), 256)):
            _eq(g, w)


@pytest.mark.parametrize("block", [512, 1024, 4096])
@pytest.mark.parametrize("da,db", [(0.0, 0.0), (0.2, 0.9), (1.0, 1.0),
                                   (0.0, 1.0)])
def test_dual_compact_tiles_match_reference_oracle(block, da, db):
    rng = np.random.default_rng(block + int(10 * da) + int(100 * db))
    n = 2 * block + block // 3  # a ragged last tile
    ma, mb = rng.random(n) < da, rng.random(n) < db
    got = t_sc.dual_compact_tiles_plain(torch.as_tensor(ma),
                                        torch.as_tensor(mb), block)
    want = j_ref.ref_dual_compact(jnp.asarray(_padded(ma, block, False)),
                                  jnp.asarray(_padded(mb, block, False)), block)
    assert len(got) == 2
    for g, w in zip([t for s in got for t in s], want):
        _eq(g, w)
    for g, w in zip(t_ref.ref_dual_compact(torch.as_tensor(ma),
                                           torch.as_tensor(mb), block), want):
        _eq(g, w)


@pytest.mark.parametrize("cap", [16, 1 << 12])
def test_dual_compact_indices_matches_reference(cap):
    rng = np.random.default_rng(3)
    n = 3000
    ma, mb = rng.random(n) < 0.15, rng.random(n) < 0.6
    t_ops.reset_pass_counters()
    got = t_ops.dual_compact_indices(torch.as_tensor(ma), torch.as_tensor(mb),
                                     cap)
    assert t_ops.pass_counters["dual_compact"] == 1
    want = j_ops.dual_compact_indices(jnp.asarray(ma), jnp.asarray(mb), cap)
    assert [g.dtype for g in got] == [torch.int32, torch.bool, torch.int32] * 2
    for g, w in zip(got, want):
        _eq(g, w)
    empty = np.zeros(0, bool)  # n = 0: one all-padding tile per stream
    got = t_sc.dual_compact_tiles_plain(torch.as_tensor(empty),
                                        torch.as_tensor(empty), 512)
    want = j_ref.ref_dual_compact(*[jnp.asarray(_padded(empty, 512, False))] * 2,
                                  512)
    for g, w in zip([t for s in got for t in s], want):
        _eq(g, w)
    take_a, ok_a, tot_a, take_b, ok_b, tot_b = t_ops.dual_compact_indices(
        torch.as_tensor(empty), torch.as_tensor(empty), cap)
    assert int(tot_a) == int(tot_b) == 0 and not (ok_a.any() or ok_b.any())


@pytest.mark.parametrize("case,cap", [
    ("fresh", 0), ("fresh", 16), ("fresh", 1 << 12), ("views", 16),
    ("views", 1 << 12), ("empty", 16)])
def test_dual_compact_matches_reference(case, cap):
    """K7's single-pass wrapper ``stream_compact.dual_compact`` (its plain
    version here) and ``ops.dual_compact_indices`` equal the reference's
    ``ops.dual_compact_indices`` (its Pallas kernel in interpret mode): cap
    0, a total over cap (16), a cap over it (4,096), n = 0, and views at
    different offsets (``m[1:]`` beside ``m[3:]``, which the kernel reads
    at different alignments).  The 3,000-row cases at caps 16 and 4,096
    reuse the reference's compiles of the test above."""
    rng = np.random.default_rng(3)
    n = 0 if case == "empty" else 3000
    base_a, base_b = rng.random(n + 3) < 0.15, rng.random(n + 3) < 0.6
    if case == "views":
        ma, mb = torch.as_tensor(base_a)[1:n + 1], torch.as_tensor(base_b)[3:]
    else:
        ma, mb = torch.as_tensor(base_a[:n]), torch.as_tensor(base_b[:n])
    want = j_ops.dual_compact_indices(jnp.asarray(ma.numpy()),
                                      jnp.asarray(mb.numpy()), cap)
    streams = t_sc.dual_compact(ma, mb, cap)
    assert len(streams) == 2
    t_ops.reset_pass_counters()
    got = t_ops.dual_compact_indices(ma, mb, cap)
    assert t_ops.pass_counters["dual_compact"] == 1
    assert [g.dtype for g in got] == [torch.int32, torch.bool, torch.int32] * 2
    for g, s, w in zip(got, [t for st in streams for t in st], want):
        _eq(g, w)
        _eq(s, w)
    if cap == 16 and n:
        assert int(got[2]) > cap and int(got[5]) > cap


def test_dual_masked_compact_both_matches_reference():
    """Base + delta stitching of both rewrite branches, on a small random
    store with an insert's delta bucket."""
    onto = Ontology(**_spec())
    raw = generate_random_abox(onto, n_instances=120, n_type_triples=180,
                               n_prop_triples=150, seed=5)
    kb = KnowledgeBase.build(raw, device="cpu")
    kb.insert(_disjoint_delta(onto, seed=9), auto_compact=False)
    ds = kb.view("rewrite").dev("scan")
    assert ds.delta is not None and ds.delta.shape[0] > 0
    # ?x rdf:type C0: every concept subsumed, p0's (and p1's) domain and
    # p3's range entail it, so both branches match rows
    eng = kb.engine("rewrite")
    sig, dyn, _ = eng._lower(*eng._prepare([Pattern("?x", RDF_TYPE, "C0")])[0])
    assert sig.extra_caps[2:] == (True, True)
    tid, mem, dom, rng = dyn["tid"], dyn["o"], dyn["dom"], dyn["rng"]
    masks = []
    for spo, alive in ((ds.base, ds.base_alive), (ds.delta, ds.delta_alive)):
        masks += member_masks(spo[:, 0], spo[:, 1], spo[:, 2], alive, tid,
                              mem, dom, rng, True, True)
    ms_b, mo_b, ms_d, mo_d = masks
    assert all(int(m.sum()) > 0 for m in masks)
    cap = 256
    t_ops.reset_pass_counters()
    got = t_query._dual_masked_compact_both(ds, ms_b, mo_b, ms_d, mo_d, cap)
    assert t_ops.pass_counters["dual_compact"] == 2

    class _DS:  # the reference reads only the base's row count
        base = jnp.zeros((ds.base.shape[0], 3), jnp.int32)

    want = j_query._dual_masked_compact_both(
        _DS, *(jnp.asarray(m.numpy()) for m in masks), cap)
    for g3, w3 in zip(got, want):
        for g, w in zip(g3, w3):
            _eq(g, w)
    # delta-free: one dual pass, no stitch
    got = t_query._dual_masked_compact_both(ds, ms_b, mo_b, None, None, cap)
    want = j_query._dual_masked_compact_both(
        _DS, jnp.asarray(ms_b.numpy()), jnp.asarray(mo_b.numpy()), None, None,
        cap)
    for g3, w3 in zip(got, want):
        for g, w in zip(g3, w3):
            _eq(g, w)


def test_group_split_and_staging_budget():
    """The group split and the staging budget on the host: the batched
    edges straddle the group kernel's GROUP members, ``kernel_edges``' copy
    of its staging rule stages as many leading members' sets as the budget
    holds (sets past STAGE_MAX ids never), and ``launched_ctas`` reads the
    ticket where the entry's scratch argument puts it."""
    G, most = ke.GROUP, ke.STAGE_MAX
    assert {G - 1, G, G + 1, 2 * G + 1} <= set(BATCH_B)
    assert ke.staged_members([8, 16, 16]) == ke.staged_members([8]) == G
    per = 4 * (most + 32)
    assert ke.staged_members([most, 16, 16]) == ke.STAGE_BYTES // per < G
    assert ke.staged_members([3 * most] * 3) == G  # none staged
    assert ke.staged_members([2 * most, 16, 16]) == G
    assert ke.staged_members([most] * 3) == 2
    cpu = torch.device("cpu")
    for streams in (1, 2):
        for members in (None, 1, 2 * G + 1):
            for n, cap in ((0, 0), (1, 5), (3 * 8192 + 1, 4097)):
                args, outs = t_sc._lookback_outputs(cpu, streams, n, cap,
                                                    members)
                at, scratch = args[1], args[4]
                ends = [t.data_ptr() + t.numel() * t.element_size()
                        for triple in outs for t in triple]
                assert scratch % 8 == 0 and scratch >= max(ends)
                assert scratch + 8 * args[5] <= at + args[6]
                take = outs[0][0]
                buf = torch.empty(0, dtype=torch.int64).set_(
                    take.untyped_storage())
                buf[(scratch - at) // 8] = 12345 + n
                assert t_sc.launched_ctas(take, streams) == 12345 + n


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _well_formed_set(ids):
    b, k = ids.shape
    assert ids.dtype == torch.int32 and ids.is_contiguous()
    assert k > 0 and k & (k - 1) == 0
    real = ids != I32_MAX
    assert torch.equal(real, real.cummin(1).values)  # padding only behind
    assert bool((ids[:, 1:] >= ids[:, :-1]).all())


def test_batched_edges_are_well_formed_and_per_member():
    """The card's batched edges (``kernel_edges``) at small n through the
    batched wrappers on the CPU (their plain versions): every case is well
    formed, and each member's outputs equal the solo wrapper's on that
    member.  Among them: B at the batched K2/K4 group boundaries, K2
    members whose bounds differ in every field, and K4 groups past the
    staging budget (some members' sets staged, the others' not)."""
    ns = (0, 1, 37)
    seen = set()
    for mask, cap in compact_mask_batched_edges("cpu", ns=ns):
        b, n = mask.shape
        assert mask.dtype == torch.bool and (n <= 1 or mask.stride(1) == 1)
        got = t_sc.compact_mask_batched(mask, cap)
        assert got[0].shape == got[1].shape == (b, cap)
        for m in range(b):
            _same([t[m] for t in got], t_sc.compact_mask(mask[m], cap))
        seen.add(b)
    assert seen == set(BATCH_B)
    every_field = False
    for p, o, alive, params, cap in masked_interval_batched_edges("cpu",
                                                                  ns=ns):
        n, b = p.shape[0], params.shape[0]
        assert p.dtype == o.dtype == torch.int32 and p.stride() == o.stride()
        assert alive.dtype == torch.bool and alive.shape == (n,)
        assert params.dtype == torch.int32 and params.shape == (b, 4)
        every_field |= any(bool((params[i] != params[j]).all())
                           for i in range(b) for j in range(i))
        got = t_sc.masked_interval_compact_batched(p, o, alive, params, cap)
        for m in range(b):
            _same([t[m] for t in got], t_sc.masked_interval_compact(
                p, o, alive, params[m].tolist(), cap))
    assert every_field
    mixed = False
    for args in member_batched_edges("cpu", ns=ns):
        s, p, o, alive, tid, mem, dom, rng, hd, hr, cap = args
        n, b = s.shape[0], mem.shape[0]
        assert s.stride() == p.stride() == o.stride() and s.shape == (n,)
        assert dom.shape[0] == rng.shape[0] == b
        for ids in (mem, dom, rng):
            _well_formed_set(ids)
        widths = [mem.shape[1]] + [t.shape[1] for t, on in ((dom, hd),
                                                            (rng, hr)) if on]
        mixed |= b > ke.GROUP and 0 < ke.staged_members(widths) < \
            ke.GROUP and bool((mem[:, 0] != I32_MAX).any())
        got = t_sc.member_compact_batched(*args)
        assert len(got) == (2 if hr else 1)
        for m in range(b):
            solo = t_sc.member_compact(s, p, o, alive, tid, mem[m], dom[m],
                                       rng[m], hd, hr, cap)
            for g3, w3 in zip(got, solo):
                _same([t[m] for t in g3], w3)
    assert mixed
