"""Conjunctive SPARQL evaluation over encoded triples — the paper's §V.

Three execution modes, matching the paper's Table VI columns:

  * ``litemat``  — interval predicates (one compare per sub-hierarchy) over
                   the lite-materialized store,
  * ``full``     — plain equality over the fully materialized store,
  * ``rewrite``  — the no-materialization baseline: constants expanded
                   host-side to their sub-concept/property id sets,
                   evaluated as OR-filters over the raw store.

The algebra is the paper's filter→map→join pipeline in the reference's
static-shape discipline: every operator carries a capacity + validity mask
+ overflow counter, and the engine re-executes with doubled capacities if
an overflow is reported (power-of-two buckets).  Eager torch would not need
fixed capacities; the port keeps them so that plans, explain() output and
overflow retries match the reference step for step.

Stores are *live*: the engine executes against a StoreView (core/delta.py)
— an immutable base plus a small delta overlay with tombstones.  Each view
key reaches the device as a base array and a power-of-two delta bucket,
addressed in combined [base | delta] coordinates; every pattern scans or
probes both sources and filters rows through their liveness bits.

Execution strategy per pattern (chosen host-side during planning):

  * ``slice`` — a litemat/full pattern with a pure-interval constant
    resolves against the sorted store permutations (core/index.py via the
    view): host binary searches yield contiguous row ranges, and the device
    work is one gather.  The range lengths give the planner cardinalities
    with zero device passes.
  * ``scan``  — residual patterns (rewrite mode, member sets, and the
    ``use_index=False`` path) stream the store once through the compaction
    kernels (kernels/stream_compact.py): simple interval predicates fuse
    the filter and the liveness mask into one pass, the rewrite type
    pattern its member-set searches; the compaction's total doubles as the
    match count.
  * ``inl``   — index-nested-loop: a tiny probe side binary-searches a
    sorted permutation (kernels/pair_search.py, or the merge-path kernel
    for tables past ``INL_RESIDENT_MAX`` rows).

Every (mode, pattern-signature, capacity-bucket) combination maps to ONE
plan body memoized in ``QueryEngine._exec_cache``; queries differing only
in constants share it, and ``cache_stats`` counts hits and misses as the
reference's plan cache does.

Beyond the paper (it declares join ordering out of scope): the planner joins
in ascending-cardinality order, which also gives capacity estimates.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.abox import EncodedKB
from repro_torch.core.delta import StoreView
from repro_torch.core.index import key_cols, pow2_bucket as _pow2
from repro_torch.core.materialize import DeviceTBox
from repro_torch.kernels import ops
from repro_torch.kernels.stream_compact import in_set as _in_set
from repro_torch.kernels.stream_compact import member_masks
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import REGISTRY
from repro_torch.utils.pair64 import pair_key

INVALID = int(np.iinfo(np.int32).max)
_I32_MIN = int(np.iinfo(np.int32).min)
_I32_MAX = int(np.iinfo(np.int32).max)


def is_var(t) -> bool:
    return isinstance(t, str) and t.startswith("?")


def sig_label(sigs) -> str:
    """Compact, stable metric label for a plan's signature tuple.

    ``"<n>p:<hex10>"`` — pattern count plus a 10-hex-digit blake2s digest
    of the PatternSig tuple's repr (identical across processes).
    """
    digest = hashlib.blake2s(repr(tuple(sigs)).encode(),
                             digest_size=5).hexdigest()
    return f"{len(sigs)}p:{digest}"


def _sync(device) -> None:
    """Wait for ``device``'s queued work (timers around device work)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass(frozen=True)
class Pattern:
    s: object  # '?var' | name str | raw int id
    p: object
    o: object


@dataclass
class Term:
    """A resolved pattern constant: interval [lo, hi) + optional spills/set."""

    lo: int
    hi: int
    spills: tuple = ()  # ((lo, hi), ...)
    members: np.ndarray | None = None  # explicit id set (rewrite mode)

    def intervals(self):
        return [(self.lo, self.hi)] + list(self.spills)


# ---------------------------------------------------------------------------
# Plan signatures vs per-query constants
#
# A query plan is split into a hashable *signature* — everything that shapes
# the computation — and a dict of constants (``dyn``).  Two queries with the
# same signature share one cached plan body regardless of their constants.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TermSig:
    kind: str  # 'interval' | 'members'
    n_spills: int = 0
    mem_cap: int = 0  # padded power-of-two member-set length


@dataclass(frozen=True)
class PatternSig:
    pvars: tuple  # per-position var name or None
    strategy: str  # 'slice' | 'scan' | 'inl'
    s_sig: TermSig | None = None
    p_sig: TermSig | None = None
    o_sig: TermSig | None = None
    store: str = "pos"  # slice/inl: which sorted permutation
    k: int = 1  # slice: number of contiguous ranges
    residual: tuple = ()  # slice/inl: positions re-checked after the gather
    # rewrite type pattern: (dom_cap, rng_cap, has_dom, has_rng) — the flags
    # select the kernel's branches, so empty domain/range sets cost nothing
    extra_caps: tuple | None = None
    fused: bool = False  # scan: predicate fused into the compaction kernel
    probe_pos: int = -1  # inl: pattern position the bound var probes (0|2)
    n_pids: int = 0  # inl: how many distinct store pids are probed


def _clip32(v) -> int:
    return int(np.clip(int(v), _I32_MIN, _I32_MAX))


def _pad_set(ids: np.ndarray, device):
    """Sorted id set -> (pow2 bucket, INT32_MAX-padded device tensor)."""
    cap = _pow2(len(ids))
    out = np.full(cap, _I32_MAX, np.int32)
    out[: len(ids)] = ids
    return cap, torch.as_tensor(out, device=device)


def _lower_term(t: Term | None, device):
    """Host Term -> (TermSig, constants) or (None, None): an interval's
    int32-clipped bounds tuple, or a member set as a padded device tensor."""
    if t is None:
        return None, None
    if t.members is not None:
        cap, mem = _pad_set(t.members, device)
        return TermSig("members", mem_cap=cap), mem
    vals = [_clip32(t.lo), _clip32(t.hi)]
    for lo, hi in t.spills:
        vals += [_clip32(lo), _clip32(hi)]
    return TermSig("interval", n_spills=len(t.spills)), tuple(vals)


def _term_mask_dyn(col, sig: TermSig, vals):
    """Per-column membership mask of a term: its member set, or its
    interval (+ spills)."""
    if sig.kind == "members":
        return _in_set(col, vals)
    m = (col >= vals[0]) & (col < vals[1])
    for i in range(sig.n_spills):
        m = m | ((col >= vals[2 + 2 * i]) & (col < vals[3 + 2 * i]))
    return m


def _pattern_const_key(terms):
    """Hashable snapshot of a pattern's resolved constants.

    The probe-constant half of the ``(PatternSig, bucket)`` selectivity
    key: two patterns lowering to the same signature but resolving
    different constants (Q3's Professors vs Q4's Chairs) get distinct
    buckets, so one's observation never aliases the other's plan.
    """
    return tuple(
        None if t is None else
        (t.lo, t.hi, t.spills,
         None if t.members is None else t.members.tobytes())
        for t in terms)


def _scan_mask(sig: PatternSig, spo, alive, dyn):
    """Full-store boolean mask for a scan pattern (non-fused path)."""
    s, p, o = spo[:, 0], spo[:, 1], spo[:, 2]
    mask = (s != INVALID) & alive
    for tsig, col, key in ((sig.s_sig, s, "s"), (sig.p_sig, p, "p"),
                           (sig.o_sig, o, "o")):
        if tsig is not None:
            mask = mask & _term_mask_dyn(col, tsig, dyn[key])
    return mask


# ---------------------------------------------------------------------------
# Relations: struct-of-arrays with validity + overflow accounting
# ---------------------------------------------------------------------------


@dataclass
class Relation:
    vars: tuple  # var names, host
    cols: torch.Tensor  # int32[n_vars, cap]
    valid: torch.Tensor  # bool[cap]
    overflow: torch.Tensor  # int32 scalar (rows that did not fit)

    def col(self, v) -> torch.Tensor:
        return self.cols[self.vars.index(v)]


def _overflow(total, cap: int):
    return (total - cap).clamp(min=0).to(torch.int32)


def _build_relation(pvars, s, p, o, ok, total, cap: int) -> Relation:
    """Assemble a Relation from gathered columns + validity.

    Repeated variables within one pattern become an equality constraint.
    """
    cols = []
    seen = {}
    eq = None
    for v, colv in zip(pvars, (s, p, o)):
        if v is None:
            continue
        if v in seen:  # repeated var in one pattern: equality constraint
            eq = (seen[v], colv)
            continue
        seen[v] = colv
        cols.append(colv)
    if eq is not None:
        ok = ok & (eq[0] == eq[1])
    cols = [torch.where(ok, c, INVALID) for c in cols]
    return Relation(
        vars=tuple(seen),
        cols=(torch.stack(cols) if cols else
              torch.zeros((0, cap), dtype=torch.int32, device=ok.device)),
        valid=ok,
        overflow=_overflow(total, cap),
    )


def _gather_ranges(ds, starts, lens, cap: int):
    """Concatenate k contiguous row ranges of a sorted view into [cap] rows.

    Dead rows keep their slot (totals stay exact range lengths for overflow
    accounting) but are invalidated before the relation is built.
    """
    src, ok, total, _ = ops.segment_positions(starts, lens, cap)
    rows = ops.two_source_gather(ds.base, ds.delta, src)
    alive = ops.two_source_gather(ds.base_alive, ds.delta_alive, src)
    return rows, ok & alive, total


def _stitch_compact(take_b, total_b, take_d, total_d, base_n: int, cap: int):
    """Fuse two per-source compactions into one combined-coordinate take.

    Base matches come first (base-store row indices as they are), delta
    matches follow offset by ``base_n`` — the addressing the range lookups
    use, so downstream gathers are shared with the slice path.
    """
    j = torch.arange(cap, dtype=torch.int64, device=take_b.device)
    use_b = j < total_b
    di = (j - total_b).clamp(0, cap - 1)
    take = torch.where(use_b, take_b, base_n + take_d[di])
    total = total_b + total_d
    return take, j < torch.clamp(total, max=cap), total


def _masked_compact_both(ds, mask_b, mask_d, cap: int):
    """Compact one mask per source and stitch into combined coordinates."""
    take_b, ok_b, tb = ops.compact_indices(
        mask_b, cap, block=ops.auto_block(mask_b.shape[0]))
    if mask_d is None:  # delta-free view: single-source plan
        return take_b, ok_b, tb
    take_d, _, td = ops.compact_indices(
        mask_d, cap, block=ops.auto_block(mask_d.shape[0]))
    return _stitch_compact(take_b, tb, take_d, td, ds.base.shape[0], cap)


def _dual_masked_compact_both(ds, ms_b, mo_b, ms_d, mo_d, cap: int):
    """Compact both rewrite branches of each source in one dual-mask pass.

    The subject-binding and object-binding masks cover the same rows, so
    one launch of the dual-mask kernel compacts both.  Returns
    the two stitched (take, ok, total) triples in combined [base | delta]
    coordinates.  No query path calls it: rewrite mode compacts through
    ``ops.rewrite_member_compact``, which evaluates the masks in the same
    pass.
    """
    take_s_b, ok_s_b, ts_b, take_o_b, ok_o_b, to_b = ops.dual_compact_indices(
        ms_b, mo_b, cap, block=ops.auto_block(ms_b.shape[0]))
    if ms_d is None:  # delta-free view
        return (take_s_b, ok_s_b, ts_b), (take_o_b, ok_o_b, to_b)
    take_s_d, _, ts_d, take_o_d, _, to_d = ops.dual_compact_indices(
        ms_d, mo_d, cap, block=ops.auto_block(ms_d.shape[0]))
    base_n = ds.base.shape[0]
    return (_stitch_compact(take_s_b, ts_b, take_s_d, ts_d, base_n, cap),
            _stitch_compact(take_o_b, to_b, take_o_d, to_d, base_n, cap))


def _rewrite_type_bindings(sig: PatternSig, ds, dyn, cap: int):
    """Rewrite-mode type pattern -> (ok, total, xcol of ?x bindings).

    Subject-binding rows (explicit/domain) and object-binding rows (range)
    are compacted independently per source by the member-compaction kernel
    and their bound values stitched: a row entailing the target through
    both branches yields two bindings.
    """
    _, _, has_dom, has_rng = sig.extra_caps
    mem, tid = dyn["o"], dyn["tid"]
    dom, rng = dyn["dom"], dyn["rng"]
    base_n = ds.base.shape[0]
    out_b = ops.rewrite_member_compact(
        ds.base, ds.base_alive, tid, mem, dom, rng, cap, has_dom, has_rng,
        block=ops.auto_block(base_n))
    out_d = None
    if ds.delta is not None:
        out_d = ops.rewrite_member_compact(
            ds.delta, ds.delta_alive, tid, mem, dom, rng, cap, has_dom,
            has_rng, block=ops.auto_block(ds.delta.shape[0]))
    take_s, ok_s, total_s = out_b[0:3]
    if out_d is not None:
        take_s, ok_s, total_s = _stitch_compact(
            out_b[0], out_b[2], out_d[0], out_d[2], base_n, cap)
    vals_s = ops.two_source_gather(ds.base, ds.delta, take_s)[:, 0]
    if not has_rng:  # no object branch: the subject stream is the answer
        return ok_s, total_s, vals_s
    take_o, total_o = out_b[3], out_b[5]
    if out_d is not None:
        take_o, _, total_o = _stitch_compact(
            out_b[3], out_b[5], out_d[3], out_d[5], base_n, cap)
    vals_o = ops.two_source_gather(ds.base, ds.delta, take_o)[:, 2]
    j = torch.arange(cap, dtype=torch.int64, device=vals_s.device)
    use_s = j < total_s
    vo = vals_o[(j - total_s).clamp(0, cap - 1)]
    xcol = torch.where(use_s, vals_s, vo)
    total = total_s + total_o
    return j < torch.clamp(total, max=cap), total, xcol


def _scan_compact(sig: PatternSig, ds, dyn, cap: int):
    """Scan both sources of a view key -> (take, ok, total)."""
    base_n = ds.base.shape[0]
    if sig.fused:
        pv, ov = dyn.get("p"), dyn.get("o")
        params = (pv[0] if pv is not None else _I32_MIN,
                  pv[1] if pv is not None else _I32_MAX,
                  ov[0] if ov is not None else _I32_MIN,
                  ov[1] if ov is not None else _I32_MAX)
        take_b, ok_b, tb = ops.masked_interval_compact(
            ds.base[:, 1], ds.base[:, 2], ds.base_alive, params, cap,
            block=ops.auto_block(base_n))
        if ds.delta is None:
            return take_b, ok_b, tb
        take_d, _, td = ops.masked_interval_compact(
            ds.delta[:, 1], ds.delta[:, 2], ds.delta_alive, params, cap,
            block=ops.auto_block(ds.delta.shape[0]))
        return _stitch_compact(take_b, tb, take_d, td, base_n, cap)
    mask_b = _scan_mask(sig, ds.base, ds.base_alive, dyn)
    mask_d = (None if ds.delta is None
              else _scan_mask(sig, ds.delta, ds.delta_alive, dyn))
    return _masked_compact_both(ds, mask_b, mask_d, cap)


def _eval_pattern(sig: PatternSig, cap: int, stores, dyn):
    """One pattern -> (Relation, match count)."""
    if sig.strategy == "slice":
        ds = stores[sig.store]
        g, ok, total = _gather_ranges(ds, dyn["starts"], dyn["lens"], cap)
        s, p, o = g[:, 0], g[:, 1], g[:, 2]
        for posi in sig.residual:
            tsig = (sig.s_sig, sig.p_sig, sig.o_sig)[posi]
            key = ("s", "p", "o")[posi]
            ok = ok & _term_mask_dyn((s, p, o)[posi], tsig, dyn[key])
        return _build_relation(sig.pvars, s, p, o, ok, total, cap), total

    ds = stores["scan"]
    if sig.extra_caps is not None:  # rewrite-mode type pattern (?x rdf:type C)
        ok, total, xcol = _rewrite_type_bindings(sig, ds, dyn, cap)
        var = next(v for v in sig.pvars if v is not None)
        rel = Relation(vars=(var,),
                       cols=torch.where(ok, xcol, INVALID)[None, :],
                       valid=ok, overflow=_overflow(total, cap))
        return rel, total
    take, ok, total = _scan_compact(sig, ds, dyn, cap)
    g = ops.two_source_gather(ds.base, ds.delta, take)
    return _build_relation(sig.pvars, g[:, 0], g[:, 1], g[:, 2], ok, total,
                           cap), total


# Above this many rows, INL probes take the windowed pair search (the
# merge-path reuse in kernels/ops.py) instead of the resident search.  The
# bound is the reference's dispatch — on the TPU the resident kernel keeps
# the table in VMEM — kept so the port runs the same kernels as the
# reference's path.
INL_RESIDENT_MAX = 1 << 20


def _inl_ranges(rows, prim: int, sec: int, qhi, qlo, valid):
    """Probe one source's key planes -> (starts, lens), all pids batched.

    The sorted permutation's key planes are two columns of its rows
    (core/index.py::key_cols), so the rows matching (pid, key) form a
    composite-key range — start at (pid, key), end at (pid, key + 1).
    Invalid probe rows get zero-length ranges.
    """
    t_hi, t_lo = rows[:, prim], rows[:, sec]
    if rows.shape[0] > INL_RESIDENT_MAX:
        starts = ops.pair_search_windowed(t_hi, t_lo, qhi, qlo)
        ends = ops.pair_search_windowed(t_hi, t_lo, qhi, qlo + 1)
    else:  # both bounds in one launch
        starts, ends = ops.pair_range(t_hi, t_lo, qhi, qlo)
    lens = torch.where(valid, (ends - starts).clamp(min=0), 0)
    return starts, lens


def _eval_inl(sig: PatternSig, cap: int, stores, dyn, rel: Relation):
    """Index-nested-loop join: probe a sorted store with the current relation.

    Returns (joined Relation, match count) — the count is the expanded hit
    total before capacity clipping.  Each bound value of the shared
    variable probes the pattern's composite-key permutation (PSO for a
    subject probe, POS for an object probe); the hit ranges expand through
    one segment mapping, and every output row carries its probe row's
    bindings plus the pattern's newly bound columns.
    """
    ds = stores[sig.store]
    prim, sec = key_cols(sig.store)
    var = sig.pvars[sig.probe_pos]
    probe = rel.col(var)
    k = probe.shape[0]
    pid_arr = dyn["pid"]  # int32[n_pids] — distinct store ids in the interval
    qlo1 = torch.where(rel.valid, probe, 0)  # avoid key+1 overflow on INVALID
    # one probe batch per pid, concatenated: [pid0 x k, pid1 x k, ...]
    valid = rel.valid.repeat(sig.n_pids)
    qlo = qlo1.repeat(sig.n_pids)
    qhi = torch.where(valid, pid_arr.repeat_interleave(k), INVALID)
    starts, lens = _inl_ranges(ds.base, prim, sec, qhi, qlo, valid)
    if ds.delta is not None:  # probe the delta bucket too, offset past base
        st_d, ln_d = _inl_ranges(ds.delta, prim, sec, qhi, qlo, valid)
        starts = torch.cat([starts, st_d + ds.base.shape[0]])
        lens = torch.cat([lens, ln_d])
    src, ok, total, seg = ops.segment_positions(starts, lens, cap)
    rows = ops.two_source_gather(ds.base, ds.delta, src)
    alive = ops.two_source_gather(ds.base_alive, ds.delta_alive, src)
    ok = ok & alive
    probe_row = seg.long() % k  # every segment group is one probe batch

    s, p, o = rows[:, 0], rows[:, 1], rows[:, 2]
    for posi in sig.residual:  # constant terms re-checked on the hit rows
        tsig = (sig.s_sig, sig.p_sig, sig.o_sig)[posi]
        key = ("s", "p", "o")[posi]
        ok = ok & _term_mask_dyn((s, p, o)[posi], tsig, dyn[key])

    carried = rel.cols[:, probe_row]  # probe bindings ride along
    out_vars = list(rel.vars)
    out_cols = [carried[i] for i in range(len(rel.vars))]
    seen = dict(zip(rel.vars, out_cols))
    for v, colv in zip(sig.pvars, (s, p, o)):
        if v is None:
            continue
        if v in seen:  # shared var: probe key (equal by construction) or
            ok = ok & (seen[v] == colv)  # a repeated var inside the pattern
            continue
        seen[v] = colv
        out_vars.append(v)
        out_cols.append(colv)
    out_cols = [torch.where(ok, c, INVALID) for c in out_cols]
    return Relation(
        vars=tuple(out_vars),
        cols=torch.stack(out_cols),
        valid=ok,
        overflow=rel.overflow + _overflow(total, cap),
    ), total


def _lower_scan(pvars, terms, extra, mode: str, device):
    """Lower one pattern to a scan signature + constants."""
    s_sig, s_dyn = _lower_term(terms[0], device)
    p_sig, p_dyn = _lower_term(terms[1], device)
    o_sig, o_dyn = _lower_term(terms[2], device)
    dyn = {}
    if s_dyn is not None:
        dyn["s"] = s_dyn
    if p_dyn is not None:
        dyn["p"] = p_dyn
    if o_dyn is not None:
        dyn["o"] = o_dyn
    if extra is not None:
        tid, dom, rng = extra
        dom_cap, dom_arr = _pad_set(dom, device)
        rng_cap, rng_arr = _pad_set(rng, device)
        dyn.update(tid=int(tid), dom=dom_arr, rng=rng_arr)
        return PatternSig(
            pvars=pvars, strategy="scan", o_sig=o_sig,
            extra_caps=(dom_cap, rng_cap, bool(len(dom)), bool(len(rng))),
        ), dyn
    # litemat/full stores are compacted (no INVALID rows), so pure-interval
    # predicates on p/o can fuse into the compaction kernel's one pass
    fused = (
        mode in ("litemat", "full")
        and s_sig is None
        and (p_sig is None or (p_sig.kind == "interval" and p_sig.n_spills == 0))
        and (o_sig is None or (o_sig.kind == "interval" and o_sig.n_spills == 0))
    )
    return PatternSig(pvars=pvars, strategy="scan", s_sig=s_sig, p_sig=p_sig,
                      o_sig=o_sig, fused=fused), dyn


def _lexsort(cols):
    """Stable sort permutation by ``cols`` (cols[0] is the primary key).
    No column (a variable-free pattern's ``distinct``) raises the
    reference's ``TypeError``, as ``jnp.lexsort`` does."""
    if not cols:
        raise TypeError("need sequence of keys with len > 0 in lexsort")
    if len(cols) == 1:
        return torch.sort(cols[0], stable=True).indices
    perm = torch.sort(pair_key(cols[-2], cols[-1]), stable=True).indices
    for c in reversed(cols[:-2]):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return perm


def join(a: Relation, b: Relation, cap: int, a_sorted: bool = False) -> Relation:
    """Sort-merge equi-join on all shared vars (first var = sort key).

    ``a_sorted=True`` asserts the build side already sits in ascending
    ``shared[0]`` order with invalid rows last (the shard combine hands
    over exactly that from the merge-path fold), skipping its sort.
    """
    shared = [v for v in a.vars if v in b.vars]
    if not shared:
        raise ValueError("cartesian products not supported — reorder the plan")
    key = shared[0]

    # sort build side (a) by key; invalid rows sink
    ka = torch.where(a.valid, a.col(key), INVALID)
    if a_sorted:
        a_cols, ka_s = a.cols, ka
    else:
        aperm = torch.sort(ka, stable=True).indices
        a_cols = a.cols[:, aperm]
        ka_s = ka[aperm]

    kb_ = torch.where(b.valid, b.col(key), INVALID)
    L = torch.searchsorted(ka_s, kb_)
    R = torch.searchsorted(ka_s, kb_, right=True)
    counts = torch.where(b.valid & (kb_ != INVALID), R - L, 0)
    offsets = torch.cumsum(counts, 0)
    total = offsets[-1]
    starts = offsets - counts

    # expand: output slot -> (probe row, match rank)
    out_idx = torch.arange(cap, dtype=torch.int64, device=ka.device)
    probe = torch.searchsorted(offsets, out_idx, right=True)
    probe_c = probe.clamp(0, counts.shape[0] - 1)
    rank = out_idx - starts[probe_c]
    build_row = (L[probe_c] + rank).clamp(0, ka_s.shape[0] - 1)
    ok = out_idx < torch.clamp(total, max=cap)

    # verify remaining shared vars
    a_g = a_cols[:, build_row]
    b_g = b.cols[:, probe_c]
    for v in shared[1:]:
        ok = ok & (a_g[a.vars.index(v)] == b_g[b.vars.index(v)])

    out_vars = tuple(a.vars) + tuple(v for v in b.vars if v not in a.vars)
    rows = [torch.where(ok, a_g[i], INVALID) for i in range(len(a.vars))]
    for j, v in enumerate(b.vars):
        if v not in a.vars:
            rows.append(torch.where(ok, b_g[j], INVALID))
    overflow = _overflow(total, cap) + a.overflow + b.overflow
    return Relation(vars=out_vars, cols=torch.stack(rows), valid=ok,
                    overflow=overflow)


def distinct(rel: Relation, select: tuple, cap: int) -> Relation:
    """Project onto ``select`` vars and deduplicate rows."""
    cols = [torch.where(rel.valid, rel.col(v), INVALID) for v in select]
    perm = _lexsort(cols)
    cols = [c[perm] for c in cols]
    valid = rel.valid[perm]
    first = torch.ones_like(valid)
    neq = torch.zeros_like(valid[1:])
    for c in cols:
        neq = neq | (c[1:] != c[:-1])
    first[1:] = neq
    keep = first & valid
    take, ok, n = ops.compact_indices(keep, cap)
    take = take.long()
    out = torch.stack([torch.where(ok, c[take], INVALID) for c in cols])
    return Relation(
        vars=select, cols=out, valid=ok,
        overflow=rel.overflow + _overflow(n, cap),
    )


# ---------------------------------------------------------------------------
# Batched execution: B same-signature requests in one plan body
#
# What the reference gets from ``jax.vmap(run_device, in_axes=(None, 0))``:
# every step of the plan body gains a leading member axis B, the stores are
# shared and the per-request constants are stacked.  Each step computes,
# for member b, exactly what the solo step computes for that member's
# constants — per-member sorts run along dim 1, the compactions are the
# kernels' batched entries (one launch for all members), and the INL probes
# of all members go through one search of the flattened [B * q] batch (a
# query's position in a table depends only on the table).
# ---------------------------------------------------------------------------


@dataclass
class BatchRelation(Relation):
    """A Relation with a leading member axis: cols int32[B, n_vars, cap],
    valid bool[B, cap], overflow int32[B]."""

    def col(self, v) -> torch.Tensor:
        return self.cols[:, self.vars.index(v)]


def _stack_term(tsig: TermSig, vals, device):
    """Per-member term constants -> one stacked tensor: member sets
    [B, mem_cap], interval bounds int32[B, 2 + 2 * n_spills]."""
    if tsig.kind == "members":
        return torch.stack(vals)
    return torch.tensor(vals, dtype=torch.int32, device=device)


def _stack_dyn(sig: PatternSig, dyns, device) -> dict:
    """One pattern's per-member constants (``dyn`` dicts) stacked along B."""
    if sig.strategy in ("slice", "inl"):
        out = ({"starts": torch.stack([d["starts"] for d in dyns]),
                "lens": torch.stack([d["lens"] for d in dyns])}
               if sig.strategy == "slice"
               else {"pid": torch.stack([d["pid"] for d in dyns])})
        for posi in sig.residual:
            key = ("s", "p", "o")[posi]
            tsig = (sig.s_sig, sig.p_sig, sig.o_sig)[posi]
            out[key] = _stack_term(tsig, [d[key] for d in dyns], device)
        return out
    if sig.extra_caps is not None:  # rewrite type pattern: sets per member
        tids = {d["tid"] for d in dyns}
        if len(tids) != 1:
            raise ValueError(f"a batch shares one rdf:type id, got {tids}")
        return {"tid": tids.pop(),
                **{k: torch.stack([d[k] for d in dyns])
                   for k in ("o", "dom", "rng")}}
    if sig.fused:  # the batched K2 reads each member's bounds on the device
        params = []
        for d in dyns:
            pv, ov = d.get("p"), d.get("o")
            params.append((pv[0] if pv is not None else _I32_MIN,
                           pv[1] if pv is not None else _I32_MAX,
                           ov[0] if ov is not None else _I32_MIN,
                           ov[1] if ov is not None else _I32_MAX))
        return {"params": torch.tensor(params, dtype=torch.int32,
                                       device=device)}
    return {key: _stack_term(tsig, [d[key] for d in dyns], device)
            for tsig, key in ((sig.s_sig, "s"), (sig.p_sig, "p"),
                              (sig.o_sig, "o")) if tsig is not None}


def _in_set_b(col, ids):
    """``in_set`` per member: col [B, m] (or one shared [m]) in ids [B, k]."""
    if col.dim() == 1:
        col = col.expand(ids.shape[0], -1)
    col = col.contiguous()
    pos = torch.searchsorted(ids, col).clamp(0, ids.shape[1] - 1)
    return (ids.gather(1, pos) == col) & (col != INVALID)


def _term_mask_b(col, sig: TermSig, vals):
    """``_term_mask_dyn`` per member: col [B, m] or a shared [m] column."""
    if sig.kind == "members":
        return _in_set_b(col, vals)
    m = (col >= vals[:, 0:1]) & (col < vals[:, 1:2])
    for i in range(sig.n_spills):
        m = m | ((col >= vals[:, 2 + 2 * i:3 + 2 * i])
                 & (col < vals[:, 3 + 2 * i:4 + 2 * i]))
    return m


def _scan_mask_b(sig: PatternSig, spo, alive, dyn, b: int):
    """``_scan_mask`` per member over one shared store -> bool[B, N]."""
    s, p, o = spo[:, 0], spo[:, 1], spo[:, 2]
    mask = ((s != INVALID) & alive)[None, :]
    for tsig, col, key in ((sig.s_sig, s, "s"), (sig.p_sig, p, "p"),
                           (sig.o_sig, o, "o")):
        if tsig is not None:
            mask = mask & _term_mask_b(col, tsig, dyn[key])
    return mask.expand(b, -1).contiguous()


def _overflow_b(total, cap: int):
    return (total - cap).clamp(min=0).to(torch.int32)


def _build_relation_b(pvars, s, p, o, ok, total, cap: int) -> BatchRelation:
    """``_build_relation`` with [B, cap] columns."""
    cols = []
    seen = {}
    eq = None
    for v, colv in zip(pvars, (s, p, o)):
        if v is None:
            continue
        if v in seen:
            eq = (seen[v], colv)
            continue
        seen[v] = colv
        cols.append(colv)
    if eq is not None:
        ok = ok & (eq[0] == eq[1])
    cols = [torch.where(ok, c, INVALID) for c in cols]
    return BatchRelation(
        vars=tuple(seen),
        cols=(torch.stack(cols, 1) if cols else
              torch.zeros((ok.shape[0], 0, cap), dtype=torch.int32,
                          device=ok.device)),
        valid=ok,
        overflow=_overflow_b(total, cap),
    )


def _stitch_compact_b(take_b, total_b, take_d, total_d, base_n: int,
                      cap: int):
    """``_stitch_compact`` per member: takes [B, cap], totals [B]."""
    j = torch.arange(cap, dtype=torch.int64, device=take_b.device)
    tb = total_b[:, None]
    use_b = j < tb
    di = (j - tb).clamp(0, cap - 1)
    take = torch.where(use_b, take_b, base_n + take_d.gather(1, di))
    total = total_b + total_d
    return take, j < torch.clamp(total, max=cap)[:, None], total


def _rewrite_type_bindings_b(sig: PatternSig, ds, dyn, cap: int):
    """``_rewrite_type_bindings`` for B members: one batched K4 launch per
    source -> (ok [B, cap], total [B], xcol [B, cap])."""
    _, _, has_dom, has_rng = sig.extra_caps
    args = (dyn["tid"], dyn["o"], dyn["dom"], dyn["rng"], cap, has_dom,
            has_rng)
    base_n = ds.base.shape[0]
    out_b = ops.rewrite_member_compact_batched(ds.base, ds.base_alive, *args)
    out_d = None
    if ds.delta is not None:
        out_d = ops.rewrite_member_compact_batched(ds.delta, ds.delta_alive,
                                                   *args)
    take_s, ok_s, total_s = out_b[0:3]
    if out_d is not None:
        take_s, ok_s, total_s = _stitch_compact_b(
            out_b[0], out_b[2], out_d[0], out_d[2], base_n, cap)
    vals_s = ops.two_source_gather(ds.base, ds.delta, take_s)[..., 0]
    if not has_rng:
        return ok_s, total_s, vals_s
    take_o, total_o = out_b[3], out_b[5]
    if out_d is not None:
        take_o, _, total_o = _stitch_compact_b(
            out_b[3], out_b[5], out_d[3], out_d[5], base_n, cap)
    vals_o = ops.two_source_gather(ds.base, ds.delta, take_o)[..., 2]
    j = torch.arange(cap, dtype=torch.int64, device=vals_s.device)
    ts = total_s[:, None]
    vo = vals_o.gather(1, (j - ts).clamp(0, cap - 1))
    xcol = torch.where(j < ts, vals_s, vo)
    total = total_s + total_o
    return j < torch.clamp(total, max=cap)[:, None], total, xcol


def _scan_compact_b(sig: PatternSig, ds, dyn, cap: int, b: int):
    """``_scan_compact`` for B members: the fused predicate through the
    batched K2, any other through a [B, N] mask and the batched K1."""
    base_n = ds.base.shape[0]
    if sig.fused:
        prm = dyn["params"]
        take_b, ok_b, tb = ops.masked_interval_compact_batched(
            ds.base[:, 1], ds.base[:, 2], ds.base_alive, prm, cap)
        if ds.delta is None:
            return take_b, ok_b, tb
        take_d, _, td = ops.masked_interval_compact_batched(
            ds.delta[:, 1], ds.delta[:, 2], ds.delta_alive, prm, cap)
        return _stitch_compact_b(take_b, tb, take_d, td, base_n, cap)
    take_b, ok_b, tb = ops.compact_indices_batched(
        _scan_mask_b(sig, ds.base, ds.base_alive, dyn, b), cap)
    if ds.delta is None:
        return take_b, ok_b, tb
    take_d, _, td = ops.compact_indices_batched(
        _scan_mask_b(sig, ds.delta, ds.delta_alive, dyn, b), cap)
    return _stitch_compact_b(take_b, tb, take_d, td, base_n, cap)


def _eval_pattern_b(sig: PatternSig, cap: int, stores, dyn, b: int):
    """``_eval_pattern`` for B members -> (BatchRelation, totals [B])."""
    if sig.strategy == "slice":
        ds = stores[sig.store]
        src, ok, total, _ = ops.segment_positions_batched(
            dyn["starts"], dyn["lens"], cap)
        g = ops.two_source_gather(ds.base, ds.delta, src)
        ok = ok & ops.two_source_gather(ds.base_alive, ds.delta_alive, src)
        s, p, o = g[..., 0], g[..., 1], g[..., 2]
        for posi in sig.residual:
            tsig = (sig.s_sig, sig.p_sig, sig.o_sig)[posi]
            ok = ok & _term_mask_b((s, p, o)[posi], tsig,
                                   dyn[("s", "p", "o")[posi]])
        return _build_relation_b(sig.pvars, s, p, o, ok, total, cap), total
    ds = stores["scan"]
    if sig.extra_caps is not None:
        ok, total, xcol = _rewrite_type_bindings_b(sig, ds, dyn, cap)
        var = next(v for v in sig.pvars if v is not None)
        rel = BatchRelation(vars=(var,),
                            cols=torch.where(ok, xcol, INVALID)[:, None, :],
                            valid=ok, overflow=_overflow_b(total, cap))
        return rel, total
    take, ok, total = _scan_compact_b(sig, ds, dyn, cap, b)
    g = ops.two_source_gather(ds.base, ds.delta, take)
    return _build_relation_b(sig.pvars, g[..., 0], g[..., 1], g[..., 2], ok,
                             total, cap), total


def _eval_inl_b(sig: PatternSig, cap: int, stores, dyn, rel: BatchRelation):
    """``_eval_inl`` for B members.  The probes of all members are one
    flattened [B * q] batch per source (one ``pair_range`` launch, or one
    windowed search), then the hit ranges expand per member."""
    ds = stores[sig.store]
    prim, sec = key_cols(sig.store)
    probe = rel.col(sig.pvars[sig.probe_pos])
    b, k = probe.shape
    q = sig.n_pids * k
    qlo1 = torch.where(rel.valid, probe, 0)
    valid = rel.valid.repeat(1, sig.n_pids)
    qlo = qlo1.repeat(1, sig.n_pids)
    qhi = torch.where(valid, dyn["pid"].repeat_interleave(k, dim=1), INVALID)
    flat = (qhi.reshape(-1), qlo.reshape(-1), valid.reshape(-1))
    starts, lens = (t.view(b, q)
                    for t in _inl_ranges(ds.base, prim, sec, *flat))
    if ds.delta is not None:
        st_d, ln_d = (t.view(b, q)
                      for t in _inl_ranges(ds.delta, prim, sec, *flat))
        starts = torch.cat([starts, st_d + ds.base.shape[0]], 1)
        lens = torch.cat([lens, ln_d], 1)
    src, ok, total, seg = ops.segment_positions_batched(starts, lens, cap)
    rows = ops.two_source_gather(ds.base, ds.delta, src)
    ok = ok & ops.two_source_gather(ds.base_alive, ds.delta_alive, src)
    probe_row = seg.long() % k

    s, p, o = rows[..., 0], rows[..., 1], rows[..., 2]
    for posi in sig.residual:
        tsig = (sig.s_sig, sig.p_sig, sig.o_sig)[posi]
        ok = ok & _term_mask_b((s, p, o)[posi], tsig,
                               dyn[("s", "p", "o")[posi]])

    nv = len(rel.vars)
    carried = rel.cols.gather(2, probe_row[:, None, :].expand(b, nv, cap))
    out_vars = list(rel.vars)
    out_cols = [carried[:, i] for i in range(nv)]
    seen = dict(zip(rel.vars, out_cols))
    for v, colv in zip(sig.pvars, (s, p, o)):
        if v is None:
            continue
        if v in seen:
            ok = ok & (seen[v] == colv)
            continue
        seen[v] = colv
        out_vars.append(v)
        out_cols.append(colv)
    out_cols = [torch.where(ok, c, INVALID) for c in out_cols]
    return BatchRelation(
        vars=tuple(out_vars),
        cols=torch.stack(out_cols, 1),
        valid=ok,
        overflow=rel.overflow + _overflow_b(total, cap),
    ), total


def _lexsort_b(cols):
    """``_lexsort`` per member: each [B, n] key sorted along dim 1."""
    if not cols:
        raise TypeError("need sequence of keys with len > 0 in lexsort")
    if len(cols) == 1:
        return torch.sort(cols[0], dim=1, stable=True).indices
    perm = torch.sort(pair_key(cols[-2], cols[-1]), dim=1, stable=True).indices
    for c in reversed(cols[:-2]):
        perm = perm.gather(1, torch.sort(c.gather(1, perm), dim=1,
                                         stable=True).indices)
    return perm


def _take_cols(cols, idx):
    """cols [B, n_vars, n] at per-member slots idx [B, m] -> [B, n_vars, m]."""
    return cols.gather(2, idx[:, None, :].expand(-1, cols.shape[1], -1))


def join_b(a: BatchRelation, b: BatchRelation, cap: int) -> BatchRelation:
    """``join`` per member: each member's build side sorted along dim 1,
    probed by ``torch.searchsorted`` over [B, N] sorted rows."""
    shared = [v for v in a.vars if v in b.vars]
    if not shared:
        raise ValueError("cartesian products not supported — reorder the plan")
    key = shared[0]
    ka = torch.where(a.valid, a.col(key), INVALID)
    aperm = torch.sort(ka, dim=1, stable=True).indices
    a_cols = _take_cols(a.cols, aperm)
    ka_s = ka.gather(1, aperm)

    kb_ = torch.where(b.valid, b.col(key), INVALID)
    L = torch.searchsorted(ka_s, kb_)
    R = torch.searchsorted(ka_s, kb_, right=True)
    counts = torch.where(b.valid & (kb_ != INVALID), R - L, 0)
    offsets = torch.cumsum(counts, 1)
    total = offsets[:, -1]
    starts = offsets - counts

    nb = counts.shape[0]
    out_idx = torch.arange(cap, dtype=torch.int64, device=ka.device)
    probe = torch.searchsorted(offsets, out_idx.expand(nb, cap).contiguous(),
                               right=True)
    probe_c = probe.clamp(0, counts.shape[1] - 1)
    rank = out_idx - starts.gather(1, probe_c)
    build_row = (L.gather(1, probe_c) + rank).clamp(0, ka_s.shape[1] - 1)
    ok = out_idx < torch.clamp(total, max=cap)[:, None]

    a_g = _take_cols(a_cols, build_row)
    b_g = _take_cols(b.cols, probe_c)
    for v in shared[1:]:
        ok = ok & (a_g[:, a.vars.index(v)] == b_g[:, b.vars.index(v)])

    out_vars = tuple(a.vars) + tuple(v for v in b.vars if v not in a.vars)
    rows = [torch.where(ok, a_g[:, i], INVALID) for i in range(len(a.vars))]
    for j, v in enumerate(b.vars):
        if v not in a.vars:
            rows.append(torch.where(ok, b_g[:, j], INVALID))
    overflow = _overflow_b(total, cap) + a.overflow + b.overflow
    return BatchRelation(vars=out_vars, cols=torch.stack(rows, 1), valid=ok,
                         overflow=overflow)


def distinct_b(rel: BatchRelation, select: tuple, cap: int) -> BatchRelation:
    """``distinct`` per member; the keep masks of all members go through
    one batched K1 launch."""
    cols = [torch.where(rel.valid, rel.col(v), INVALID) for v in select]
    perm = _lexsort_b(cols)
    cols = [c.gather(1, perm) for c in cols]
    valid = rel.valid.gather(1, perm)
    first = torch.ones_like(valid)
    neq = torch.zeros_like(valid[:, 1:])
    for c in cols:
        neq = neq | (c[:, 1:] != c[:, :-1])
    first[:, 1:] = neq
    keep = first & valid
    take, ok, n = ops.compact_indices_batched(keep, cap)
    take = take.long()
    out = torch.stack([torch.where(ok, c.gather(1, take), INVALID)
                       for c in cols], 1)
    return BatchRelation(
        vars=select, cols=out, valid=ok,
        overflow=rel.overflow + _overflow_b(n, cap),
    )


# ---------------------------------------------------------------------------
# The engine: host-side resolution + planning, device execution
# ---------------------------------------------------------------------------


@dataclass
class QueryEngine:
    kb: EncodedKB
    spo: torch.Tensor  # the store to query (lite / full / original)
    mode: str = "litemat"  # litemat | full | rewrite
    dtb: DeviceTBox | None = None
    slack: float = 1.5
    use_index: bool = True  # resolve eligible patterns via sorted indexes
    use_inl: bool = True  # index-nested-loop joins when one side is tiny
    inl_factor: int = 8  # pattern must outweigh the probe side by this much
    inl_max_probe: int = 4096  # never INL above this probe-side estimate
    view: StoreView | None = None  # live base+delta view (None: static store)
    _exec_cache: dict = field(default_factory=dict, repr=False)
    cache_stats: dict = field(default_factory=lambda: {"hits": 0, "misses": 0},
                              repr=False)
    # (PatternSig, probe-constant bucket) -> last observed selectivity
    # (observed rows / store rows); filled by every successful run/explain,
    # read by the planner.  The bucket is the tuple of
    # ``_pattern_const_key`` snapshots of every pattern up to and including
    # this one in plan order — the probe side's provenance.
    observed_selectivity: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.dtb is None and self.kb.tbox is not None:
            self.dtb = DeviceTBox.build(self.kb.tbox, device=self.spo.device)
        if self.view is None:
            self.view = StoreView.static(self.spo)

    def set_view(self, view: StoreView) -> None:
        """Swap in a fresh store view after a mutation (the plan cache
        survives: plans are keyed on signatures and capacity buckets)."""
        self.view = view
        self.spo = view.base_rows

    @property
    def device(self) -> torch.device:
        return self.view.base_rows.device

    # -- constant resolution (context-aware, paper §III intro) --------------
    def _resolve(self, term, position: str, type_pattern: bool) -> Term:
        tbox = self.kb.tbox
        if isinstance(term, (int, np.integer)):
            return Term(lo=int(term), hi=int(term) + 1)
        name = term
        if position == "p" and tbox is not None:
            enc = tbox.properties
        elif position == "o" and type_pattern and tbox is not None:
            enc = tbox.concepts
        else:
            enc = None
        if enc is not None and (name in enc.name_to_id or name in enc.tax.merged):
            if self.mode == "rewrite":
                return Term(lo=0, hi=0, members=np.sort(np.array(
                    enc.subsumees(name), dtype=np.int32)))
            if self.mode == "full":
                i = enc.id_of(name)
                return Term(lo=i, hi=i + 1)
            (lo, hi), spills = enc.interval_of(name)
            return Term(lo=lo, hi=hi, spills=tuple(spills))
        ids = self.kb.locate([name])
        if ids[0] < 0:
            raise KeyError(f"unknown term {name!r}")
        return Term(lo=int(ids[0]), hi=int(ids[0]) + 1)

    def _prepare(self, patterns):
        """Resolve constants; attach rewrite extras for type patterns."""
        prepared = []
        for pat in patterns:
            p_is_const = not is_var(pat.p)
            type_pat = p_is_const and self.kb.tbox is not None and (
                pat.p in ("rdf:type", "a") or pat.p == self.kb.tbox.rdf_type_id
            )
            terms = (
                None if is_var(pat.s) else self._resolve(pat.s, "s", False),
                None if is_var(pat.p) else self._resolve(pat.p, "p", type_pat),
                None if is_var(pat.o) else self._resolve(pat.o, "o", type_pat),
            )
            pvars = tuple(t if is_var(t) else None for t in (pat.s, pat.p, pat.o))
            extra = None
            if self.mode == "rewrite" and type_pat and terms[2] is not None and is_var(pat.s):
                extra = self._rewrite_extra(terms[2])
            prepared.append((pvars, terms, extra))
        return prepared

    def _rewrite_extra(self, o_term: Term):
        """Property sets whose (effective) domain/range entails the target."""
        tbox = self.kb.tbox
        targets = set(o_term.members.tolist())
        dom_set, rng_set = [], []
        dr_ids = self.dtb.dr_prop_ids.cpu().numpy()
        dom_tbl = self.dtb.domain_table.cpu().numpy()
        rng_tbl = self.dtb.range_table.cpu().numpy()
        penc = tbox.properties
        for i, pid in enumerate(dr_ids.tolist()):
            if pid < 0:
                continue
            doms = [v for v in dom_tbl[i].tolist() if v >= 0]
            rngs = [v for v in rng_tbl[i].tolist() if v >= 0]
            subs = penc.subsumees(penc.name_of(pid))  # sub-properties inherit
            if any(d in targets for d in doms):
                dom_set.extend(subs)
            if any(r in targets for r in rngs):
                rng_set.extend(subs)
        return (
            int(tbox.rdf_type_id),
            np.sort(np.unique(np.array(dom_set, dtype=np.int32))),
            np.sort(np.unique(np.array(rng_set, dtype=np.int32))),
        )

    # -- pattern lowering: strategy choice + cardinality ---------------------
    def _lower(self, pvars, terms, extra):
        """-> (PatternSig, dyn, host count or None).

        ``count`` is exact (an upper bound when tombstones sit inside a
        range) and free for slice patterns; scan patterns report None and
        are counted by one device pass.  Rewrite mode always scans.
        """
        s_t, p_t, o_t = terms
        indexable = (
            self.use_index
            and extra is None
            and self.mode in ("litemat", "full")
            and all(t is None or t.members is None for t in terms)
        )
        if indexable and p_t is not None:
            view = self.view
            # effective predicate id: exact single-width interval, or a wide
            # interval whose store run holds only one distinct predicate
            # (the common rdf:type case) — both collapse to composite ranges
            pid = p_t.lo if (p_t.hi == p_t.lo + 1 and not p_t.spills) else None
            if pid is None and not p_t.spills:
                pid = view.single_p_run(p_t.lo, p_t.hi)
            ranges = None
            store = "pos"
            residual = ()
            o_sig = o_dyn = None
            if s_t is None and o_t is None:
                ranges = [r for a, b in p_t.intervals()
                          for r in view.p_ranges(a, b)]
            elif s_t is None and o_t is not None:
                if pid is not None:
                    ranges = [r for a, b in o_t.intervals()
                              for r in view.po_ranges(pid, a, b)]
                else:  # mixed p run sliced, o re-checked on the gathered rows
                    ranges = [r for a, b in p_t.intervals()
                              for r in view.p_ranges(a, b)]
                    residual = (2,)
                    o_sig, o_dyn = _lower_term(o_t, self.device)
            elif s_t is not None and pid is not None:
                ranges = [r for a, b in s_t.intervals()
                          for r in view.ps_ranges(pid, a, b)]
                store = "pso"
                if o_t is not None:  # o re-checked on the gathered rows
                    residual = (2,)
                    o_sig, o_dyn = _lower_term(o_t, self.device)
            if ranges is not None:
                return self._slice_plan(pvars, ranges, store, residual,
                                        o_sig=o_sig, o_dyn=o_dyn)
        if indexable and p_t is None and (s_t is not None or o_t is not None):
            # variable predicate: SPO (constant subject) / OSP (constant
            # object) permutations keep these off the full-scan path
            view = self.view
            if s_t is not None:
                ranges = [r for a, b in s_t.intervals()
                          for r in view.s_ranges(a, b)]
                residual, o_sig, o_dyn = (), None, None
                if o_t is not None:  # (s ?p o): o re-checked after the gather
                    residual = (2,)
                    o_sig, o_dyn = _lower_term(o_t, self.device)
                return self._slice_plan(pvars, ranges, "spo", residual,
                                        o_sig=o_sig, o_dyn=o_dyn)
            ranges = [r for a, b in o_t.intervals()
                      for r in view.o_ranges(a, b)]
            return self._slice_plan(pvars, ranges, "osp", ())
        sig, dyn = _lower_scan(pvars, terms, extra, self.mode, self.device)
        return sig, dyn, None

    def _slice_plan(self, pvars, ranges, store, residual, o_sig=None,
                    o_dyn=None):
        lens = [max(r1 - r0, 0) for r0, r1 in ranges]
        sig = PatternSig(pvars=pvars, strategy="slice", store=store,
                         k=len(ranges), o_sig=o_sig, residual=residual)
        dyn = {
            "starts": torch.tensor([r0 for r0, _ in ranges], dtype=torch.int64,
                                   device=self.device),
            "lens": torch.tensor(lens, dtype=torch.int64, device=self.device),
        }
        if o_dyn is not None:
            dyn["o"] = o_dyn
        return sig, dyn, sum(lens)

    def _pattern_count(self, sig: PatternSig, dyn) -> int:
        """Planning cardinality of a scan pattern (one cached device pass)."""
        if self.view.n == 0:  # empty store: no device pass
            return 0
        key = ("count", sig)
        fn = self._exec_cache.get(key)
        if fn is None:
            def fn(ds, d, _sig=sig):
                sources = [(ds.base, ds.base_alive)]
                if ds.delta is not None:
                    sources.append((ds.delta, ds.delta_alive))
                total = 0
                for spo, alive in sources:
                    if _sig.extra_caps is not None:
                        # the rewrite type pattern's subject and object
                        # branches (execution fuses them into K4); a row can
                        # bind through BOTH: count both
                        ms, mo = member_masks(
                            spo[:, 0], spo[:, 1], spo[:, 2], alive, d["tid"],
                            d["o"], d["dom"], d["rng"], _sig.extra_caps[2],
                            _sig.extra_caps[3])
                        total += ms.sum()
                        if mo is not None:
                            total += mo.sum()
                    else:
                        total += _scan_mask(_sig, spo, alive, d).sum()
                return total
            self._exec_cache[key] = fn
        return int(fn(self.view.dev("scan"), dyn))

    @staticmethod
    def _make_run_device(sigs, caps, join_cap: int, select):
        """Build the device-side plan body.

        The function returns (cols, valid, overflow, totals): ``totals``
        is int32[n_patterns] — each pattern's OBSERVED match count before
        capacity clipping, in plan order.
        """

        def run_device(stores, dyns):
            rel = None
            totals = []
            for sig, cap, dyn in zip(sigs, caps, dyns):
                if sig.strategy == "inl":  # consumes the running relation
                    rel, t = _eval_inl(sig, cap, stores, dyn, rel)
                else:
                    r, t = _eval_pattern(sig, cap, stores, dyn)
                    rel = r if rel is None else join(rel, r, join_cap)
                totals.append(t)
            out = distinct(rel, select, join_cap)
            return (out.cols, out.valid, out.overflow,
                    torch.stack(totals).to(torch.int32))

        return run_device

    @staticmethod
    def _make_run_device_batched(sigs, caps, join_cap: int, select):
        """The batched plan body: ``run_device`` with a member axis.

        Takes the shared stores, the per-pattern constants stacked along B
        (``_stack_dyn``) and B; returns (cols int32[B, n_select, join_cap],
        valid bool[B, join_cap], overflow int32[B], totals int32[B,
        n_patterns]) — member b's slices what the solo body returns for its
        constants.
        """

        def run_device(stores, dyns, b: int):
            rel = None
            totals = []
            for sig, cap, dyn in zip(sigs, caps, dyns):
                if sig.strategy == "inl":
                    rel, t = _eval_inl_b(sig, cap, stores, dyn, rel)
                else:
                    r, t = _eval_pattern_b(sig, cap, stores, dyn, b)
                    rel = r if rel is None else join_b(rel, r, join_cap)
                totals.append(t)
            out = distinct_b(rel, select, join_cap)
            return (out.cols, out.valid, out.overflow,
                    torch.stack(totals, 1).to(torch.int32))

        return run_device

    def _executable(self, key, sigs, caps, join_cap: int, select):
        """Memoized plan body: signature + buckets -> function."""
        fn = self._exec_cache.get(key)
        slabel = sig_label(sigs)
        if fn is None:
            self.cache_stats["misses"] += 1
            REGISTRY.counter("query/plan_cache", event="miss",
                             sig=slabel).inc()
            fn = self._make_run_device(sigs, caps, join_cap, select)
            self._exec_cache[key] = fn
        else:
            self.cache_stats["hits"] += 1
            REGISTRY.counter("query/plan_cache", event="hit",
                             sig=slabel).inc()
        return fn

    def _batch_executable(self, key, sigs, caps, join_cap: int, select):
        """Memoized batched plan body: one call answers a whole group of
        same-signature requests (the reference's vmapped executable)."""
        fn = self._exec_cache.get(key)
        slabel = sig_label(sigs)
        if fn is None:
            self.cache_stats["misses"] += 1
            REGISTRY.counter("query/plan_cache", event="miss_batch",
                             sig=slabel).inc()
            fn = self._make_run_device_batched(sigs, caps, join_cap, select)
            self._exec_cache[key] = fn
        else:
            self.cache_stats["hits"] += 1
            REGISTRY.counter("query/plan_cache", event="hit_batch",
                             sig=slabel).inc()
        return fn

    @staticmethod
    def _bucket(n: int) -> int:
        return _pow2(n, floor=256)

    @staticmethod
    def _plan_order(prepared, counts):
        """Greedy join order: smallest first, stay connected when possible."""
        remaining = list(range(len(prepared)))
        remaining.sort(key=lambda i: counts[i])
        order = [remaining.pop(0)]
        bound_vars = set(v for v in prepared[order[0]][0] if v)
        while remaining:
            connected = [i for i in remaining if bound_vars & {v for v in prepared[i][0] if v}]
            pick = min(connected or remaining, key=lambda i: counts[i])
            remaining.remove(pick)
            order.append(pick)
            bound_vars |= {v for v in prepared[pick][0] if v}
        return order

    def _stores(self, sigs):
        """DevStores the plan body takes as inputs, keyed per signature."""
        v = self.view
        stores = {}
        if any(sig.strategy == "scan" for sig in sigs):
            stores["scan"] = v.dev("scan")
        for perm in {sig.store for sig in sigs
                     if sig.strategy in ("slice", "inl")}:
            stores[perm] = v.dev(perm)
        return stores

    def _inl_pids(self, p_t: Term, limit: int = 4):
        """Distinct store predicate ids of a constant p term, or None."""
        if p_t.spills:
            return None
        if p_t.hi == p_t.lo + 1:
            return [p_t.lo]
        return self.view.distinct_p_ids(p_t.lo, p_t.hi, limit)

    def _apply_inl(self, prepared, lowered, counts, order, ckeys):
        """Convert eligible joins to index-nested-loop probes (in place).

        Walking the join order with a running probe-side estimate, a later
        pattern whose row count dwarfs that estimate is re-lowered to an
        INL probe of its composite-key permutation (PSO when the shared
        variable is the subject, POS when it is the object) — the Q4 shape.
        Once a probe shape has executed, its observed output row count
        (``observed_selectivity``, keyed by the INL PatternSig plus the
        probe-constant bucket) decides alone: it can convert a pattern the
        heuristic rejected, or veto one it accepted.
        """
        indexable = (self.use_inl and self.use_index
                     and self.mode in ("litemat", "full"))
        if not indexable or len(order) < 2:
            return
        store_n = max(self.view.n, 1)
        bound = {v for v in prepared[order[0]][0] if v}
        est = counts[order[0]]
        ctx = [ckeys[order[0]]]  # probe provenance: const keys walked so far
        for i in order[1:]:
            pvars, terms, extra = prepared[i]
            pat_vars = {v for v in pvars if v}
            heuristic = counts[i] >= self.inl_factor * max(est, 1)
            eligible = (
                extra is None
                and est <= self.inl_max_probe
                and terms[1] is not None
                and all(t is None or t.members is None for t in terms)
                and (heuristic or bool(self.observed_selectivity))
            )
            if eligible:
                pids = self._inl_pids(terms[1])
                probe_pos = store = None
                if pids:
                    if pvars[0] is not None and pvars[0] in bound:
                        probe_pos, store = 0, "pso"
                        res_t, res_pos = terms[2], 2
                    elif pvars[2] is not None and pvars[2] in bound:
                        probe_pos, store = 2, "pos"
                        res_t, res_pos = terms[0], 0
                if probe_pos is not None:
                    dyn = {"pid": torch.tensor([_clip32(p) for p in pids],
                                               dtype=torch.int32,
                                               device=self.device)}
                    residual = ()
                    r_sig = None
                    if res_t is not None:
                        r_sig, r_dyn = _lower_term(res_t, self.device)
                        residual = (res_pos,)
                        dyn[("s", "p", "o")[res_pos]] = r_dyn
                    sig = PatternSig(
                        pvars=pvars, strategy="inl", store=store,
                        probe_pos=probe_pos, residual=residual,
                        n_pids=len(pids),
                        s_sig=r_sig if res_pos == 0 else None,
                        o_sig=r_sig if res_pos == 2 else None,
                    )
                    bucket = tuple(ctx) + (ckeys[i],)
                    obs = self.observed_selectivity.get((sig, bucket))
                    if obs is not None:
                        inl_rows = max(int(round(obs * store_n)), 1)
                        convert = inl_rows * self.inl_factor <= counts[i]
                        sized = max(inl_rows * 2, max(est, 1) * 2)
                        src = "observed"
                    else:
                        convert = heuristic
                        sized = max(est, 1) * 32
                        src = "estimate"
                    if convert:
                        REGISTRY.counter("planner/inl_decision",
                                         source=src).inc()
                        counts[i] = min(counts[i], sized)
                        lowered[i] = (sig, dyn, counts[i])
                    elif src == "observed" and heuristic:
                        REGISTRY.counter("planner/inl_decision",
                                         source="observed_veto").inc()
            bound |= pat_vars
            ctx.append(ckeys[i])
            est = min(est, counts[i])

    def _plan(self, patterns, select):
        """Host planning: -> (sigs, dyns, ordered caps, join_cap, sel,
        stores, order, est, buckets)."""
        prepared = self._prepare(patterns)
        lowered = [self._lower(*pre) for pre in prepared]
        counts = [
            c if c is not None else self._pattern_count(sig, dyn)
            for sig, dyn, c in lowered
        ]
        ckeys = [_pattern_const_key(pre[1]) for pre in prepared]
        order = self._plan_order(prepared, counts)
        self._apply_inl(prepared, lowered, counts, order, ckeys)
        caps = [self._bucket(int(counts[i] * self.slack) + 16) for i in order]
        join_cap = self._bucket(int(max(counts) * self.slack) + 16)

        sigs = tuple(lowered[i][0] for i in order)
        dyns = tuple(lowered[i][1] for i in order)
        all_vars = tuple(dict.fromkeys(
            v for sig in sigs for v in sig.pvars if v is not None))
        sel = tuple(select) if select else all_vars
        buckets = tuple(tuple(ckeys[i] for i in order[: j + 1])
                        for j in range(len(order)))
        return (sigs, dyns, caps, join_cap, sel, self._stores(sigs),
                tuple(order), tuple(counts[i] for i in order), buckets)

    def _record_observed(self, sigs, est, totals, buckets) -> None:
        """Land observed per-pattern row counts in the process registry."""
        store_n = max(self.view.n, 1)
        for sig, e, obs, bucket in zip(sigs, est, totals, buckets):
            obs = int(obs)
            self.observed_selectivity[(sig, bucket)] = obs / store_n
            REGISTRY.histogram("planner/observed_rows",
                               strategy=sig.strategy).observe(obs)
            REGISTRY.histogram("planner/est_ratio",
                               strategy=sig.strategy).observe(
                (int(e) + 1) / (obs + 1))
            REGISTRY.gauge("planner/selectivity", strategy=sig.strategy,
                           store=sig.store).set(obs / store_n)

    def run(self, patterns, select=None, max_retries: int = 6):
        """Execute; returns (rows int32[k, n_select] numpy, select var names)."""
        with obs_trace.span("plan", mode=self.mode,
                            n_patterns=len(patterns)):
            planned = self._plan(patterns, select)
        return self._run_planned(planned, max_retries)

    def _run_planned(self, planned, max_retries: int = 6):
        """Execute an already-planned query, doubling capacities on overflow."""
        planned = list(planned)
        for attempt in range(max_retries):
            out = self._settle(planned, self._launch(planned), attempt)
            if out is not None:
                cols, valid, n = out
                return cols[:, :n].T.cpu().numpy(), planned[4]
        raise RuntimeError("query kept overflowing its capacity buckets")

    def _launch(self, planned):
        """Enqueue one attempt of a planned query on the engine's device:
        -> the attempt's pending outputs.  Nothing here waits on the
        device, so a caller may enqueue several engines' attempts before
        settling any (the sharded store's group runner)."""
        sigs, dyns, caps, join_cap, sel, stores = planned[:6]
        key = ("exec", self.mode, sigs, tuple(caps), join_cap, sel)
        misses0 = self.cache_stats["misses"]
        fn = self._executable(key, sigs, tuple(caps), join_cap, sel)
        t0 = time.perf_counter()
        return fn(stores, dyns), self.cache_stats["misses"] == misses0, t0

    def _settle(self, planned, launched, attempt: int, shard: str = "local"):
        """Read one launched attempt's outcome (one host read): -> ``(cols,
        valid, n)`` on the device, or None after an overflow, with
        ``planned``'s (a list) capacities doubled for the next attempt."""
        (cols, valid, overflow, totals), cached, t0 = launched
        sigs, join_cap = planned[0], planned[3]
        slabel = sig_label(sigs)
        with obs_trace.span("dispatch", cached=cached,
                            join_cap=join_cap) as dsp:
            read = torch.cat([overflow.reshape(1).long(), totals.long(),
                              valid.sum().reshape(1)]).tolist()
            REGISTRY.histogram("query/exec_seconds", sig=slabel).observe(
                time.perf_counter() - t0)
            dsp.set_attr(overflow=bool(read[0]))
        if not read[0]:
            if attempt:
                REGISTRY.histogram("join/capacity_depth", site="query",
                                   sig=slabel, shard=shard).observe(attempt)
            self._record_observed(sigs, planned[7], read[1:-1], planned[8])
            return cols, valid, read[-1]
        obs_trace.event("overflow_retry", attempt=attempt, join_cap=join_cap)
        REGISTRY.counter("query/overflow_retries").inc()
        REGISTRY.counter("join/capacity_retry", site="query", sig=slabel,
                         shard=shard).inc()
        planned[2] = [c * 2 for c in planned[2]]
        planned[3] = join_cap * 2
        return None

    # -- micro-batched execution ---------------------------------------------
    def _batch_caps(self, planned_group):
        """Unified capacity buckets for a same-signature batch.

        Member caps start at the elementwise max (the shared body must hold
        the largest member), then observed selectivities — looked up per
        member by ``(sig, probe-constant bucket)`` — adjust them: with
        every member observed the cap becomes the largest member's observed
        floor (it may shrink); while any member is unobserved, observations
        only grow it.
        """
        sigs = planned_group[0][0]
        caps = [max(p[2][j] for p in planned_group)
                for j in range(len(sigs))]
        join_cap = max(p[3] for p in planned_group)
        store_n = max(self.view.n, 1)
        for j, sig in enumerate(sigs):
            obs = [self.observed_selectivity.get((sig, p[8][j]))
                   for p in planned_group]
            known = [o for o in obs if o is not None]
            if not known:
                continue
            floor = max(self._bucket(int(o * store_n * self.slack) + 16)
                        for o in known)
            if len(known) == len(obs):
                caps[j] = floor  # complete evidence: shrink allowed
            else:
                caps[j] = max(caps[j], floor)
        return caps, max(join_cap, max(caps))

    def run_batch(self, requests, max_retries: int = 6):
        """Execute a batch of (patterns, select) requests in shared plan
        bodies; returns [(rows, sel), ...] aligned with ``requests``.

        Every request is planned on its own; structurally identical
        requests are answered once and fanned out; distinct requests whose
        patterns lower to the same signature tuple (projecting the same
        variables) run as ONE batched plan body over their stacked
        constants, capacities unified by :meth:`_batch_caps`.  A request
        whose signature matches nobody else's takes the solo path.  The
        power-of-two member count ``Bp`` stays in the cache key as in the
        reference, but the members are not padded to it: eager torch has
        nothing to recompile for another B.
        """
        results = [None] * len(requests)
        uniq_keys, uniq = {}, []  # structural dedupe: answer once, fan out
        for i, (pats, select) in enumerate(requests):
            k = (tuple((p.s, p.p, p.o) for p in pats),
                 tuple(select) if select is not None else None)
            j = uniq_keys.get(k)
            if j is None:
                uniq_keys[k] = len(uniq)
                uniq.append((self._plan(pats, select), [i]))
            else:
                uniq[j][1].append(i)
        groups = {}
        for planned, members in uniq:
            groups.setdefault((planned[0], planned[4]), []).append(
                (planned, members))
        for (sigs, sel), entries in groups.items():
            if len(entries) == 1:
                planned, members = entries[0]
                rows, _ = self._run_planned(planned, max_retries)
                for i in members:
                    results[i] = (rows, sel)
                continue
            caps, join_cap = self._batch_caps([e[0] for e in entries])
            stores = entries[0][0][5]
            B = len(entries)
            Bp = _pow2(B, floor=2)
            dyns = tuple(_stack_dyn(sig, [e[0][1][j] for e in entries],
                                    self.device)
                         for j, sig in enumerate(sigs))
            REGISTRY.histogram("query/batch_size", mode=self.mode).observe(B)
            slabel = sig_label(sigs)
            for attempt in range(max_retries):
                key = ("bexec", self.mode, sigs, tuple(caps), join_cap,
                       sel, Bp)
                fn = self._batch_executable(key, sigs, tuple(caps),
                                            join_cap, sel)
                t0 = time.perf_counter()
                cols, valid, overflow, totals = fn(stores, dyns, B)
                ok = int(overflow.max()) == 0  # one read for the batch
                REGISTRY.histogram("query/exec_seconds", sig=slabel).observe(
                    time.perf_counter() - t0)
                if ok:
                    if attempt:
                        REGISTRY.histogram(
                            "join/capacity_depth", site="batch", sig=slabel,
                            shard="local").observe(attempt)
                    break
                obs_trace.event("overflow_retry", attempt=attempt,
                                join_cap=join_cap, batch=B)
                REGISTRY.counter("query/overflow_retries").inc()
                REGISTRY.counter("join/capacity_retry", site="batch",
                                 sig=slabel, shard="local").inc()
                join_cap *= 2
                caps = [c * 2 for c in caps]
            else:
                raise RuntimeError(
                    "batched query kept overflowing its capacity buckets")
            # one host read for the counts and totals, one copy of the rows
            meta = torch.cat([valid.sum(1),
                              totals.reshape(-1).long()]).tolist()
            n_rows, totals_h = meta[:B], meta[B:]
            cols_h = cols[:, :, :max(n_rows)].cpu().numpy()
            npat = len(sigs)
            for b, (planned, members) in enumerate(entries):
                self._record_observed(sigs, planned[7],
                                      totals_h[b * npat:(b + 1) * npat],
                                      planned[8])
                rows = cols_h[b][:, :n_rows[b]].T
                for i in members:
                    results[i] = (rows, sel)
        return results

    def explain(self, patterns, select=None, execute: bool = True) -> dict:
        """EXPLAIN: per-pattern strategy, buckets, estimated-vs-observed rows.

        Plans exactly like ``run`` and (by default) executes once through
        the same cached plan body to read each pattern's observed match
        count.  ``execute=False`` reports the plan only.
        """
        (sigs, dyns, caps, join_cap, sel, stores,
         order, est, buckets) = self._plan(patterns, select)
        observed = [None] * len(sigs)
        n_rows = None
        hot_keys = {}
        if execute and self.view.n:
            key = ("exec", self.mode, sigs, tuple(caps), join_cap, sel)
            fn = self._executable(key, sigs, tuple(caps), join_cap, sel)
            cols, valid, overflow, totals = fn(stores, dyns)
            observed = [int(t) for t in totals.tolist()]
            n_rows = int(valid.sum())
            self._record_observed(sigs, est, observed, buckets)
            # observed hot-key skew of every selected join variable
            if n_rows:
                rows_h = cols[:, :n_rows].T.cpu().numpy()
                uses = {}
                for sig in sigs:
                    for v in sig.pvars:
                        if v is not None:
                            uses[v] = uses.get(v, 0) + 1
                for v in sel:
                    if uses.get(v, 0) < 2:
                        continue
                    _, cnt = np.unique(rows_h[:, sel.index(v)],
                                       return_counts=True)
                    top, mean = int(cnt.max()), float(cnt.mean())
                    hot_keys[v] = {
                        "max_rows_per_key": top,
                        "mean_rows_per_key": mean,
                        "skew": top / mean,
                    }
                    REGISTRY.gauge("join/hot_key_skew", var=v,
                                   sig=sig_label(sigs)).set(top / mean)
        store_n = max(self.view.n, 1)
        pats = []
        for j, sig in enumerate(sigs):
            entry = {
                "pattern_index": order[j],
                "strategy": sig.strategy,
                "store": sig.store,
                "cap": caps[j],
                "estimated_rows": int(est[j]),
                "observed_rows": observed[j],
            }
            if sig.strategy == "slice":
                entry["n_ranges"] = sig.k
            if sig.strategy == "scan":
                entry["fused"] = sig.fused
            if sig.strategy == "inl":
                entry["n_pids"] = sig.n_pids
                entry["probe_pos"] = sig.probe_pos
            if observed[j] is not None:
                entry["selectivity"] = observed[j] / store_n
            pats.append(entry)
        return {
            "mode": self.mode,
            "select": list(sel),
            "store_rows": int(self.view.n),
            "join_cap": join_cap,
            "n_result_rows": n_rows,
            "patterns": pats,
            "hot_keys": hot_keys,
        }

    def prewarm(self, queries, buckets=(), select=None) -> int:
        """Run each query's plan body once at its natural capacity buckets
        (and at every floor in ``buckets``); returns #plans created."""
        before = self.cache_stats["misses"]
        for pats in queries:
            sigs, dyns, caps, join_cap, sel, stores = \
                self._plan(pats, select)[:6]
            capsets = {(tuple(caps), join_cap)}
            for b in buckets:
                b = self._bucket(int(b))
                capsets.add((tuple(max(c, b) for c in caps),
                             max(join_cap, b)))
            for cs, jc in sorted(capsets):
                key = ("exec", self.mode, sigs, cs, jc, sel)
                fn = self._executable(key, sigs, cs, jc, sel)
                fn(stores, dyns)
        _sync(self.device)
        return self.cache_stats["misses"] - before
