"""Conjunctive SPARQL evaluation over encoded triples — the paper's §V.

Two execution modes of the paper's Table VI are ported here:

  * ``litemat``  — interval predicates (one compare per sub-hierarchy) over
                   the lite-materialized store,
  * ``full``     — plain equality over the fully materialized store.

(The third, ``rewrite``, waits for a later slice; the engine refuses it.)

The algebra is the paper's filter→map→join pipeline in the reference's
static-shape discipline: every operator carries a capacity + validity mask
+ overflow counter, and the engine re-executes with doubled capacities if
an overflow is reported (power-of-two buckets).  Eager torch would not need
fixed capacities; the port keeps them so that plans, explain() output and
overflow retries match the reference step for step.

Execution strategy per pattern (chosen host-side during planning):

  * ``slice`` — a litemat/full pattern with a pure-interval constant
    resolves against the sorted store permutations (core/index.py via the
    view): host binary searches yield contiguous row ranges, and the device
    work is one gather.  The range lengths give the planner cardinalities
    with zero device passes.
  * ``scan``  — the ``use_index=False`` path streams the store once through
    the compaction kernel (kernels/stream_compact.py); simple interval
    predicates fuse the filter and the liveness mask into the same pass,
    and the compaction's total doubles as the match count.
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
    """A resolved pattern constant: interval [lo, hi) + optional spills."""

    lo: int
    hi: int
    spills: tuple = ()  # ((lo, hi), ...)

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
    kind: str  # 'interval'
    n_spills: int = 0


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
    fused: bool = False  # scan: predicate fused into the compaction kernel
    probe_pos: int = -1  # inl: pattern position the bound var probes (0|2)
    n_pids: int = 0  # inl: how many distinct store pids are probed


def _clip32(v) -> int:
    return int(np.clip(int(v), _I32_MIN, _I32_MAX))


def _lower_term(t: Term | None):
    """Host Term -> (TermSig, int32-clipped bounds tuple) or (None, None)."""
    if t is None:
        return None, None
    vals = [_clip32(t.lo), _clip32(t.hi)]
    for lo, hi in t.spills:
        vals += [_clip32(lo), _clip32(hi)]
    return TermSig("interval", n_spills=len(t.spills)), tuple(vals)


def _term_mask_dyn(col, sig: TermSig, vals):
    """Per-column membership mask of an interval term (+ its spills)."""
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
    return tuple(None if t is None else (t.lo, t.hi, t.spills) for t in terms)


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


def _scan_compact(sig: PatternSig, ds, dyn, cap: int):
    """Scan a view key -> (take, ok, total)."""
    base_n = ds.base.shape[0]
    if sig.fused:
        pv, ov = dyn.get("p"), dyn.get("o")
        params = (pv[0] if pv is not None else _I32_MIN,
                  pv[1] if pv is not None else _I32_MAX,
                  ov[0] if ov is not None else _I32_MIN,
                  ov[1] if ov is not None else _I32_MAX)
        return ops.masked_interval_compact(
            ds.base[:, 1], ds.base[:, 2], ds.base_alive, params, cap,
            block=ops.auto_block(base_n))
    mask = _scan_mask(sig, ds.base, ds.base_alive, dyn)
    return ops.compact_indices(mask, cap, block=ops.auto_block(base_n))


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
    search = (ops.pair_search_windowed if rows.shape[0] > INL_RESIDENT_MAX
              else ops.pair_search)
    starts = search(t_hi, t_lo, qhi, qlo)
    ends = search(t_hi, t_lo, qhi, qlo + 1)
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


def _lower_scan(pvars, terms, mode: str):
    """Lower one pattern to a scan signature + constants."""
    s_sig, s_dyn = _lower_term(terms[0])
    p_sig, p_dyn = _lower_term(terms[1])
    o_sig, o_dyn = _lower_term(terms[2])
    dyn = {}
    if s_dyn is not None:
        dyn["s"] = s_dyn
    if p_dyn is not None:
        dyn["p"] = p_dyn
    if o_dyn is not None:
        dyn["o"] = o_dyn
    # litemat/full stores are compacted (no INVALID rows), so pure-interval
    # predicates on p/o can fuse into the compaction kernel's one pass
    fused = (
        mode in ("litemat", "full")
        and s_sig is None
        and (p_sig is None or p_sig.n_spills == 0)
        and (o_sig is None or o_sig.n_spills == 0)
    )
    return PatternSig(pvars=pvars, strategy="scan", s_sig=s_sig, p_sig=p_sig,
                      o_sig=o_sig, fused=fused), dyn


def _lexsort(cols):
    """Stable sort permutation by ``cols`` (cols[0] is the primary key)."""
    if len(cols) == 1:
        return torch.sort(cols[0], stable=True).indices
    perm = torch.sort(pair_key(cols[-2], cols[-1]), stable=True).indices
    for c in reversed(cols[:-2]):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return perm


def join(a: Relation, b: Relation, cap: int) -> Relation:
    """Sort-merge equi-join on all shared vars (first var = sort key)."""
    shared = [v for v in a.vars if v in b.vars]
    if not shared:
        raise ValueError("cartesian products not supported — reorder the plan")
    key = shared[0]

    # sort build side (a) by key; invalid rows sink
    ka = torch.where(a.valid, a.col(key), INVALID)
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
# The engine: host-side resolution + planning, device execution
# ---------------------------------------------------------------------------


@dataclass
class QueryEngine:
    kb: EncodedKB
    spo: torch.Tensor  # the store to query (lite / full)
    mode: str = "litemat"  # litemat | full
    dtb: DeviceTBox | None = None
    slack: float = 1.5
    use_index: bool = True  # resolve eligible patterns via sorted indexes
    use_inl: bool = True  # index-nested-loop joins when one side is tiny
    inl_factor: int = 8  # pattern must outweigh the probe side by this much
    inl_max_probe: int = 4096  # never INL above this probe-side estimate
    view: StoreView | None = None  # store view (None: static view of spo)
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
        if self.mode not in ("litemat", "full"):
            raise NotImplementedError(
                f"mode {self.mode!r}: only litemat and full are ported")
        if self.dtb is None and self.kb.tbox is not None:
            self.dtb = DeviceTBox.build(self.kb.tbox, device=self.spo.device)
        if self.view is None:
            self.view = StoreView.static(self.spo)

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
        """Resolve constants -> [(pvars, terms)]."""
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
            prepared.append((pvars, terms))
        return prepared

    # -- pattern lowering: strategy choice + cardinality ---------------------
    def _lower(self, pvars, terms):
        """-> (PatternSig, dyn, host count or None).

        ``count`` is exact and free (range lengths) for slice patterns;
        scan patterns report None and are counted by one device pass.
        """
        s_t, p_t, o_t = terms
        indexable = self.use_index
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
                    o_sig, o_dyn = _lower_term(o_t)
            elif s_t is not None and pid is not None:
                ranges = [r for a, b in s_t.intervals()
                          for r in view.ps_ranges(pid, a, b)]
                store = "pso"
                if o_t is not None:  # o re-checked on the gathered rows
                    residual = (2,)
                    o_sig, o_dyn = _lower_term(o_t)
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
                    o_sig, o_dyn = _lower_term(o_t)
                return self._slice_plan(pvars, ranges, "spo", residual,
                                        o_sig=o_sig, o_dyn=o_dyn)
            ranges = [r for a, b in o_t.intervals()
                      for r in view.o_ranges(a, b)]
            return self._slice_plan(pvars, ranges, "osp", ())
        sig, dyn = _lower_scan(pvars, terms, self.mode)
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
                return _scan_mask(_sig, ds.base, ds.base_alive, d).sum()
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
        indexable = self.use_inl and self.use_index
        if not indexable or len(order) < 2:
            return
        store_n = max(self.view.n, 1)
        bound = {v for v in prepared[order[0]][0] if v}
        est = counts[order[0]]
        ctx = [ckeys[order[0]]]  # probe provenance: const keys walked so far
        for i in order[1:]:
            pvars, terms = prepared[i]
            pat_vars = {v for v in pvars if v}
            heuristic = counts[i] >= self.inl_factor * max(est, 1)
            eligible = (
                est <= self.inl_max_probe
                and terms[1] is not None
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
                        r_sig, r_dyn = _lower_term(res_t)
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
        (sigs, dyns, caps, join_cap, sel, stores, order, est,
         buckets) = planned
        slabel = sig_label(sigs)
        for attempt in range(max_retries):
            key = ("exec", self.mode, sigs, tuple(caps), join_cap, sel)
            misses0 = self.cache_stats["misses"]
            fn = self._executable(key, sigs, tuple(caps), join_cap, sel)
            with obs_trace.span("dispatch",
                                cached=self.cache_stats["misses"] == misses0,
                                join_cap=join_cap) as dsp:
                t0 = time.perf_counter()
                cols, valid, overflow, totals = fn(stores, dyns)
                done = int(overflow) == 0  # waits for the device
                REGISTRY.histogram("query/exec_seconds", sig=slabel).observe(
                    time.perf_counter() - t0)
                dsp.set_attr(overflow=not done)
            if done:
                if attempt:
                    REGISTRY.histogram("join/capacity_depth", site="query",
                                       sig=slabel,
                                       shard="local").observe(attempt)
                self._record_observed(sigs, est, totals.tolist(), buckets)
                n = int(valid.sum())
                rows = cols[:, :n].T.cpu().numpy()
                return rows, sel
            obs_trace.event("overflow_retry", attempt=attempt,
                            join_cap=join_cap)
            REGISTRY.counter("query/overflow_retries").inc()
            REGISTRY.counter("join/capacity_retry", site="query", sig=slabel,
                             shard="local").inc()
            join_cap *= 2
            caps = [c * 2 for c in caps]
        raise RuntimeError("query kept overflowing its capacity buckets")

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
