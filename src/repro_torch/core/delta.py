"""Delta overlay: mutable state layered over immutable base triple stores.

LiteMat's interval encoding reserves unused local bits in every concept and
property id precisely so the KB can grow without re-encoding — this module
supplies the storage half of that promise.  A ``KnowledgeBase`` keeps its
base stores (raw / lite-materialized / fully-materialized) immutable and
routes every mutation through a :class:`DeltaKB`:

  * inserts append *encoded* rows to per-store :class:`DeltaLog` s
    (append-only, like an LSM memtable),
  * deletes flip per-row ``alive`` bits — tombstones — on both the base
    stores and the delta logs; nothing is moved until compaction.

Queries see the union through a :class:`StoreView`: host-side range lookups
run against the base :class:`StoreIndex` *and* a small delta index, and the
device work gathers from a *virtual* ``[base | delta]`` concatenation —
``StoreView.dev(key)`` hands the executor the base array and a
power-of-two-capacity delta bucket as SEPARATE device tensors, addressed in
combined coordinates (delta rows offset by the base row count).  Because
the base array is never re-concatenated, refreshing a view after a
mutation moves O(delta) rows, not O(base):

  * :class:`DeviceStoreCache` (one per store, owned by the KnowledgeBase,
    surviving version bumps) keeps each key's delta bucket resident and
    writes only the appended tail (scan order) or re-uploads the O(delta)
    bucket (permutation orders, whose sort interleaves on every append),
  * base tombstones are applied as in-place point scatters of the
    per-version kill events — O(#killed), never an O(base) mask re-upload,
  * buckets are powers of two, so the buffers are reallocated only when a
    bucket boundary is crossed.

``compact_view`` folds a delta into its base with one sorted-merge pass
over the POS permutation.  The device path runs the merge-path kernel
(kernels/merge_sorted.py) over the resident buffers and drops tombstones
with the stream-compaction kernel, so the merged store is assembled on the
device; the host only pulls the final array once to mirror it into the new
StoreIndex's search keys.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.index import (
    PERMUTATIONS, StoreIndex, merge_sorted, pad_rows as _pad_rows,
    pow2_bucket as _pow2,
)
from repro_torch.kernels import ops
from repro_torch.obs.ledger import tensor_record
from repro_torch.obs.metrics import REGISTRY

MODES = ("rewrite", "litemat", "full")  # raw / lite / full store names


@dataclass
class DeltaLog:
    """Append-only encoded triple log with a tombstone (``alive``) mask."""

    rows: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), dtype=np.int32))
    alive: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=bool))
    tombstone_mut: int = 0  # bumps whenever alive bits flip (device resync)

    @property
    def n(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_live(self) -> int:
        return int(self.alive.sum())

    def append(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.int32).reshape(-1, 3)
        self.rows = np.concatenate([self.rows, rows])
        self.alive = np.concatenate(
            [self.alive, np.ones(rows.shape[0], dtype=bool)])

    def tombstone(self, mask_or_idx) -> None:
        """Kill log rows by bool mask or index array.

        The mut counter bumps only when a bit actually flips — a no-op
        tombstone pass must not invalidate resident device buckets.
        """
        sel = self.alive[mask_or_idx]
        if sel.size == 0 or not sel.any():
            return
        self.alive[mask_or_idx] = False
        self.tombstone_mut += 1

    def live_rows(self) -> np.ndarray:
        return self.rows[self.alive]


@dataclass
class DeltaKB:
    """Mutable overlay for one KnowledgeBase: per-store logs + base tombstones.

    ``base_alive[mode]`` stays ``None`` (meaning all-alive) until the first
    delete touches that store, so insert-only workloads never materialize or
    ship O(base) masks.  ``kills[mode]`` records each delete's newly-killed
    base row indices (original store coordinates) so device caches can apply
    tombstones as point scatters instead of re-uploading O(base) masks.
    """

    logs: dict = field(default_factory=lambda: {m: DeltaLog() for m in MODES})
    base_alive: dict = field(
        default_factory=lambda: {m: None for m in MODES})
    kills: dict = field(default_factory=lambda: {m: [] for m in MODES})
    n_new_terms: int = 0

    def log(self, mode: str) -> DeltaLog:
        return self.logs[mode]

    def kill_base(self, mode: str, base_n: int, row_idx: np.ndarray) -> int:
        """Tombstone base rows by index; returns how many were newly killed."""
        row_idx = np.asarray(row_idx, dtype=np.int64).reshape(-1)
        if row_idx.size == 0:
            return 0  # never materialize the O(base) mask for a no-op
        if self.base_alive[mode] is None:
            self.base_alive[mode] = np.ones(base_n, dtype=bool)
        mask = self.base_alive[mode]
        newly = row_idx[mask[row_idx]]
        if newly.size:
            mask[newly] = False
            self.kills[mode].append(newly)
        return int(newly.size)

    def n_rows(self, mode: str) -> int:
        return self.logs[mode].n

    @property
    def empty(self) -> bool:
        return (
            all(log.n == 0 for log in self.logs.values())
            and all(a is None for a in self.base_alive.values())
        )

    def ratio(self, base_sizes: dict, extra_rows: int = 0) -> float:
        """Overlay pressure: (delta rows + base tombstones) / base rows.

        ``extra_rows`` accounts for insert batches whose lite/full
        materialization is still pending (lazy per-mode derivation).
        """
        num, den = extra_rows, 0
        for m in MODES:
            n_base = int(base_sizes.get(m, 0))
            den += n_base
            num += self.logs[m].n
            if self.base_alive[m] is not None:
                num += n_base - int(self.base_alive[m].sum())
        return num / max(den, 1)


# ---------------------------------------------------------------------------
# Device-resident [base | delta-bucket] buffers
# ---------------------------------------------------------------------------


@dataclass
class DevStore:
    """One key's device arrays, addressed in combined [base | delta] coords.

    ``delta``/``delta_alive`` are ``None`` for delta-free views, so static
    stores run single-source plans with no overlay overhead.
    """

    base: torch.Tensor  # [Nb, 3] (or the scan-order store itself)
    base_alive: torch.Tensor  # bool[Nb]
    delta: torch.Tensor | None  # [Dcap, 3], INVALID-padded; None = no delta
    delta_alive: torch.Tensor | None  # bool[Dcap]


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a NEW device tensor (never sharing the host buffer:
    resident buffers are updated in place, host logs must not see it)."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


def _pad_alive(alive: np.ndarray, cap: int) -> np.ndarray:
    pad = cap - alive.shape[0]
    if pad <= 0:
        return alive
    return np.concatenate([alive, np.zeros(pad, dtype=bool)])


def _delta_host(view: "StoreView", key: str):
    """(rows, alive) of the delta in ``key`` order — pure host, no uploads."""
    if key == "scan":
        return view.delta_h, view.delta_alive_h
    p = view.delta_index.perm(key)
    return view.delta_index._h[p.perm], view.delta_alive_h[p.perm]


@dataclass
class _DevState:
    """Cache entry: one (store, key) pair's resident buffers + provenance."""

    base_token: int
    base_alive: torch.Tensor
    n_kills: int
    delta: torch.Tensor | None
    delta_alive: torch.Tensor | None
    cap: int
    delta_len: int
    tombstone_mut: int
    owns_alive: bool = False  # True once base_alive is a private buffer
    leased: bool = False  # True while a pinned view may still hold this
    # base_alive buffer: the next kill batch copies it before scattering


def _kill_scatter(alive: torch.Tensor, idx: np.ndarray) -> None:
    """Tombstone point scatter, in place: O(#killed) device work and no
    base-sized allocation (the reference donates the buffer to XLA)."""
    alive.index_put_((torch.as_tensor(idx, device=alive.device),),
                     torch.zeros((), dtype=torch.bool, device=alive.device))


class DeviceStoreCache:
    """Per-store persistent device buffers, surviving KnowledgeBase versions.

    ``sync(view, key)`` brings the key's buffers up to the view's state with
    work *independent of the base size*: delta buckets are updated in place
    (appended tail for scan order, O(cap) re-upload for permutation orders)
    and base tombstones are applied as point scatters of the recorded kill
    events.  ``stats`` counts every host->device transfer in row units so
    tests can pin the O(delta) contract.
    """

    def __init__(self):
        self._states: dict = {}
        self._ones: dict = {}  # (token, n) -> shared all-alive mask
        self._lock = threading.RLock()  # sync() is reader-reentrant
        self.stats = {
            "base_rebuilds": 0,  # fresh states (new base / first touch)
            "delta_allocs": 0,  # delta bucket (re)allocations
            "upload_delta_rows": 0,  # delta rows shipped host->device
            "upload_alive_rows": 0,  # delta liveness bits shipped
            "upload_base_alive_rows": 0,  # full base masks shipped (fresh only)
            "kill_scatter_rows": 0,  # base tombstones applied as scatters
            "alive_privatize_rows": 0,  # one-time copies of the SHARED
            # all-alive mask before the first scatter into it
            "lease_copy_rows": 0,  # copies forced by a pinned view leasing
            # the resident mask (an in-place scatter would change its view)
            "stale_view_builds": 0,  # one-off builds for out-of-date views
        }

    def _stat(self, key: str, n: int = 1) -> None:
        """Bump the local dict AND the process registry mirror (row-unit
        uploads also feed ``device/transfer_bytes``: 12 B per [s,p,o] row,
        1 B per liveness bit)."""
        self.stats[key] += n
        REGISTRY.counter("device/" + key, src="store_cache").inc(n)
        if key == "upload_delta_rows":
            REGISTRY.counter("device/transfer_bytes",
                             src="store_cache").inc(n * 12)
        elif key in ("upload_alive_rows", "upload_base_alive_rows"):
            REGISTRY.counter("device/transfer_bytes",
                             src="store_cache").inc(n)

    def _all_alive(self, token: int, n: int, device) -> torch.Tensor:
        key = (token, n)
        if key not in self._ones:
            # evict masks of superseded bases: without this, every
            # compaction (new token) would pin another O(base) device
            # array here for the cache's lifetime
            self._ones = {k: v for k, v in self._ones.items()
                          if k[0] == token}
            self._ones[key] = torch.ones(n, dtype=torch.bool, device=device)
        return self._ones[key]

    def _upload_delta(self, view: "StoreView", key: str, cap: int):
        if not view.has_delta:
            return None, None  # delta-free: single-source plans
        rows, alive = _delta_host(view, key)
        self._stat("upload_delta_rows", cap)
        self._stat("upload_alive_rows", cap)
        self._stat("delta_allocs")
        dev = view.base_rows.device
        return (_upload(_pad_rows(rows, cap), dev),
                _upload(_pad_alive(alive, cap), dev))

    def _fresh(self, view: "StoreView", key: str, cap: int) -> _DevState:
        self._stat("base_rebuilds")
        token = view.base_index.token
        if view.base_alive_h is None:
            base_alive = self._all_alive(token, view.base_n,
                                         view.base_rows.device)
        else:
            alive_h = (view.base_alive_h if key == "scan"
                       else view.base_alive_h[view.base_index.perm(key).perm])
            self._stat("upload_base_alive_rows", view.base_n)
            base_alive = _upload(alive_h, view.base_rows.device)
        delta, dalive = self._upload_delta(view, key, cap)
        return _DevState(
            base_token=token, base_alive=base_alive,
            n_kills=len(view.kills), delta=delta, delta_alive=dalive,
            cap=cap if delta is not None else 0, delta_len=view.delta_n,
            tombstone_mut=view.delta_mut,
            owns_alive=view.base_alive_h is not None,
        )

    def sync(self, view: "StoreView", key: str) -> DevStore:
        # the lock makes resident-state updates atomic, so a concurrent
        # reader never observes a half-applied delta splice
        with self._lock:
            return self._sync_locked(view, key)

    def _sync_locked(self, view: "StoreView", key: str) -> DevStore:
        base = view.base_array(key)
        token = view.base_index.token
        cap = _pow2(view.delta_n) if view.has_delta else 0
        st = self._states.get(key)

        if st is not None and (
                token < st.base_token  # tokens are monotonic: older base
                or (st.base_token == token and (
                    view.delta_n < st.delta_len
                    or len(view.kills) < st.n_kills
                    or view.delta_mut < st.tombstone_mut))):
            # a view older than the resident state (held across later
            # mutations or a compaction): serve it a one-off build, never
            # rewind the cache
            self._stat("stale_view_builds")
            return _one_off_dev(view, key, base)

        if st is None or st.base_token != token:
            st = self._fresh(view, key, cap)
            self._states[key] = st
        else:
            if cap != st.cap:
                # bucket boundary crossed (or first delta after an empty
                # state): reallocate the delta bucket (O(new cap)); the
                # base array is untouched either way
                st.delta, st.delta_alive = self._upload_delta(view, key, cap)
                st.cap, st.delta_len = cap, view.delta_n
                st.tombstone_mut = view.delta_mut
            elif st.delta is not None and (
                    view.delta_n != st.delta_len
                    or view.delta_mut != st.tombstone_mut):
                grew = view.delta_n - st.delta_len
                dev = st.delta.device
                if grew > 0:
                    if key == "scan":
                        # append order: write ONLY the appended tail, in
                        # place — earlier DevStores keep their own alive
                        # buffers, in which these slots are dead padding
                        tail = np.asarray(view.delta_h[st.delta_len:],
                                          dtype=np.int32)
                        st.delta[st.delta_len:view.delta_n] = _upload(tail,
                                                                      dev)
                        self._stat("upload_delta_rows", grew)
                    else:
                        rows, _ = _delta_host(view, key)
                        st.delta = _upload(_pad_rows(rows, cap), dev)
                        self._stat("upload_delta_rows", cap)
                # grew == 0 means a tombstone-only change: the log is
                # append-only, so the resident row buckets are already
                # correct in every order — refresh just the alive bits
                _, alive = _delta_host(view, key)
                st.delta_alive = _upload(_pad_alive(alive, cap), dev)
                self._stat("upload_alive_rows", cap)
                st.delta_len = view.delta_n
                st.tombstone_mut = view.delta_mut
            if len(view.kills) > st.n_kills:
                idx = np.concatenate(view.kills[st.n_kills:])
                if key != "scan":
                    idx = view.base_index.inv_perm(key)[idx]
                if not st.owns_alive or st.leased:
                    # the resident mask is either the SHARED all-alive
                    # buffer or LEASED to a pinned view: copy it once so the
                    # in-place scatter below touches a private buffer
                    stat = ("lease_copy_rows" if st.owns_alive
                            else "alive_privatize_rows")
                    st.base_alive = st.base_alive.clone()
                    st.owns_alive = True
                    st.leased = False
                    self._stat(stat, int(st.base_alive.shape[0]))
                _kill_scatter(st.base_alive, idx)
                self._stat("kill_scatter_rows", int(idx.shape[0]))
                st.n_kills = len(view.kills)

        if view.pinned:
            # a pinned view now references the resident buffers: mark the
            # base mask leased so the next delete copies instead of
            # scattering into it
            st.leased = True
        return DevStore(base=base, base_alive=st.base_alive,
                        delta=st.delta, delta_alive=st.delta_alive)

    def buffer_shapes(self, key: str):
        """(delta bucket shape, capacity) — test hook for the O(delta) pins."""
        st = self._states.get(key)
        if st is None:
            return None
        shape = (0, 3) if st.delta is None else tuple(st.delta.shape)
        return shape, st.cap

    def device_buffers(self) -> list:
        """Resident tensors as ledger records (``obs/ledger.py``).

        Power-of-two delta buckets under ``delta``; liveness masks (delta,
        privatized base, and the shared all-alive masks) under ``alive``.
        Records are keyed by storage, so the ledger dedupes a mask a
        snapshot still leases.  Walks existing state only; reads no
        tensor's values.
        """
        out = []
        with self._lock:
            for st in self._states.values():
                if st.delta is not None:
                    out.append(tensor_record("delta", st.delta))
                    out.append(tensor_record("alive", st.delta_alive))
                if st.owns_alive:
                    out.append(tensor_record("alive", st.base_alive))
            for mask in self._ones.values():
                out.append(tensor_record("alive", mask))
        return out


def _one_off_dev(view: "StoreView", key: str, base) -> DevStore:
    """Cacheless DevStore build (static views, stale views, tests)."""
    dev = base.device
    if view.base_alive_h is None:
        base_alive = torch.ones(view.base_n, dtype=torch.bool, device=dev)
    else:
        alive_h = (view.base_alive_h if key == "scan"
                   else view.base_alive_h[view.base_index.perm(key).perm])
        base_alive = _upload(alive_h, dev)
    if not view.has_delta:
        delta = dalive = None
    else:
        cap = _pow2(view.delta_n)
        rows, alive = _delta_host(view, key)
        delta = _upload(_pad_rows(rows, cap), dev)
        dalive = _upload(_pad_alive(alive, cap), dev)
    return DevStore(base=base, base_alive=base_alive,
                    delta=delta, delta_alive=dalive)


# ---------------------------------------------------------------------------
# StoreView: what a QueryEngine executes against
# ---------------------------------------------------------------------------


@dataclass
class StoreView:
    """Union of an immutable base store and a (small) delta overlay.

    Presents the same range-lookup surface as StoreIndex, but every lookup
    returns a *list* of ranges in combined coordinates: base ranges first,
    then delta ranges offset by the base row count.  Device consumers call
    ``dev(key)`` for the matching :class:`DevStore` — base array plus a
    power-of-two delta bucket as separate device tensors (INVALID rows and
    ``alive=False`` padding).
    """

    base_rows: torch.Tensor  # device [Nb, 3] — the original store array
    base_h: np.ndarray  # host copy (shared with the base StoreIndex)
    base_alive_h: np.ndarray | None = None  # None = every base row live
    delta_h: np.ndarray | None = None  # host [M, 3] delta log rows
    delta_alive_h: np.ndarray | None = None  # bool[M]
    base_index: StoreIndex | None = None
    cache: DeviceStoreCache | None = None  # persistent device buffers
    kills: tuple = ()  # snapshot of DeltaKB.kills[mode] (original coords)
    delta_mut: int = 0  # DeltaLog.tombstone_mut at snapshot time
    pinned: bool = False  # the cache copies (never scatters into) any
    # resident mask it hands this view — see DeviceStoreCache.sync
    _delta_index: StoreIndex | None = field(default=None, repr=False)
    _dev: dict = field(default_factory=dict, repr=False)

    @classmethod
    def static(cls, spo: torch.Tensor) -> "StoreView":
        """A view over a plain store: no delta, no tombstones."""
        return cls(base_rows=spo, base_h=spo.cpu().numpy())

    @classmethod
    def overlay(cls, base_rows: torch.Tensor, base_index: StoreIndex,
                log: DeltaLog, base_alive: np.ndarray | None,
                cache: DeviceStoreCache | None = None,
                kills: tuple = ()) -> "StoreView":
        # snapshot the liveness masks: deletes flip tombstone bits IN PLACE
        # on the DeltaKB arrays, and a view must stay a consistent snapshot
        # of its version even if it is held across later mutations
        return cls(
            base_rows=base_rows,
            base_h=base_index._h,
            base_alive_h=None if base_alive is None else base_alive.copy(),
            delta_h=log.rows if log.n else None,
            delta_alive_h=log.alive.copy() if log.n else None,
            base_index=base_index,
            cache=cache,
            kills=tuple(kills),
            delta_mut=log.tombstone_mut,
        )

    def __post_init__(self):
        if self.base_index is None:
            self.base_index = StoreIndex(_h=self.base_h, _d=self.base_rows)

    # -- shape bookkeeping ---------------------------------------------------
    @property
    def base_n(self) -> int:
        return int(self.base_h.shape[0])

    @property
    def delta_n(self) -> int:
        return 0 if self.delta_h is None else int(self.delta_h.shape[0])

    @property
    def delta_cap(self) -> int:
        """Power-of-two bucket the delta side is padded to on device."""
        return _pow2(self.delta_n)

    @property
    def has_delta(self) -> bool:
        return self.delta_n > 0

    @property
    def n(self) -> int:
        """Total addressable rows (planning upper bound, tombstones included)."""
        return self.base_n + self.delta_n

    @property
    def n_live(self) -> int:
        live = self.base_n if self.base_alive_h is None else int(
            self.base_alive_h.sum())
        if self.delta_alive_h is not None:
            live += int(self.delta_alive_h.sum())
        return live

    def live_rows(self) -> np.ndarray:
        """Host compaction of the view: all live rows, base-then-delta order."""
        base = (self.base_h if self.base_alive_h is None
                else self.base_h[self.base_alive_h])
        if self.delta_h is None:
            return base
        return np.concatenate([base, self.delta_h[self.delta_alive_h]])

    @property
    def delta_index(self) -> StoreIndex:
        """Sorted permutations of the delta rows (sorted on the device)."""
        if self._delta_index is None:
            self._delta_index = StoreIndex(
                _h=self.delta_h,
                _d=_upload(self.delta_h, self.base_rows.device))
        return self._delta_index

    # -- device views --------------------------------------------------------
    def base_array(self, key: str) -> torch.Tensor:
        """The device rows of one key: the store ('scan') or a permutation."""
        if key == "scan":
            return self.base_rows
        if key not in PERMUTATIONS:
            raise KeyError(key)
        return self.base_index.perm(key).rows

    def dev(self, key: str) -> DevStore:
        """Device arrays of one view key ('scan' or a permutation name).

        Routed through the owning store's :class:`DeviceStoreCache` when one
        is attached (the live KnowledgeBase path — O(delta) refresh);
        otherwise built once per view and memoized (static stores, tests).
        """
        if self.cache is not None:
            return self.cache.sync(self, key)
        if key not in self._dev:
            self._dev[key] = _one_off_dev(self, key, self.base_array(key))
        return self._dev[key]

    def warm_device(self, keys=("scan", "pos")):
        """Materialize device buffers for ``keys``; returns them once the
        device has finished (the post-mutation warmup unit)."""
        out = [self.dev(k) for k in keys]
        if self.base_rows.device.type == "cuda":
            torch.cuda.synchronize(self.base_rows.device)
        return out

    def device_buffers(self) -> list:
        """Tensors this view references, as ledger records: the base rows,
        the base index's permutation rows, and the one-off
        :class:`DevStore` memos (static views).  Cache-routed buffers are
        reported by the owning :class:`DeviceStoreCache`."""
        out = [tensor_record("base", self.base_rows)]
        for p in list(self.base_index._perms.values()):
            out.append(tensor_record("base", p.rows))
        for ds in list(self._dev.values()):
            out.append(tensor_record("base", ds.base))
            out.append(tensor_record("alive", ds.base_alive))
            if ds.delta is not None:
                out.append(tensor_record("delta", ds.delta))
                out.append(tensor_record("alive", ds.delta_alive))
        return out

    # -- combined range lookups ---------------------------------------------
    def _combine(self, base_range, delta_range):
        out = [base_range]
        if self.has_delta:
            r0, r1 = delta_range
            out.append((self.base_n + r0, self.base_n + r1))
        return out

    def p_ranges(self, plo: int, phi: int):
        return self._combine(
            self.base_index.p_range(plo, phi),
            self.delta_index.p_range(plo, phi) if self.has_delta else None)

    def po_ranges(self, p_id: int, olo: int, ohi: int):
        return self._combine(
            self.base_index.po_range(p_id, olo, ohi),
            self.delta_index.po_range(p_id, olo, ohi) if self.has_delta else None)

    def ps_ranges(self, p_id: int, slo: int, shi: int):
        return self._combine(
            self.base_index.ps_range(p_id, slo, shi),
            self.delta_index.ps_range(p_id, slo, shi) if self.has_delta else None)

    def s_ranges(self, slo: int, shi: int):
        return self._combine(
            self.base_index.s_range(slo, shi),
            self.delta_index.s_range(slo, shi) if self.has_delta else None)

    def o_ranges(self, olo: int, ohi: int):
        return self._combine(
            self.base_index.o_range(olo, ohi),
            self.delta_index.o_range(olo, ohi) if self.has_delta else None)

    def distinct_p_ids(self, plo: int, phi: int, limit: int = 8):
        """Distinct predicate ids in [plo, phi) across base AND delta, or
        None when either side is too mixed (past ``limit``)."""
        base = self.base_index.distinct_p_ids(plo, phi, limit)
        if base is None:
            return None
        if not self.has_delta:
            return base
        extra = self.delta_index.distinct_p_ids(plo, phi, limit)
        if extra is None:
            return None
        out = sorted(set(base) | set(extra))
        return out if len(out) <= limit else None

    def single_p_run(self, plo: int, phi: int):
        """Unique predicate id inside [plo, phi) across base AND delta."""
        b0, b1 = self.base_index.p_range(plo, phi)
        pid = self.base_index.single_p_run(b0, b1)
        if not self.has_delta:
            return pid
        r0, r1 = self.delta_index.p_range(plo, phi)
        dpid = self.delta_index.single_p_run(r0, r1)
        if r1 <= r0:  # delta has no rows in the interval: base decides
            return pid
        if b1 <= b0:  # base empty: delta decides
            return dpid
        return pid if (pid is not None and pid == dpid) else None


# ---------------------------------------------------------------------------
# Compaction: fold a view into a fresh base store
# ---------------------------------------------------------------------------


def compact_view(view: StoreView, device: bool = False):
    """Merge a view's live rows -> (device rows, pre-sorted StoreIndex).

    The merged array is produced in POS order with one sorted-merge pass
    (base POS run ⋈ delta POS run), so the returned index gets its POS
    permutation for free; tombstones are dropped during the merge.  The
    other permutations stay lazy in the new index.

    ``device=True`` runs the merge on the device: the merge-path kernel
    computes the interleave over the resident [base | delta] buffers, the
    stream-compaction kernel drops tombstones, and the merged store is
    materialized by device gathers — bit-identical to the host path.
    """
    if device:
        return _compact_view_device(view)
    base_idx = view.base_index
    bp = base_idx.perm("pos")
    b_keep = (slice(None) if view.base_alive_h is None
              else view.base_alive_h[bp.perm])
    b_rows, b_key = base_idx._h[bp.perm][b_keep], bp.key[b_keep]
    merged = b_rows
    if view.has_delta:
        dp = view.delta_index.perm("pos")
        d_keep = view.delta_alive_h[dp.perm]
        merged, _ = merge_sorted(
            b_rows, b_key, view.delta_h[dp.perm][d_keep], dp.key[d_keep])
    merged = np.ascontiguousarray(merged)
    dev_rows = _upload(merged, view.base_rows.device)
    idx = StoreIndex.from_sorted(merged, "pos", dev_rows=dev_rows)
    return dev_rows, idx


def _compact_view_device(view: StoreView):
    """Device-side compaction over the resident POS buffers."""
    ds = view.dev("pos")
    if ds.delta is None:  # tombstone-only fold: no merge, just compact
        dk = torch.zeros(0, dtype=torch.int32, device=ds.base.device)
        gidx = ops.merge_gather(ds.base[:, 1], ds.base[:, 2], dk, dk)
        alive = ops.two_source_gather(ds.base_alive, None, gidx)
    else:
        # merge EVERYTHING (tombstones and bucket padding included: INVALID
        # keys sort last and are dead) then compact by liveness — a stable
        # merge followed by a stable filter equals the merge of the
        # filtered runs
        gidx = ops.merge_gather(ds.base[:, 1], ds.base[:, 2],
                                ds.delta[:, 1], ds.delta[:, 2])
        alive = ops.two_source_gather(ds.base_alive, ds.delta_alive, gidx)
    n_live = view.n_live
    take, _, _ = ops.compact_indices(alive, _pow2(n_live))
    src = gidx[take[:n_live].long()]
    merged_dev = ops.two_source_gather(ds.base, ds.delta, src)
    merged_h = merged_dev.cpu().numpy()
    idx = StoreIndex.from_sorted(merged_h, "pos", dev_rows=merged_dev)
    return merged_dev, idx


__all__ = ["DeltaLog", "DeltaKB", "StoreView", "DevStore", "DeviceStoreCache",
           "compact_view", "MODES", "PERMUTATIONS"]
