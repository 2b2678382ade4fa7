"""Store views and their device buffers — the delta-free part.

Queries execute against a :class:`StoreView`.  In the JAX package a view is
an immutable base store plus a delta overlay with tombstones; this slice
ports the static store, which every query of the paper's pipeline already
runs through: a view whose range lookups return base ranges only, and
whose device arrays (:class:`DevStore`) carry ``delta=None``.  The
overlay (insert / delete / compact) fills in the same shapes later, so the
engine is not reshaped when it lands.

Range lookups return *lists* of ranges in combined [base | delta]
coordinates, as the reference's do; with no delta each list holds the one
base range.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.index import PERMUTATIONS, StoreIndex
from repro_torch.obs.metrics import REGISTRY


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


class DeviceStoreCache:
    """Per-store persistent device buffers.

    Delta-free here: ``sync`` hands out the base arrays with one shared
    all-alive mask per base, built once (``stats['base_rebuilds']``).
    """

    def __init__(self):
        self._states: dict = {}  # key -> (base token, DevStore)
        self._ones: dict = {}  # (token, n) -> shared all-alive mask
        self.stats = {"base_rebuilds": 0}

    def _all_alive(self, token: int, n: int, device) -> torch.Tensor:
        key = (token, n)
        if key not in self._ones:
            # evict masks of superseded bases
            self._ones = {k: v for k, v in self._ones.items() if k[0] == token}
            self._ones[key] = torch.ones(n, dtype=torch.bool, device=device)
        return self._ones[key]

    def sync(self, view: "StoreView", key: str) -> DevStore:
        token = view.base_index.token
        st = self._states.get(key)
        if st is None or st[0] != token:
            self.stats["base_rebuilds"] += 1
            REGISTRY.counter("device/base_rebuilds", src="store_cache").inc()
            base = view.base_array(key)
            ds = DevStore(base=base,
                          base_alive=self._all_alive(token, view.base_n,
                                                     base.device),
                          delta=None, delta_alive=None)
            st = (token, ds)
            self._states[key] = st
        return st[1]


def _one_off_dev(view: "StoreView", key: str, base) -> DevStore:
    """Cacheless DevStore build (static views, tests)."""
    return DevStore(base=base,
                    base_alive=torch.ones(view.base_n, dtype=torch.bool,
                                          device=base.device),
                    delta=None, delta_alive=None)


@dataclass
class StoreView:
    """What a QueryEngine executes against: a static base store."""

    base_rows: torch.Tensor  # device [Nb, 3] — the original store array
    base_h: np.ndarray  # host copy (shared with the base StoreIndex)
    base_index: StoreIndex | None = None
    cache: DeviceStoreCache | None = None  # persistent device buffers
    _dev: dict = field(default_factory=dict, repr=False)

    @classmethod
    def static(cls, spo: torch.Tensor) -> "StoreView":
        """A view over a plain store: no delta, no tombstones."""
        return cls(base_rows=spo, base_h=spo.cpu().numpy())

    def __post_init__(self):
        if self.base_index is None:
            self.base_index = StoreIndex(_h=self.base_h, _d=self.base_rows)

    # -- shape bookkeeping ---------------------------------------------------
    @property
    def base_n(self) -> int:
        return int(self.base_h.shape[0])

    @property
    def n(self) -> int:
        """Total addressable rows (planning upper bound)."""
        return self.base_n

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
        is attached (the KnowledgeBase path); otherwise built once per view.
        """
        if self.cache is not None:
            return self.cache.sync(self, key)
        if key not in self._dev:
            self._dev[key] = _one_off_dev(self, key, self.base_array(key))
        return self._dev[key]

    # -- range lookups (combined coordinates: the base range only) ------------
    def p_ranges(self, plo: int, phi: int):
        return [self.base_index.p_range(plo, phi)]

    def po_ranges(self, p_id: int, olo: int, ohi: int):
        return [self.base_index.po_range(p_id, olo, ohi)]

    def ps_ranges(self, p_id: int, slo: int, shi: int):
        return [self.base_index.ps_range(p_id, slo, shi)]

    def s_ranges(self, slo: int, shi: int):
        return [self.base_index.s_range(slo, shi)]

    def o_ranges(self, olo: int, ohi: int):
        return [self.base_index.o_range(olo, ohi)]

    def distinct_p_ids(self, plo: int, phi: int, limit: int = 8):
        """Distinct predicate ids in [plo, phi), or None past ``limit``."""
        return self.base_index.distinct_p_ids(plo, phi, limit)

    def single_p_run(self, plo: int, phi: int):
        """Unique predicate id inside [plo, phi), or None."""
        b0, b1 = self.base_index.p_range(plo, phi)
        return self.base_index.single_p_run(b0, b1)


__all__ = ["StoreView", "DevStore", "DeviceStoreCache"]
