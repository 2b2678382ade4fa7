"""Device resource accounting: who holds how many device bytes, in what.

The store's device memory is scattered across base tensors, lazily built
sorted permutations, power-of-two delta buckets, liveness masks, and
pinned snapshots leasing superseded bases.  The :class:`ResourceLedger`
makes "how many device bytes does this store hold, and in what?" a gauge
read:

  * components (``core/delta.py``, ``core/engine.py``,
    ``core/snapshot.py``) expose a side-effect-free ``device_buffers()``
    walk of the tensors they currently reference, each record made by
    :func:`tensor_record` as ``(component, storage key, nbytes)``;
  * owners register with :meth:`ResourceLedger.track` under a shard
    name; the ledger holds only a **weakref** (a dropped store
    unregisters itself — telemetry must never extend object lifetimes);
  * :meth:`ResourceLedger.sample` walks every tracked owner, **dedupes
    records globally by key** (a snapshot pinning the live base, or a
    permutation that IS the store tensor, counts ONCE — attribution goes
    to the first owner in registration order), and publishes the result
    as gauges:

      ``hbm_bytes{shard=S,component=C}``   resident bytes per component
      ``store/live_triples{shard=S}``      live triples per shard
      ``store/bytes_per_triple``           fleet total bytes / total live
                                           triples

A torch tensor is a view: a slice, ``.T``, ``.view`` or a permutation
that is the store tensor itself shares one storage under another Python
object.  So a record's key is its storage — ``untyped_storage().data_ptr()``
on its device — and its bytes are the storage's, the memory held, not
the view's ``numel * itemsize``.  The key also holds the storage, so no
pointer recorded in a sample can be freed and reused before the sample
ends.  Nothing here reads a tensor's values: a sample never synchronizes
the device.

Sampling is pull-based: nothing in the mutation/query hot path pays for
accounting; the :class:`~repro_torch.obs.slo.TelemetryRollup` thread (or a
test, or a bench) calls ``sample()`` at its own cadence.
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field

from repro_torch.obs.metrics import REGISTRY


@dataclass(frozen=True)
class StorageKey:
    """A storage's identity, ``(device, data_ptr)``, holding the storage
    itself so the pointer stays unique while the key lives."""

    device: str
    ptr: int
    storage: object = field(compare=False, repr=False)


def tensor_record(component: str, t) -> tuple:
    """The ledger record of tensor ``t``'s memory: ``(component,
    StorageKey, storage nbytes)``.  Metadata only — no device sync."""
    s = t.untyped_storage()
    return component, StorageKey(str(t.device), s.data_ptr(), s), s.nbytes()


class ResourceLedger:
    """Weakref registry of device-buffer owners + gauge publication."""

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._owners: list = []  # (handle, shard, weakref) in track order
        self._next_handle = 1
        self._published: set = set()  # gauge keys we set last sample
        self.registry = registry if registry is not None else REGISTRY

    def track(self, shard, owner) -> int:
        """Track ``owner`` (anything with ``device_buffers()``) under a
        shard name; returns a handle for :meth:`untrack`.  Only a weak
        reference is kept — garbage-collected owners drop out of the next
        sample automatically."""
        with self._lock:
            h = self._next_handle
            self._next_handle += 1
            self._owners.append((h, str(shard), weakref.ref(owner)))
            return h

    def untrack(self, handle: int) -> None:
        with self._lock:
            self._owners = [o for o in self._owners if o[0] != handle]

    def clear(self) -> None:
        """Drop every tracked owner (test isolation)."""
        with self._lock:
            self._owners = []
            self._published = set()

    def sample(self) -> dict:
        """Walk owners, dedupe records by storage key, publish gauges.

        Returns ``{"shards": {S: {"components": {C: bytes}, "triples": n,
        "total": bytes}}, "total_bytes": b, "total_triples": n,
        "bytes_per_triple": b/n}`` — the same numbers the gauges carry,
        for direct (test/report) consumption.
        """
        with self._lock:
            owners = list(self._owners)
        shards: dict = {}
        seen_keys: set = set()
        dead = []
        for handle, shard, ref in owners:
            obj = ref()
            if obj is None:
                dead.append(handle)
                continue
            rec = shards.setdefault(
                shard, {"components": {}, "triples": 0, "total": 0})
            for component, key, nbytes in obj.device_buffers():
                if key is not None:
                    if key in seen_keys:
                        continue  # shared storage: first owner keeps it
                    seen_keys.add(key)
                nbytes = int(nbytes)
                comps = rec["components"]
                comps[component] = comps.get(component, 0) + nbytes
                rec["total"] += nbytes
            n_live = getattr(obj, "n_live_triples", None)
            if callable(n_live):
                rec["triples"] += int(n_live())
        if dead:
            with self._lock:
                self._owners = [o for o in self._owners if o[0] not in dead]

        published = set()
        for shard, rec in shards.items():
            for component, nbytes in rec["components"].items():
                key = ("hbm_bytes", shard, component)
                published.add(key)
                self.registry.gauge("hbm_bytes", shard=shard,
                                    component=component).set(nbytes)
            key = ("store/live_triples", shard, None)
            published.add(key)
            self.registry.gauge("store/live_triples",
                                shard=shard).set(rec["triples"])
        # zero gauges that existed last sample but vanished (a dropped
        # store must not leave a stale byte count behind)
        for key in self._published - published:
            name, shard, component = key
            if component is None:
                self.registry.gauge(name, shard=shard).set(0)
            else:
                self.registry.gauge(name, shard=shard,
                                    component=component).set(0)
        self._published = published

        total_bytes = sum(r["total"] for r in shards.values())
        total_triples = sum(r["triples"] for r in shards.values())
        bpt = total_bytes / total_triples if total_triples else 0.0
        self.registry.gauge("store/hbm_bytes_total").set(total_bytes)
        self.registry.gauge("store/bytes_per_triple").set(bpt)
        return {"shards": shards, "total_bytes": total_bytes,
                "total_triples": total_triples, "bytes_per_triple": bpt}


#: Process-wide default ledger: KnowledgeBase and SnapshotRegistry
#: register themselves here (weakly).
LEDGER = ResourceLedger()

__all__ = ["ResourceLedger", "LEDGER", "StorageKey", "tensor_record"]
