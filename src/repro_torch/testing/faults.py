"""Deterministic fault-injection harness for the concurrent read/write path.

The serving runtime's robustness claims — a mid-flush crash never corrupts a
published snapshot, a slow shard turns into a deadline miss instead of a
hang, a pinned reader survives insert/delete/compact, snapshot retirement
never races a pin — are only testable if the failures themselves are
*reproducible*.  This module supplies hook-driven injection with no wall
clock and no randomness in the trigger logic:

  * Production code marks **sites** with ``faults.fire("site.name", **ctx)``.
    With no injector installed this is one global read and an ``is None``
    branch — free to ship in hot paths.
  * Tests install a :class:`FaultInjector` (via the :func:`inject` context
    manager) and **arm** faults against sites: raise an exception class,
    sleep a fixed delay, or both, starting at the Nth hit and firing a
    bounded number of times.  Trigger decisions depend only on per-site hit
    counters, so a failing schedule replays exactly.
  * Every hit and every firing is recorded (site, hit index, context) so
    tests can assert the fault actually happened — a matrix leg that
    silently stopped injecting is itself a test failure.

Instrumented sites (grep for ``faults.fire``):

  ``engine.flush_mat``        per derived batch inside KnowledgeBase._flush_mat
  ``shard.flush_mat``         per derived batch inside ShardedKB._flush
  ``shard.query_shard``       per routed shard before its plan body is
                              enqueued (slow shard)
  ``shard.exchange``          before a repartition join's exchange
  ``shard.ingest_encode``     per part inside ShardedKB.ingest's encode step
  ``snapshot.publish``        inside SnapshotRegistry publish (holding locks)
  ``snapshot.retire``         between victim selection and removal (race window)
  ``serving.execute``         per attempt inside the runtime worker

:class:`FaultError` is the *transient* marker: retry loops (serving runtime,
ingest) treat it as recoverable; anything else propagates.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


class FaultError(RuntimeError):
    """Injected transient failure — retryable by design."""


class FaultCrash(RuntimeError):
    """Injected hard failure — NOT retryable; models a crashed writer."""


@dataclass
class Fault:
    """One armed failure: fires on hits ``after < hit_index <= after+times``."""

    site: str
    exc: type | None = None  # exception class to raise (None: delay only)
    delay_s: float = 0.0  # sleep before (possibly) raising — "slow shard"
    after: int = 0  # skip this many hits before the first firing
    times: int = 1  # how many consecutive hits fire (<=0: every hit)
    message: str = ""
    fired: int = 0

    def should_fire(self, hit_index: int) -> bool:
        if hit_index <= self.after:
            return False
        return self.times <= 0 or hit_index <= self.after + self.times


@dataclass
class FaultInjector:
    """Armed fault set + per-site hit accounting (thread-safe)."""

    faults: dict = field(default_factory=dict)  # site -> list[Fault]
    hits: dict = field(default_factory=dict)  # site -> total hit count
    log: list = field(default_factory=list)  # (site, hit, kind, ctx) tuples
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def arm(self, site: str, exc: type | None = FaultError,
            delay_s: float = 0.0, after: int = 0, times: int = 1,
            message: str = "") -> Fault:
        f = Fault(site=site, exc=exc, delay_s=delay_s, after=after,
                  times=times, message=message or f"injected fault at {site}")
        with self._lock:
            self.faults.setdefault(site, []).append(f)
        return f

    def fire(self, site: str, **ctx) -> None:
        """Record a hit at ``site``; sleep/raise if an armed fault matches."""
        with self._lock:
            hit = self.hits.get(site, 0) + 1
            self.hits[site] = hit
            armed = [f for f in self.faults.get(site, ())
                     if f.should_fire(hit)]
            for f in armed:
                f.fired += 1
            self.log.append((site, hit, "fired" if armed else "hit", ctx))
        for f in armed:  # sleep/raise OUTSIDE the lock: sites overlap
            if f.delay_s:
                time.sleep(f.delay_s)
            if f.exc is not None:
                raise f.exc(f"{f.message} (site={site} hit={hit} ctx={ctx})")

    def fired(self, site: str) -> int:
        with self._lock:
            return sum(f.fired for f in self.faults.get(site, ()))

    def hit_count(self, site: str) -> int:
        with self._lock:
            return self.hits.get(site, 0)


_ACTIVE: FaultInjector | None = None
_INSTALL_LOCK = threading.Lock()


def fire(site: str, **ctx) -> None:
    """Production-side hook: no-op unless a test installed an injector."""
    inj = _ACTIVE
    if inj is not None:
        inj.fire(site, **ctx)


def install(injector: FaultInjector | None = None) -> FaultInjector:
    global _ACTIVE
    with _INSTALL_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a FaultInjector is already installed")
        _ACTIVE = injector or FaultInjector()
        return _ACTIVE


def uninstall() -> None:
    global _ACTIVE
    with _INSTALL_LOCK:
        _ACTIVE = None


class inject:
    """``with faults.inject() as inj: inj.arm(...)`` — scoped installation."""

    def __init__(self, injector: FaultInjector | None = None):
        self._injector = injector

    def __enter__(self) -> FaultInjector:
        self._injector = install(self._injector)
        return self._injector

    def __exit__(self, *exc) -> None:
        uninstall()


__all__ = ["Fault", "FaultInjector", "FaultError", "FaultCrash", "fire",
           "install", "uninstall", "inject"]
