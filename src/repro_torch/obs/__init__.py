"""repro_torch.obs — the telemetry the ported layers report into.

Six small modules, imported lazily by the layers they instrument:

  * :mod:`repro_torch.obs.metrics` — counters / gauges / log-bucketed
    histogram sketches; the module-level ``REGISTRY`` is the process-wide
    default.  Histogram states merge bucket-wise, and
    ``mergeable_snapshot()`` emits the cross-process wire form.
  * :mod:`repro_torch.obs.trace` — per-request span trees propagated via
    contextvars; ``span(...)`` is a cheap no-op when no trace is active.
  * :mod:`repro_torch.obs.export` — JSON dumps plus the trace and metrics
    snapshot schema validators (``scripts/check_traces.py`` runs them).
  * :mod:`repro_torch.obs.aggregate` — combines per-process mergeable
    snapshots into ONE fleet snapshot.
  * :mod:`repro_torch.obs.ledger` — pull-based device-memory accounting
    over torch storages: ``hbm_bytes{shard,component}`` and
    ``store/bytes_per_triple`` gauges from weakly tracked owners.
  * :mod:`repro_torch.obs.slo` — windowed rollups (rates as first-class
    series) and error-budget burn-rate monitoring that drives the
    serving runtime's admission control.

All but the ledger are copies of the JAX package's modules of the same
names, wire schemas included; the ledger keys its records on storages
instead of Python object ids.
"""
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import Tracer, activate, event, span  # noqa: F401

__all__ = ["REGISTRY", "MetricsRegistry", "Tracer", "activate", "event",
           "span"]
