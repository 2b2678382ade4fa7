"""repro_torch.obs — the telemetry the ported layers report into.

  * :mod:`repro_torch.obs.metrics` — counters / gauges / log-bucketed
    histogram sketches; the module-level ``REGISTRY`` is the process-wide
    default.
  * :mod:`repro_torch.obs.trace` — per-request span trees propagated via
    contextvars; ``span(...)`` is a cheap no-op when no trace is active.

Both are copies of the JAX package's modules of the same names.
"""
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import Tracer, activate, event, span  # noqa: F401

__all__ = ["REGISTRY", "MetricsRegistry", "Tracer", "activate", "event",
           "span"]
