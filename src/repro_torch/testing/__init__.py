"""Test-support runtime pieces importable from production code paths.

The only module here with production call sites is
:mod:`repro_torch.testing.faults` — the deterministic fault-injection
harness (a copy of the JAX package's).  Its instrumented sites cost one
global read + one ``is None`` branch when no injector is armed.
"""
