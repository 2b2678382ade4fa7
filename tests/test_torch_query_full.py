"""Port parity, the whole slice in full mode: the engine and facade tests of
tests/test_torch_query.py (its fixtures, imported here) over the fully
materialized LUBM-1 store."""
from test_torch_query import (  # noqa: F401  (fixtures and tests collected here)
    kbs, reference_runs, test_engine_matches_reference,
    test_facade_answers_match,
)

MODE = "full"
