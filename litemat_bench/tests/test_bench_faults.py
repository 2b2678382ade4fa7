"""A run with the timed path broken underneath comes out not correct, and so
does the control (the reference in the program's place, set semantics
dropped).  Each fault is planted in the program for this process only."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from litemat_bench import control
from litemat_bench.run import run_cell


def _facets_unchanged(monkeypatch):
    """The plan's dedup step hands back its input: every type row counts."""
    from repro_torch.serving import engine

    def unchanged(hits, topk):
        h = torch.sort(hits, dim=1).values
        top = h[:, :topk]
        return ((h != engine.INVALID).sum(1, dtype=torch.int32),
                torch.where(top == engine.INVALID, -1, top))
    monkeypatch.setattr(engine, "_distinct_count_topk", unchanged)


def _facets_half_batch(monkeypatch):
    """A server call answers the first half of its batch; the rest get
    nothing."""
    from repro_torch.serving.engine import QueryServer

    def halve(orig):
        def call(self, *lists):
            n = (len(lists[0]) + 1) // 2
            counts, members = orig(self, *(x[:n] for x in lists))
            pad = len(lists[0]) - n
            return (np.concatenate([counts, np.zeros(pad, counts.dtype)]),
                    np.concatenate([members, np.full((pad, members.shape[1]),
                                                     -1, members.dtype)]))
        return call
    for name in ("class_members", "class_prop_join"):
        monkeypatch.setattr(QueryServer, name,
                            halve(getattr(QueryServer, name)))


def _facets_altered(monkeypatch):
    """One answer's count is off by one where the server produces it."""
    from repro_torch.serving.engine import QueryServer
    orig = QueryServer.class_members

    def call(self, names):
        counts, members = orig(self, names)
        counts = counts.copy()
        counts[0] += 1
        return counts, members
    monkeypatch.setattr(QueryServer, "class_members", call)


def _load_unchanged(monkeypatch):
    """Lite materialisation returns the encoded store unchanged."""
    from repro_torch.core import engine

    def unchanged(kb, dtb=None):
        return kb.spo, torch.ones(kb.spo.shape[0], dtype=torch.bool), {}
    monkeypatch.setattr(engine, "lite_materialize", unchanged)


def _load_half_batch(monkeypatch):
    """The encode takes the first half of the raw rows only."""
    from repro_torch.core import engine
    from repro_torch.rdf.generator import RawDataset
    orig = engine.encode_obe

    def half(raw, tbox, device=None):
        n = raw.n_triples // 2
        return orig(RawDataset(s=raw.s[:n], p=raw.p[:n], o=raw.o[:n],
                               onto=raw.onto), tbox, device=device)
    monkeypatch.setattr(engine, "encode_obe", half)


def _load_altered(monkeypatch):
    """One row of each compacted store has its object altered."""
    from repro_torch.core import engine
    orig = engine.compact_rows

    def altered(rows, valid):
        out = orig(rows, valid).clone()
        out[0, 2] += 1
        return out
    monkeypatch.setattr(engine, "compact_rows", altered)


@pytest.mark.parametrize("workload,fault", [
    ("lubm100.facets", _facets_unchanged),
    ("lubm100.facets", _facets_half_batch),
    ("lubm100.facets", _facets_altered),
    ("lubm800.load", _load_unchanged),
    ("lubm800.load", _load_half_batch),
    ("lubm800.load", _load_altered),
], ids=["facets-unchanged", "facets-half", "facets-altered",
        "load-unchanged", "load-half", "load-altered"])
def test_broken_path_is_not_correct(tiny_cell, monkeypatch, workload, fault):
    import repro_torch  # noqa: F401  (the program, on the path via conftest)
    fault(monkeypatch)
    r = run_cell(tiny_cell(workload), 4242, 1.0, False, "cpu",
                 t_start=time.perf_counter())
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["lubm100.facets", "lubm800.load"])
def test_control_is_not_correct(tiny_cell, workload):
    for seed in (11, 12, 13):
        found = control.readings(tiny_cell(workload), seed, "cpu", 200)
        key = "count_mismatches" if "facets" in workload else "full_rows_off"
        assert found[key] > 0, found
