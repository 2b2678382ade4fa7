"""Shared fixtures: cells cut to LUBM-1 on the CPU, with their data cached
in a temporary directory."""
from __future__ import annotations

import sys

import pytest
import torch

from litemat_bench import data, spec
from litemat_bench.spec import ROOT

if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


@pytest.fixture
def tiny_cell(tmp_path, monkeypatch):
    """A function: workload name -> its cell at LUBM-1, data under tmp."""
    monkeypatch.setattr(data, "CACHE", tmp_path / "data")
    torch.set_num_threads(2)

    def make(name: str, universities: int = 1):
        c = spec.cell(name)
        c.config["n_universities"] = universities
        return c
    return make
