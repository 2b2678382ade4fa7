"""The port's last two examples run end to end on the CPU.

``examples/train_lm_torch.py`` (reduced olmo-1b through ``TrainLoop``
with checkpoints: 6 steps, then a second run into the same directory
resumes at step 6) and ``examples/serve_queries_torch.py`` at LUBM-1 (the
three-mode audit at the reference's published LUBM-1 counts, batched
``class_members``, an insert picked up with no ``invalidate()``, and
``compact()``), each through its ``main`` with ``--device cpu``, on one
CPU thread (8 threads made each 4-5 times slower at these sizes).
"""
from __future__ import annotations

import importlib.util
import math
import signal
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# the reference's numbers for LUBM-1, seed 0 (BENCH_queries.json, table6)
LUBM1_COUNTS = {"Q1": 726, "Q2": 13340, "Q3": 726, "Q4": 24}


def _example(name: str):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def signals():
    """The LM example installs SIGTERM / SIGINT handlers: put the test
    process's own back afterwards."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def test_train_lm_example_trains_and_resumes(tmp_path, signals):
    mod = _example("train_lm_torch")
    ckpt = str(tmp_path / "ckpt")
    last, hist = mod.main(["--steps", "6", "--ckpt-dir", ckpt,
                           "--device", "cpu"])
    assert last == 6 and len(hist) == 6
    assert all(math.isfinite(x) for x in hist)
    last, hist2 = mod.main(["--steps", "8", "--ckpt-dir", ckpt,
                            "--device", "cpu"])
    assert last == 8 and len(hist2) == 2  # resumed at step 6


def test_serve_queries_example_at_lubm1():
    mod = _example("serve_queries_torch")
    out = mod.main(["--device", "cpu", "--universities", "1",
                    "--batches", "2", "--batch", "16"])
    assert out["audit"] == LUBM1_COUNTS
    assert out["served"] == 32
    assert out["student_after"] > out["student_before"]
    assert out["student_stable"] == out["student_after"]
