"""Port parity, the multi-process runtime: process groups over gloo on the
CPU, process-local shard placement, and the fleet telemetry.

Two processes of ``repro_torch.launch.distributed_smoke`` run side by side
on the CPU (gloo), one started with flags and one from the environment
``torchrun`` sets; the collective's sum, the fleet's ``fleet.json`` and the
children's Q4 rows are held against what the reference gives: the
reference's ``lubm_kb`` (LUBM-1, seed 7, the same data), row for row.
Every child has a timeout and is killed on expiry, so a hang fails one
test.  The runtime's rules (cards per process, backend) are checked
without processes.  Integer outputs: the tolerance is zero.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.engine import PAPER_QUERIES as J_QUERIES
from repro_torch.core.shard import ShardedKB, _resolve_devices
from repro_torch.distributed import runtime
from repro_torch.launch.distributed_smoke import (ANSWER_RUNS, answers_key,
                                                  select_of)
from repro_torch.obs.export import validate_metrics_snapshot
from repro_torch.rdf.generator import generate_lubm

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _lines(out: str) -> dict:
    """The child's JSON lines by step."""
    return {d["step"]: d for d in (json.loads(ln) for ln in out.splitlines()
                                   if ln.startswith("{"))}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, request):
    """Two gloo processes of the smoke at LUBM-1 (seed 7), 4 shards each:
    process 0 from flags, checking Q4 against its own single store;
    process 1 from torchrun's environment, writing its answers.  The
    reference's ``lubm_kb`` builds while they run."""
    tmp = tmp_path_factory.mktemp("distributed")
    port = _free_port()
    common = ["--device", "cpu", "--n-shards", "4", "--queries", "8",
              "--metrics-dir", str(tmp / "metrics"), "--timeout-s", "60"]
    base_env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
                "OMP_NUM_THREADS": "2"}
    argv = [sys.executable, "-m", "repro_torch.launch.distributed_smoke"]
    procs = [
        subprocess.Popen(
            [*argv, *common, "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", "0"],
            env=base_env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        subprocess.Popen(
            [*argv, *common, "--answers-dir", str(tmp / "answers")],
            env={**base_env, "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": "1",
                 "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"},
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
    ]
    outs = []
    try:
        request.getfixturevalue("lubm_kb")
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return tmp, outs


def test_two_gloo_processes_run_the_smoke(spawned):
    """Both exit 0; the all_reduce sums one device a process; each store
    sits on the CPU in 4 shards, Q4 through the repartition; the ingest
    through the sharded encode equals its host-encode control; fleet.json
    validates and sums ``shard/combine_runs`` over the processes."""
    tmp, outs = spawned
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {rank} exited {rc}:\n{out}\n{err[-3000:]}"
    steps = [_lines(out) for _, out, _ in outs]
    for rank, s in enumerate(steps):
        assert s["topology"]["backend"] == "gloo"
        assert s["topology"]["local_devices"] == ["cpu"]
        assert s["collective"]["sum"] == s["collective"]["want"] == 2
        assert s["store"]["shard_devices"] == ["cpu"] * 4
        assert s["store"]["cache_stats"]["repartition_runs"] >= 1
        assert s["sharded_encode"]["forced"]
        assert s["sharded_encode"]["answers"]["Q1"] > 0
        assert s["queries_together"]["queries"] == 8
        assert s["done"]["ok"] and s["done"]["rank"] == rank
    assert steps[0]["queries_alone"]["queries"] == 8
    assert "queries_alone" not in steps[1]
    fleet = json.loads((tmp / "metrics" / "fleet.json").read_text())
    assert validate_metrics_snapshot(fleet) == []
    snaps = [json.loads((tmp / "metrics" / f"metrics-proc{r}.json")
                        .read_text()) for r in range(2)]

    def runs(snap):
        return sum(e["value"] for e in snap["counters"]
                   if e["name"] == "shard/combine_runs")

    assert runs(fleet) == runs(snaps[0]) + runs(snaps[1])
    assert runs(snaps[0]) > 0 and runs(snaps[1]) > 0
    assert steps[0]["fleet"]["fleet_combine_runs"] == runs(fleet)
    assert sorted(s["process"] for s in snaps) == ["0", "1"]


@pytest.mark.parametrize("mode,use_index", ANSWER_RUNS)
def test_child_q4_rows_equal_reference(spawned, lubm_kb, mode, use_index):
    """Process 1's Q4 rows (its 4-shard store, the host fold) equal the
    reference's single store of the same data, row for row: three modes
    indexed, and litemat's scans."""
    tmp, outs = spawned
    assert outs[1][0] == 0, outs[1][2][-3000:]
    K, _ = lubm_kb
    pats = J_QUERIES["Q4"]
    with np.load(tmp / "answers" / "answers-proc1.npz") as got:
        rows = got[answers_key("Q4", mode, use_index)]
    want, _ = K.query(pats, select=select_of(pats), mode=mode,
                      use_index=use_index)
    np.testing.assert_array_equal(rows, np.asarray(want))
    assert rows.shape[0] > 0


def _raises(fn, exc, match):
    with pytest.raises(exc, match=match):
        fn()


@pytest.mark.parametrize("case", [
    "cards", "sharing", "backend", "nccl_shared", "nccl_cpu", "no_cuda",
    "nccl_shared_initialize",
])
def test_runtime_rules(case, monkeypatch):
    """The rules with no process: process p owns ``(p·k + j) % n``, each
    once; cards are shared when the host's processes want more than it
    has; NCCL unless a card is shared or on the CPU, NCCL asked for where
    it cannot run raises; without CUDA and without ``device="cpu"``
    ``initialize`` raises, as ``resolve_device`` does."""
    if case == "cards":
        assert runtime.plan_devices(0, 1, 1) == [0]
        assert runtime.plan_devices(1, 1, 1) == [0]  # two share cuda:0
        assert runtime.plan_devices(1, 2, 4) == [2, 3]
        assert runtime.plan_devices(3, 1, 4) == [3]
        assert runtime.plan_devices(2, 2, 4) == [0, 1]  # wraps around
        assert runtime.plan_devices(0, 3, 2) == [0, 1]  # each card once
        _raises(lambda: runtime.plan_devices(0, 0, 4), ValueError, "k >= 1")
    elif case == "sharing":
        assert runtime.cards_shared(2, 1, 1)
        assert not runtime.cards_shared(2, 2, 4)
        assert not runtime.cards_shared(4, 1, 4)
        assert runtime.cards_shared(3, 1, 2)
        assert not runtime.cards_shared(1, 3, 2)
    elif case == "backend":
        assert runtime.choose_backend(True, False) == "nccl"
        assert runtime.choose_backend(True, True) == "gloo"
        assert runtime.choose_backend(False, False) == "gloo"
        assert runtime.choose_backend(True, False, "gloo") == "gloo"
        _raises(lambda: runtime.choose_backend(True, False, "mpi"),
                ValueError, "one of")
    elif case == "nccl_shared":
        _raises(lambda: runtime.choose_backend(True, True, "nccl"),
                ValueError, "two ranks on one card")
    elif case == "nccl_cpu":
        _raises(lambda: runtime.choose_backend(False, False, "nccl"),
                ValueError, "gloo")
    elif case == "no_cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        _raises(lambda: runtime.initialize("127.0.0.1:1", 1, 0),
                RuntimeError, "no CUDA device")
        assert not runtime.is_initialized()
    else:  # two processes on one card, NCCL asked for: no quiet gloo
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        _raises(lambda: runtime.initialize("127.0.0.1:1", 2, 1,
                                           backend="nccl"),
                ValueError, "two ranks on one card")
        assert not runtime.is_initialized()


def test_placement_follows_the_process_group(monkeypatch):
    """In a world of one (gloo, ``device="cpu"``), a store built without
    devices sits on the process's own devices; after ``shutdown`` the
    default (every card, which must exist) is back."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # keep this process's threads
    port = _free_port()
    try:
        rt = runtime.initialize(f"127.0.0.1:{port}", 1, 0, device="cpu")
        assert rt.backend == "gloo" and runtime.process_count() == 1
        assert runtime.local_devices() == [torch.device("cpu")]
        assert _resolve_devices() == [torch.device("cpu")]
        assert _resolve_devices(device="cpu") == [torch.device("cpu")]
        assert runtime.all_reduce_check() == 1
        S = ShardedKB.build(generate_lubm(1, seed=7), n_shards=2)
        assert S.devices == [torch.device("cpu")]
        assert not S.device_per_shard() and not S._sharded_encode_on()
    finally:
        runtime.shutdown()
    assert not runtime.is_initialized() and runtime.process_index() == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _resolve_devices()
