"""``repro_torch`` and ``chip_smoke.py`` stand alone: they import neither
JAX nor the reference package.

One fresh interpreter, in which ``import jax`` and ``import repro`` fail
(``sys.modules`` entries set to None), imports every module of the port
(walked with ``pkgutil``), then ``chip_smoke`` and the port's examples
(``examples/*_torch.py``, their ``main`` not run).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
import importlib.util, pathlib
for path in sorted(pathlib.Path(sys.argv[1], "examples").glob("*_torch.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append("examples/" + path.name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_and_chip_smoke_import_neither_jax_nor_reference():
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(ROOT)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    seen = json.loads(out.stdout)
    assert seen["leaked"] == []
    # the walk reached every subpackage, the LM family's included
    assert {"repro_torch.kernels.ops", "repro_torch.core.shard",
            "repro_torch.models.lm", "repro_torch.models.moe",
            "repro_torch.train.loop", "repro_torch.configs.registry",
            "repro_torch.distributed.checkpoint",
            "repro_torch.launch.train", "repro_torch.launch.cells",
            "repro_torch.data.graphs", "repro_torch.models.gnn.equiformer",
            "repro_torch.models.gnn.so3", "examples/train_gnn_torch.py",
            "examples/quickstart_torch.py", "repro_torch.launch.mesh",
            "repro_torch.launch.shardings", "repro_torch.launch.hlo_analysis",
            "repro_torch.launch.dry_run", "repro_torch.distributed.sharded",
            "repro_torch.testing.sharded_steps", "examples/train_lm_torch.py",
            "examples/serve_queries_torch.py"} <= set(seen["modules"])
