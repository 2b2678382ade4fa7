"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; each is a data file of its
own (``configs/<name>.json``, ``traffic/<name>.json``).  Every metric is a
reader of its own, ``end_to_end/<name>.py`` or ``metrics/<name>.py``, with
one function ``read(run)`` that returns a number or ``None`` when the run
holds nothing for it to read.  So a later cell, mix or metric is a new file
and a new entry, and no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, with its name
    traffic: dict  # the traffic mix's file, with its name
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, spec: dict | None = None) -> Cell:
    """The workload ``name`` with its configuration, mix and metrics."""
    spec = spec or load_spec()
    w = next((w for w in spec["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / c["file"]).read_text())
    config["name"] = c["name"]
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    traffic["name"] = w["traffic"]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if _applies(m, name) and m["moves"] in moved]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def reader(kind: str, name: str):
    """The ``read`` function of ``<kind>/<name>.py`` (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    mod_name = f"litemat_bench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
