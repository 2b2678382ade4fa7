"""BENCHMARK.json against the contract's shape, and every name it gives
resolving to a file of the harness."""
from __future__ import annotations

import json
import re

import pytest

from litemat_bench import spec
from litemat_bench.spec import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    s = _spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for w in s["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])
    assert 1 <= s["run_seconds"] <= 51


def test_every_cell_reports_what_the_contract_asks():
    s = _spec()
    for w in s["workloads"]:
        c = spec.cell(w["name"], s)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        assert c.config["n_universities"] > 0


@pytest.mark.parametrize("kind,key", [("end_to_end", "end_to_end"),
                                      ("metrics", "per_layer")])
def test_every_metric_has_a_reader(kind, key):
    for m in _spec()[key]:
        assert callable(spec.reader(kind, m["name"]))


def test_configs_and_mixes_are_files_of_their_own():
    s = _spec()
    files = [c["file"] for c in s["configs"]]
    assert len(set(files)) == len(files)
    for c in s["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("litemat_bench/")
    for w in s["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
