"""The configuration's raw columns, generated once per checkout.

LUBM(N, S) is fixed by its configuration (N universities, the generator's
seed S), so its columns are input and not work: the first run in a checkout
makes them with the frozen generator and keeps them as ``.npy`` files under
``build/litemat_bench/data/<configuration>/``, keyed by the number of
universities, the generator's seed and a digest of the frozen generator.
A directory that holds another key is replaced, so each configuration keeps
one data set (about 2.2 GB at LUBM-800).  The run's ``--seed`` never changes
the data set; it draws the traffic.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import time
import numpy as np

from litemat_bench.frozen.generator import generate_lubm
from litemat_bench.spec import BENCH, ROOT

CACHE = ROOT / "build" / "litemat_bench" / "data"
COLUMNS = ("s", "p", "o")


def generator_digest() -> str:
    h = hashlib.sha1()
    for f in ("generator.py", "ontology.py"):
        h.update((BENCH / "frozen" / f).read_bytes())
    return h.hexdigest()[:16]


def raw_columns(config: dict):
    """(s, p, o) int64 fingerprint columns of ``config``'s LUBM data and
    whether this call generated them."""
    key = {"n_universities": int(config["n_universities"]),
           "lubm_seed": int(config["lubm_seed"]),
           "generator": generator_digest()}
    d = CACHE / config["name"]
    meta = d / "meta.json"
    if meta.exists() and {k: json.loads(meta.read_text()).get(k)
                          for k in key} == key:
        return tuple(np.load(d / f"{c}.npy") for c in COLUMNS), False
    t0 = time.perf_counter()
    cols = generate_lubm(key["n_universities"], key["lubm_seed"])
    part = CACHE / f"{config['name']}.partial"
    shutil.rmtree(part, ignore_errors=True)
    part.mkdir(parents=True)
    for c, a in zip(COLUMNS, cols):
        np.save(part / f"{c}.npy", a)
    (part / "meta.json").write_text(json.dumps(
        key | {"generate_s": time.perf_counter() - t0}))
    shutil.rmtree(d, ignore_errors=True)
    part.rename(d)
    return cols, True
