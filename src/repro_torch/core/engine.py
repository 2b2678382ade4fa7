"""KnowledgeBase facade: raw triples -> encoded -> materialized -> queryable.

One object wires the LiteMat pipeline on one device against a static
store — TBox encode, dictionary / ABox encode, lite and full
materialization — and answers conjunctive queries in the paper's
``litemat`` and ``full`` modes, plus the paper's appendix queries Q1–Q4
as canned pattern lists.

Every tensor lives on the KnowledgeBase's device, which defaults to CUDA:
``build`` raises when no CUDA device exists rather than running on the
CPU, and callers that want the CPU (the tests) say so with
``device="cpu"``.  The live store (insert / delete / compact) and rewrite
mode are later slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import dictionary as dct
from repro_torch.core.abox import EncodedKB, encode_obe
from repro_torch.core.closure import full_materialize
from repro_torch.core.delta import DeviceStoreCache, StoreView
from repro_torch.core.index import StoreIndex
from repro_torch.core.materialize import DeviceTBox, compact_rows, lite_materialize
from repro_torch.core.query import Pattern, QueryEngine
from repro_torch.core.tbox import Ontology, TBox, build_tbox
from repro_torch.obs import trace as obs_trace
from repro_torch.rdf.generator import RawDataset

# The paper's appendix queries (over the LUBM vocabulary).
PAPER_QUERIES = {
    "Q1": [Pattern("?x", "rdf:type", "Professor")],
    "Q2": [Pattern("?x", "memberOf", "?y")],
    "Q3": [Pattern("?x", "rdf:type", "Professor"), Pattern("?x", "memberOf", "?y")],
    "Q4": [
        Pattern("?x", "rdf:type", "Chair"),
        Pattern("?y", "rdf:type", "Department"),
        Pattern("?x", "worksFor", "?y"),
    ],
}


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass "
                "device='cpu' explicitly to run its plain versions")
        return torch.device("cuda")
    return torch.device(device)


@dataclass
class KnowledgeBase:
    kb: EncodedKB
    dtb: DeviceTBox
    lite_spo: torch.Tensor  # compacted lite-materialized base store
    full_spo: torch.Tensor  # compacted fully-materialized base store
    lite_stats: dict
    full_stats: dict
    _engines: dict = field(default_factory=dict, repr=False)
    _base_indexes: dict = field(default_factory=dict, repr=False)
    _views: dict = field(default_factory=dict, repr=False)
    _dev_caches: dict = field(default_factory=dict, repr=False)

    @classmethod
    def build(cls, raw: RawDataset, tbox: TBox | None = None,
              parallel_tbox: bool = False, device=None) -> "KnowledgeBase":
        device = resolve_device(device)
        # one span per stage; each stage ends in a host read of its counts,
        # so a span's time covers its device work
        with obs_trace.span("tbox"):
            tbox = tbox or build_tbox(raw.onto, parallel=parallel_tbox)
            dtb = DeviceTBox.build(tbox, device=device)
        with obs_trace.span("encode", n_triples=raw.n_triples):
            kb = encode_obe(raw, tbox, device=device)
        with obs_trace.span("lite"):
            lite, lvalid, lstats = lite_materialize(kb, dtb)
            lite_spo = compact_rows(lite, lvalid)
            del lite, lvalid
        with obs_trace.span("full"):
            full, fvalid, fstats = full_materialize(kb, dtb)
            full_spo = compact_rows(full, fvalid)
        return cls(kb=kb, dtb=dtb, lite_spo=lite_spo, full_spo=full_spo,
                   lite_stats=lstats, full_stats=fstats)

    @classmethod
    def from_numpy(cls, state: dict, onto: Ontology, device=None,
                   parallel_tbox: bool = False) -> "KnowledgeBase":
        """A KnowledgeBase from another build's arrays, as numpy.

        ``state`` holds ``spo``, ``lite_spo``, ``full_spo`` (int32[N, 3]),
        ``tables`` (one dict of TermTable planes per dictionary part —
        ``fp_hi, fp_lo, ids, rev_ids, rev_hi, rev_lo, count``),
        ``n_instance_terms``, ``lite_stats`` and ``full_stats``.  The TBox
        is rebuilt from ``onto`` (deterministic), so queries can be held
        against another implementation's store independently of the build.
        """
        device = resolve_device(device)
        tbox = build_tbox(onto, parallel=parallel_tbox)

        def rows(a):
            return torch.as_tensor(np.array(a, dtype=np.int32), device=device)

        kb = EncodedKB(
            spo=rows(state["spo"]),
            tables=tuple(dct.TermTable.from_numpy(t, device)
                         for t in state["tables"]),
            tbox=tbox,
            n_instance_terms=int(state["n_instance_terms"]),
        )
        return cls(kb=kb, dtb=DeviceTBox.build(tbox, device=device),
                   lite_spo=rows(state["lite_spo"]),
                   full_spo=rows(state["full_spo"]),
                   lite_stats=dict(state["lite_stats"]),
                   full_stats=dict(state["full_stats"]))

    # -- store plumbing ------------------------------------------------------
    def _base_store(self, mode: str) -> torch.Tensor:
        return {
            "litemat": self.lite_spo,
            "full": self.full_spo,
            "rewrite": self.kb.spo,
        }[mode]

    def _base_index(self, mode: str) -> StoreIndex:
        if mode not in self._base_indexes:
            self._base_indexes[mode] = StoreIndex.build(self._base_store(mode))
        return self._base_indexes[mode]

    def dev_cache(self, mode: str) -> DeviceStoreCache:
        """The store's persistent device buffers."""
        if mode not in self._dev_caches:
            self._dev_caches[mode] = DeviceStoreCache()
        return self._dev_caches[mode]

    def view(self, mode: str) -> StoreView:
        """The StoreView of one store (static: built once per mode)."""
        if mode not in self._views:
            idx = self._base_index(mode)
            self._views[mode] = StoreView(
                base_rows=self._base_store(mode), base_h=idx._h,
                base_index=idx, cache=self.dev_cache(mode))
        return self._views[mode]

    def engine(self, mode: str = "litemat", use_index: bool = True) -> QueryEngine:
        """Cached QueryEngine per (mode, use_index).

        ``use_index=False`` forces the scan-only path — the oracle the
        indexed plans are validated against (tests, chip_smoke.py).
        """
        key = (mode, use_index)
        if key not in self._engines:
            self._engines[key] = QueryEngine(
                kb=self.kb, spo=self._base_store(mode), mode=mode,
                dtb=self.dtb, use_index=use_index, view=self.view(mode))
        return self._engines[key]

    def query(self, patterns, select=None, mode: str = "litemat",
              use_index: bool = True):
        rows, sel = self.engine(mode, use_index).run(patterns, select=select)
        return rows, sel

    def answers(self, patterns, select=None, mode: str = "litemat",
                use_index: bool = True) -> set:
        rows, _ = self.query(patterns, select=select, mode=mode,
                             use_index=use_index)
        return {tuple(r) for r in rows.tolist()}

    def prewarm(self, queries=None, modes=("litemat",), buckets=(),
                use_index: bool = True) -> int:
        """Run plan bodies for ``queries`` (default: Q1–Q4) once."""
        queries = (list(queries) if queries is not None
                   else list(PAPER_QUERIES.values()))
        return sum(
            self.engine(m, use_index).prewarm(queries, buckets=buckets)
            for m in modes
        )

    def sizes(self) -> dict:
        return dict(
            original=self.kb.n,
            lite=int(self.lite_spo.shape[0]),
            full=int(self.full_spo.shape[0]),
        )
