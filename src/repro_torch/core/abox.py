"""ABox encoding: OBE (ontology-based) vs SAE (standard) — paper §III.B/VI.C1.

``encode_obe``: TBox terms (concepts, properties, rdf:type) are already
encoded; only genuine instance/literal terms go through the dictionary.
``encode_sae`` is the paper's baseline: every term — including the very
frequent rdf:type and property IRIs — is dictionary-encoded with no
semantic structure.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import dictionary as dct
from repro_torch.core.tbox import TBox
from repro_torch.utils import pair64
from repro_torch.utils.hashing import fingerprint_string


@dataclass
class EncodedKB:
    """Device-encoded knowledge base."""

    spo: torch.Tensor  # int32[N, 3] encoded triples
    tables: tuple  # dictionary parts (TBox map, instance table)
    tbox: TBox | None
    n_instance_terms: int
    term_strings: dict | None = None  # host fp -> string (optional)
    _merged: dct.TermTable | None = None

    @property
    def n(self) -> int:
        return int(self.spo.shape[0])

    @property
    def table(self) -> dct.TermTable:
        """Full dictionary (lazily merged — only locate/extract need it)."""
        if self._merged is None:
            t = self.tables[0]
            for other in self.tables[1:]:
                t = dct.merge_tables(t, other)
            self._merged = t
        return self._merged

    # host conveniences ------------------------------------------------------
    def locate(self, terms):
        """strings -> ids (-1 if unknown)."""
        fps = np.array([fingerprint_string(t) for t in terms], dtype=np.int64)
        hi, lo = pair64.split_np(fps)
        dev = self.spo.device
        ids, _ = self.table.locate(torch.as_tensor(hi, device=dev),
                                   torch.as_tensor(lo, device=dev))
        return ids.cpu().numpy()

    def extract(self, ids):
        """ids -> strings (via host term_strings; fp hex if unknown)."""
        q = torch.as_tensor(np.array(ids, dtype=np.int32),
                            device=self.spo.device)
        hi, lo, hit = self.table.extract_fp(q)
        fps = pair64.combine_np(hi.cpu().numpy(), lo.cpu().numpy())
        out = []
        for f, h in zip(fps.tolist(), hit.cpu().tolist()):
            if not h:
                out.append(None)
            elif self.term_strings and f in self.term_strings:
                out.append(self.term_strings[f])
            else:
                out.append(f"fp:{f:x}")
        return out


def tbox_term_map(tbox: TBox):
    """(fps, ids) of every TBox-encoded term (concept + property names)."""
    fps, ids = [], []
    for enc in (tbox.concepts, tbox.properties):
        for name in enc.tax.names:
            if name.startswith("__"):  # synthetic roots have no IRI
                continue
            fps.append(fingerprint_string(name))
            ids.append(enc.id_of(name))
    fps = np.array(fps, dtype=np.int64)
    ids = np.array(ids, dtype=np.int32)
    if len(np.unique(fps)) != len(fps):
        raise ValueError("fingerprint collision among TBox terms")
    return fps, ids


def _encode_columns(q_hi, q_lo, ttable: dct.TermTable, base: int, dict_cols):
    """Core shared by OBE/SAE: resolve columns, dict-encode the rest.

    ``q_hi``/``q_lo`` are int32[3, N] (s, p, o rows).  ``dict_cols`` selects
    which columns feed the instance dictionary: OBE passes (0, 2) —
    predicates and rdf:type objects are already TBox-encoded, so the
    dictionary sort runs on 2N occurrences instead of SAE's 3N.
    """
    tb_ids, tb_hit = ttable.locate(q_hi, q_lo)
    cols = list(dict_cols)
    sentinel = torch.full_like(q_hi[cols], dct.SENTINEL)
    un_hi = torch.where(tb_hit[cols], sentinel, q_hi[cols]).reshape(-1)
    un_lo = torch.where(tb_hit[cols], sentinel, q_lo[cols]).reshape(-1)
    table = dct.build_local_dictionary(un_hi, un_lo, un_hi != dct.SENTINEL,
                                       base)
    inst_ids, _ = table.locate(q_hi, q_lo)
    ids = torch.where(tb_hit, tb_ids, inst_ids)
    return ids, table


def _to_pairs(raw, device):
    """Raw fingerprint columns -> int32[3, N] (hi, lo) planes on ``device``."""
    his, los = zip(*(pair64.split_np(c) for c in (raw.s, raw.p, raw.o)))
    return (torch.as_tensor(np.stack(his), device=device),
            torch.as_tensor(np.stack(los), device=device))


def encode_obe(raw, tbox: TBox, device=None) -> EncodedKB:
    """Ontology-based encoding: TBox map + instance dictionary."""
    fps, ids = tbox_term_map(tbox)
    ttable = dct.table_from_host(fps, ids, device=device)
    q_hi, q_lo = _to_pairs(raw, device)
    ids, itable = _encode_columns(q_hi, q_lo, ttable,
                                  base=tbox.instance_base, dict_cols=(0, 2))
    if ids.shape[1] and int(ids[1].min()) < 0:
        raise ValueError(
            "OBE found predicates outside the TBox property map — classify "
            "the ontology over the full predicate set first (the N-Triples "
            "parser does this automatically)"
        )
    return EncodedKB(
        spo=ids.T.contiguous(), tables=(ttable, itable), tbox=tbox,
        n_instance_terms=int(itable.count),
        term_strings=getattr(raw, "term_strings", None),
    )


def encode_sae(raw, device=None) -> EncodedKB:
    """Standard ABox-only encoding (paper's baseline): no TBox knowledge."""
    q_hi, q_lo = _to_pairs(raw, device)
    empty = torch.full((1,), dct.SENTINEL, dtype=torch.int32, device=device)
    ttable = dct.TermTable(empty, empty, torch.full_like(empty, -1), empty,
                           empty, empty, torch.tensor(0, device=device))
    ids, itable = _encode_columns(q_hi, q_lo, ttable, base=0,
                                  dict_cols=(0, 1, 2))
    return EncodedKB(
        spo=ids.T.contiguous(), tables=(itable,), tbox=None,
        n_instance_terms=int(itable.count),
        term_strings=getattr(raw, "term_strings", None),
    )
