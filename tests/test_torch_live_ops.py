"""Port parity, the live store's edges: device compaction against host
compaction and the reference, a fault at ``engine.flush_mat``, the
auto-compaction threshold, and a reference KnowledgeBase carried across
mid-sequence through ``from_numpy`` (the helpers and the stepwise
sequences are in tests/test_torch_live.py).  Everything compared is
integer: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

from repro.core.delta import compact_view as j_compact_view
from repro_torch.core.delta import compact_view
from repro_torch.core.engine import KnowledgeBase as TKB
from repro_torch.testing import faults

from test_torch_live import MODES, PLANES, Pair, _onto_spec

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", MODES)
def test_device_compaction_equals_host(mode):
    """compact_view(device=True) == compact_view(device=False), bit for
    bit, with tombstones in base and delta; and the reference's rows."""
    pair = Pair(_onto_spec(4), 120, 160, 140, 4)
    pair.insert(60, 40, 40, seed=41)
    pair.delete(np.arange(0, pair.cur[0].shape[0], 7))
    pair.insert(30, 20, 20, seed=42)
    v = pair.t.view(mode)
    host_rows, host_idx = compact_view(v, device=False)
    dev_rows, dev_idx = compact_view(v, device=True)
    assert torch.equal(host_rows, dev_rows)
    np.testing.assert_array_equal(host_idx._h, dev_idx._h)
    np.testing.assert_array_equal(host_idx.perm("pos").key,
                                  dev_idx.perm("pos").key)
    j_rows, _ = j_compact_view(pair.j.view(mode), device=False)
    np.testing.assert_array_equal(host_rows.numpy(), np.asarray(j_rows))
    pair.compact(device=True)
    pair.check(modes=(mode,))


def test_flush_fault_leaves_store_consistent():
    """A crash mid-derivation (fault site ``engine.flush_mat``) appends
    nothing; the next serve retries the whole backlog."""
    pair = Pair(_onto_spec(5), 100, 140, 120, 5)
    pair.insert(40, 30, 30, seed=51)
    pair.insert(30, 20, 20, seed=52)
    t = pair.t
    log_n = t.delta.log("litemat").n
    with faults.inject() as inj:
        # crash on the SECOND batch: the first is derived but not committed
        inj.arm("engine.flush_mat", exc=faults.FaultCrash, after=1, times=1)
        with pytest.raises(faults.FaultCrash):
            t.view("litemat")
        assert inj.fired("engine.flush_mat") == 1
    assert t.delta.log("litemat").n == log_n
    assert t.mat_counts == {"litemat": 0, "full": 0}
    assert t._mat_cursor == {"litemat": 0, "full": 0}
    assert t.sizes() == pair.j.sizes()
    pair.check()  # the retry derives both batches: equal to the reference
    assert t.mat_counts == pair.j.mat_counts == {"litemat": 2, "full": 2}


def test_auto_compaction_threshold():
    pair = Pair(_onto_spec(7), 40, 50, 40, 7)
    pair.t.compact_threshold = pair.j.compact_threshold = 0.05
    # the stats dicts are equal, "compacted" included
    pair.insert(30, 25, 20, seed=70, auto_compact=True)
    assert pair.t._delta is None or pair.t.delta.empty
    pair.check()


def _live_state(jkb) -> dict:
    """A mutated reference KnowledgeBase as ``from_numpy``'s state."""
    d = jkb.delta
    return {
        "spo": np.asarray(jkb.kb.spo), "lite_spo": np.asarray(jkb.lite_spo),
        "full_spo": np.asarray(jkb.full_spo),
        "tables": [{f: np.asarray(getattr(t, f)) for f in PLANES}
                   for t in jkb.kb.tables],
        "n_instance_terms": jkb.kb.n_instance_terms,
        "lite_stats": jkb.lite_stats, "full_stats": jkb.full_stats,
        "live": {
            "logs": {m: {"rows": lg.rows, "alive": lg.alive,
                         "tombstone_mut": lg.tombstone_mut}
                     for m, lg in d.logs.items()},
            "base_alive": dict(d.base_alive),
            "kills": {m: list(k) for m, k in d.kills.items()},
            "n_new_terms": d.n_new_terms,
            "version": jkb.version,
            "pending_raw": list(jkb._pending_raw),
            "mat_cursor": dict(jkb._mat_cursor),
            "mat_counts": dict(jkb.mat_counts),
        },
    }


def test_from_numpy_carries_live_state():
    """A reference KnowledgeBase loaded after an insert and a delete,
    before compaction, answers like the reference in all three modes —
    and keeps mutating in lockstep with it."""
    pair = Pair(_onto_spec(8), 100, 140, 120, 8)
    pair.insert(60, 40, 30, seed=81)
    pair.delete(np.arange(0, pair.cur[0].shape[0], 9))
    pair.t = TKB.from_numpy(_live_state(pair.j), pair.tonto, device="cpu")
    pair.check(use_index=(True, False))
    pair.insert(20, 15, 10, seed=82)
    pair.check()
    pair.compact()
    pair.check()
