"""Dictionary encoding (the paper's §III.B).

The paper's Spark algorithm extracts each partition's distinct new terms,
sums the per-partition distinct counts into disjoint id ranges and assigns
ids within them.  On one device that is sort + adjacent-unique + cumsum
(rank == id offset).  The sharded build (``sharded_dictionary_fn``) sends
each term to one owner shard with an all-to-all, dedups there, and an
all-gather of the per-owner counts gives each owner its id range; lookups
return to the asking shards the same way (core/exchange.py).

Fingerprints are 62-bit values kept as (hi, lo) int32 planes in the
tables' public fields; every sort and search runs on their int64 composite
(utils/pair64.py), which orders the same way.  ``extract`` resolves
fp -> string on the host, mirroring the paper's driver-side string world.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.exchange import all_gather, all_to_all, device_ctx
from repro_torch.utils import pair64

SENTINEL = int(np.iinfo(np.int32).max)  # > any real 30-bit hi word
INT32_MAX = int(np.iinfo(np.int32).max)


@dataclass
class TermTable:
    """Dictionary: lex-sorted fp pairs -> int32 ids (+reverse view)."""

    fp_hi: torch.Tensor  # int32[T], sorted (pairs with SENTINEL padding tail)
    fp_lo: torch.Tensor
    ids: torch.Tensor  # int32[T], -1 on padding rows
    rev_ids: torch.Tensor  # int32[T] ids sorted ascending (padding: INT32_MAX)
    rev_hi: torch.Tensor  # fp planes aligned with rev_ids
    rev_lo: torch.Tensor
    count: torch.Tensor  # int32 scalar: number of real entries

    def locate(self, qhi, qlo):
        """fp pairs -> (ids, hit_mask); -1 where absent."""
        return pair64.lookup_pair(self.fp_hi, self.fp_lo, self.ids, qhi, qlo)

    def extract_fp(self, q_ids):
        """ids -> (fp_hi, fp_lo, hit_mask)."""
        pos = torch.searchsorted(self.rev_ids, q_ids)
        pos_c = pos.clamp(0, self.rev_ids.shape[0] - 1)
        hit = self.rev_ids[pos_c] == q_ids
        neg = torch.full_like(q_ids, -1)
        return (torch.where(hit, self.rev_hi[pos_c], neg),
                torch.where(hit, self.rev_lo[pos_c], neg), hit)

    @classmethod
    def from_numpy(cls, planes: dict, device) -> "TermTable":
        """A table from host planes (``KnowledgeBase.from_numpy``)."""
        return cls(**{k: torch.as_tensor(np.array(planes[k], np.int32),
                                         device=device)
                      for k in ("fp_hi", "fp_lo", "ids", "rev_ids", "rev_hi",
                                "rev_lo", "count")})


def table_from_host(fps: np.ndarray, ids: np.ndarray, device=None) -> TermTable:
    """Small host-built map (e.g. the TBox term map) -> TermTable."""
    hi, lo = pair64.split_np(fps)
    order = np.lexsort((lo, hi))
    hi, lo, ids = hi[order], lo[order], np.asarray(ids, dtype=np.int32)[order]
    rorder = np.argsort(ids, kind="stable")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return TermTable(
        fp_hi=t(hi), fp_lo=t(lo), ids=t(ids),
        rev_ids=t(ids[rorder]), rev_hi=t(hi[rorder]), rev_lo=t(lo[rorder]),
        count=t(np.int32(len(ids))),
    )


def build_local_dictionary(hi, lo, valid, base: int) -> TermTable:
    """Single-shard dictionary build.

    ``(hi, lo)`` are term-occurrence fingerprints, ``valid`` masks real
    occurrences.  Returns a TermTable of size len(hi) (padding rows carry
    SENTINEL fps / -1 ids) whose ids are ``base + rank`` in fp order.
    """
    dev = hi.device
    sentinel = torch.full_like(hi, SENTINEL)
    hi = torch.where(valid, hi, sentinel)
    lo = torch.where(valid, lo, sentinel)
    hi_s, lo_s, _ = pair64.sort_pairs(hi, lo)
    valid_s = hi_s != SENTINEL
    uniq = pair64.unique_mask_sorted(hi_s, lo_s) & valid_s
    ranks = torch.cumsum(uniq, 0, dtype=torch.int64) - 1  # dups share the head's rank
    ids = torch.where(valid_s, base + ranks,
                      torch.full_like(ranks, -1)).to(torch.int32)
    count = int(uniq.sum())

    # unique rows compacted to the front: the reverse view is dense in id
    # order (ids are assigned in fp order, so fp order == id order here)
    T = hi_s.shape[0]
    rev_hi = torch.full((T,), SENTINEL, dtype=torch.int32, device=dev)
    rev_lo = torch.full((T,), SENTINEL, dtype=torch.int32, device=dev)
    dest = ranks[uniq]
    rev_hi[dest] = hi_s[uniq]
    rev_lo[dest] = lo_s[uniq]
    ar = torch.arange(T, dtype=torch.int64, device=dev)
    rev_ids = torch.where(ar < count, base + ar,
                          torch.full_like(ar, INT32_MAX)).to(torch.int32)
    return TermTable(hi_s, lo_s, ids, rev_ids, rev_hi, rev_lo,
                     torch.tensor(count, dtype=torch.int32, device=dev))


def merge_tables(a: TermTable, b: TermTable) -> TermTable:
    """Union of two tables (disjoint key sets) -> one lex-sorted table."""
    hi = torch.cat([a.fp_hi, b.fp_hi])
    lo = torch.cat([a.fp_lo, b.fp_lo])
    ids = torch.cat([a.ids, b.ids])
    hi_s, lo_s, perm = pair64.sort_pairs(hi, lo)
    rev_ids = torch.cat([a.rev_ids, b.rev_ids])
    rev_hi = torch.cat([a.rev_hi, b.rev_hi])
    rev_lo = torch.cat([a.rev_lo, b.rev_lo])
    rperm = torch.sort(rev_ids, stable=True).indices
    return TermTable(
        hi_s, lo_s, ids[perm],
        rev_ids[rperm], rev_hi[rperm], rev_lo[rperm],
        a.count + b.count,
    )


# ---------------------------------------------------------------------------
# Sharded build — the paper's parallel algorithm proper
# ---------------------------------------------------------------------------


def _owner_slots(lo, valid, n_shards: int):
    """Owner shard (``lo % n_shards``; ``n_shards`` for invalid rows) and
    each row's rank among its owner's rows, in row order (0 for invalid
    rows): the reference's one-hot running count, as a stable sort."""
    owner = torch.where(valid, lo % n_shards,
                        torch.full_like(lo, n_shards)).to(torch.int64)
    order = torch.sort(owner, stable=True).indices
    owner_s = owner[order]
    first = torch.searchsorted(
        owner_s, torch.arange(n_shards + 1, device=lo.device))
    rank = (torch.arange(lo.shape[0], device=lo.device)
            - first[owner_s.clamp(max=n_shards)])
    slot = torch.empty_like(rank)
    slot[order] = torch.where(owner_s < n_shards, rank, 0)
    return owner, slot


def _scatter_bins(hi, lo, valid, owner, slot, n_shards: int, cap: int):
    """The bins of ``_bin_by_owner`` from each row's owner and slot."""
    keep = valid & (slot < cap)
    flat = owner[keep] * cap + slot[keep]
    bins_hi = torch.full((n_shards * cap,), SENTINEL, dtype=torch.int32,
                         device=hi.device)
    bins_lo = bins_hi.clone()
    bins_hi[flat] = hi[keep]
    bins_lo[flat] = lo[keep]
    overflow = (slot - (cap - 1)).clamp(min=0).sum().to(torch.int32)
    return (bins_hi.reshape(n_shards, cap), bins_lo.reshape(n_shards, cap),
            overflow)


def _bin_by_owner(hi, lo, valid, n_shards: int, cap: int):
    """Scatter local terms into per-owner bins of static capacity ``cap``.

    Owner shard = fp mod n_shards (well-mixed fingerprints -> balanced).
    Returns (bins_hi, bins_lo) int32[n_shards, cap], SENTINEL-padded, and
    the reference's overflow count (int32: the sum over rows of how far
    past the last slot each landed).  A row past its bin is dropped; the
    reference sends it, with the sentinel, to the last slot, where no real
    row lands unless the bin is full of rows of one source shard.
    """
    owner, slot = _owner_slots(lo, valid, n_shards)
    return _scatter_bins(hi, lo, valid, owner, slot, n_shards, cap)


def _reverse_view(hi_s, lo_s, ids_s, uniq, count, base):
    """(rev_ids, rev_hi, rev_lo) of one owner's sorted table: its unique
    rows compacted to the front in id order, ids ``base + rank``; padding
    SENTINEL fps and INT32_MAX ids.  ``count`` and ``base`` may be 0-d
    tensors on the table's device (no host read)."""
    T = hi_s.shape[0]
    dev = hi_s.device
    rev_hi = torch.full((T,), SENTINEL, dtype=torch.int32, device=dev)
    rev_lo = torch.full((T,), SENTINEL, dtype=torch.int32, device=dev)
    dest = torch.cumsum(uniq, 0, dtype=torch.int64)[uniq] - 1
    rev_hi[dest] = hi_s[uniq]
    rev_lo[dest] = lo_s[uniq]
    ar = torch.arange(T, dtype=torch.int64, device=dev)
    rev_ids = torch.where(ar < count, base + ar,
                          torch.full_like(ar, INT32_MAX)).to(torch.int32)
    return rev_ids, rev_hi, rev_lo


def sharded_dictionary_fn(hi: list, lo: list, valid: list, devices: list,
                          bin_cap: int, base: int):
    """The sharded dictionary build over per-shard term columns.

    ``hi``/``lo``/``valid`` hold shard i's term occurrences (int32/bool
    [n_i]) on ``devices[i]``.  The paper's algorithm with one all-to-all
    each way: occurrences --(hash partition)--> owner shards --(unique +
    scan)--> id assignment --(reverse all-to-all)--> resolved occurrence
    ids.  Returns per-shard lists, each entry on its shard's device:
    ``occ_ids`` int32[n_i] (-1 where invalid or dropped), the owner's
    table ``(hi_s, lo_s, ids_s, rev_ids, rev_hi, rev_lo)`` int32[S *
    bin_cap] each, ``overflow`` int32[1] and the owner's count int32[1] —
    what the reference's ``shard_map`` body gives on each shard.
    """
    S = len(devices)
    cap = bin_cap
    # 1. route occurrences to owner shards (dedup happens at the owner)
    binned, slots = [], []
    for i, d in enumerate(devices):
        with device_ctx(d):
            slots.append(_owner_slots(lo[i], valid[i], S))
            binned.append(_scatter_bins(hi[i], lo[i], valid[i], *slots[i],
                                        S, cap))
    recv_hi = [torch.stack(r) for r in all_to_all([b[0] for b in binned],
                                                  devices)]
    recv_lo = [torch.stack(r) for r in all_to_all([b[1] for b in binned],
                                                  devices)]
    # 2. local unique + global exclusive scan of counts (paper step 2)
    owned = []
    for j, d in enumerate(devices):
        with device_ctx(d):
            rhi_s, rlo_s, _ = pair64.sort_pairs(recv_hi[j].reshape(-1),
                                                recv_lo[j].reshape(-1))
            valid_s = rhi_s != SENTINEL
            uniq = pair64.unique_mask_sorted(rhi_s, rlo_s) & valid_s
            owned.append((rhi_s, rlo_s, valid_s, uniq,
                          uniq.sum(dtype=torch.int32)))
    counts = all_gather([o[4] for o in owned], devices)
    # 3. assign ids in each owner's disjoint range (paper step 3), then
    # 4. answer the asking shards: look every routed bin up in the table
    tables, answers, local = [], [], []
    for j, d in enumerate(devices):
        rhi_s, rlo_s, valid_s, uniq, count = owned[j]
        with device_ctx(d):
            offset = counts[j][:j].sum(dtype=torch.int64)
            ranks = torch.cumsum(uniq, 0, dtype=torch.int64) - 1
            ids_s = torch.where(valid_s, base + offset + ranks,
                                torch.full_like(ranks, -1)).to(torch.int32)
            ans, _ = pair64.lookup_pair(rhi_s, rlo_s, ids_s, recv_hi[j],
                                        recv_lo[j])
            tables.append((rhi_s, rlo_s, ids_s, *_reverse_view(
                rhi_s, rlo_s, ids_s, uniq, count, base + offset)))
            answers.append(ans)
            local.append(count.reshape(1))
    # 5. reverse the all-to-all, scatter bin answers onto occurrence order
    back = [torch.stack(r) for r in all_to_all(answers, devices)]
    occ_ids = []
    for i, d in enumerate(devices):
        owner, slot = slots[i]
        with device_ctx(d):
            keep = valid[i] & (slot < cap)
            flat = owner.clamp(max=S - 1) * cap + slot.clamp(max=cap - 1)
            occ_ids.append(torch.where(
                keep, back[i].reshape(-1)[flat],
                torch.full_like(flat, -1, dtype=torch.int32)))
    overflow = [b[2].reshape(1) for b in binned]
    return occ_ids, tables, overflow, local
