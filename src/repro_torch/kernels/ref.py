"""Plain-torch oracles for the ported kernels (the correctness contracts).

Each ``ref_*`` is the plain version that sits beside its kernel — the
port of the JAX package's oracle of the same name — so the CPU tests hold
it against that oracle, and ``chip_smoke.py`` holds the CUDA kernel
against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.closure_expand import closure_expand_plain
from repro_torch.kernels.interval_filter import interval_filter_plain
from repro_torch.kernels.merge_sorted import merge_path_plain
from repro_torch.kernels.msc_select import msc_select_plain
from repro_torch.kernels.pair_search import pair_search_plain
from repro_torch.kernels.stream_compact import (
    compact_tiles_plain, dual_compact_tiles_plain, member_tiles_plain,
)

ref_stream_compact = compact_tiles_plain
ref_pair_search = pair_search_plain
ref_msc_select = msc_select_plain
ref_closure_expand = closure_expand_plain


def ref_interval_filter(s, p, o, plo, phi, olo, ohi, type_id):
    """LiteMat triple-pattern mask ``plo <= p < phi and olo <= o < ohi``
    (the reference's signature: ``s`` and ``type_id`` are not read)."""
    return interval_filter_plain(p, o, (plo, phi, olo, ohi))


def ref_dual_compact(mask_a, mask_b, block: int):
    """Two independent tile-local compactions of masks over the same rows
    -> (local_a, counts_a, local_b, counts_b)."""
    (la, ca), (lb, cb) = dual_compact_tiles_plain(mask_a, mask_b, block)
    return la, ca, lb, cb


def ref_merge_sorted(a_hi, a_lo, b_hi, b_lo):
    """Gather map of the stable merge of two lex-sorted (hi, lo) runs."""
    n, m = a_hi.shape[0], b_hi.shape[0]
    if m == 0 or n == 0:
        return torch.arange(n + m, dtype=torch.int32, device=a_hi.device)
    return merge_path_plain(a_hi, a_lo, b_hi, b_lo)


def ref_member_compact(spo, alive, tid, mem, dom, rng, has_dom, has_rng,
                       block):
    """K4's oracle (the reference has none): the rewrite type pattern's
    masks, as the reference's ``query.py::_type_rewrite_masks_dyn``
    computes them, then ``ref_stream_compact`` of each — the plain version
    over the store's columns -> [(local, counts)] per stream."""
    return member_tiles_plain(spo[:, 0], spo[:, 1], spo[:, 2], alive, tid,
                              mem, dom, rng, has_dom, has_rng, block)
