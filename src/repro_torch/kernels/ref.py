"""Plain-torch oracles for the ported kernels (the correctness contracts).

Each ``ref_*`` is the plain version that sits beside its kernel — the
port of the JAX package's oracle of the same name — so the CPU tests hold
it against that oracle, and ``chip_smoke.py`` holds the CUDA kernel
against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.merge_sorted import merge_path_plain
from repro_torch.kernels.pair_search import pair_search_plain
from repro_torch.kernels.stream_compact import compact_tiles_plain

ref_stream_compact = compact_tiles_plain
ref_pair_search = pair_search_plain


def ref_merge_sorted(a_hi, a_lo, b_hi, b_lo):
    """Gather map of the stable merge of two lex-sorted (hi, lo) runs."""
    n, m = a_hi.shape[0], b_hi.shape[0]
    if m == 0 or n == 0:
        return torch.arange(n + m, dtype=torch.int32, device=a_hi.device)
    return merge_path_plain(a_hi, a_lo, b_hi, b_lo)
