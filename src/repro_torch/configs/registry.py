"""Architecture registry: --arch <id> resolution for launchers and tests.

The nine architectures in the reference's order: the LM family's five
and the GNN family's four."""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_v2_236b, equiformer_v2, gat_cora, gatedgcn, gemma3_12b,
    gemma_2b, olmo_1b, olmoe_1b_7b, schnet,
)
from repro_torch.configs.shapes import GNN_SHAPES, LM_SHAPES

_MODULES = [
    olmo_1b, gemma_2b, gemma3_12b, olmoe_1b_7b, deepseek_v2_236b,
    equiformer_v2, gat_cora, gatedgcn, schnet,
]

ARCHS = {m.ARCH_ID: m for m in _MODULES}

SHAPE_TABLES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES}

# documented skips: long_500k only for hybrid-attention archs
SKIPS = {
    ("olmo-1b", "long_500k"): "pure full attention — long_500k skipped per brief",
    ("gemma-2b", "long_500k"): "pure full attention — long_500k skipped per brief",
    ("olmoe-1b-7b", "long_500k"): "pure full attention — long_500k skipped per brief",
    ("deepseek-v2-236b", "long_500k"): "pure full attention (MLA) — long_500k skipped per brief",
}


# optimization variants (per family config overrides)
VARIANTS = {
    "flash": {"lm": dict(attn_impl="blockwise")},
    "noattn": {"lm": dict(attn_impl="stub")},  # measurement surrogate
    "mrestrict": {"gnn": dict(rotate_restrict=True, edge_dtype="bfloat16")},
}


def get_arch(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def variant_overrides(variant: str, family: str) -> dict:
    if variant not in VARIANTS:
        raise KeyError(f"unknown variant {variant!r}; known: {sorted(VARIANTS)}")
    return VARIANTS[variant].get(family, {})


def shapes_for(arch_id: str) -> dict:
    return SHAPE_TABLES[get_arch(arch_id).FAMILY]


def all_cells(include_skipped: bool = False):
    for arch_id, mod in ARCHS.items():
        for shape_id in SHAPE_TABLES[mod.FAMILY]:
            skip = SKIPS.get((arch_id, shape_id))
            if skip and not include_skipped:
                continue
            yield arch_id, shape_id, skip
