"""olmoe-1b-7b [arXiv:2409.02060]: 16L d=2048 16H (kv=16) v=50304,
MoE 64 experts top-8, expert ff=1024."""
from repro_torch.models.lm import LMConfig

ARCH_ID = "olmoe-1b-7b"
FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=1024, vocab=50304, act="swiglu",
        moe=True, n_experts=64, top_k=8, moe_dff=1024, dtype="bfloat16",
    )


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=64, vocab=512, act="swiglu",
        moe=True, n_experts=8, top_k=2, moe_dff=64, dtype="float32",
        loss_chunks=4, remat=False,
    )
