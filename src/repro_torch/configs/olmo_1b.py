"""olmo-1b [arXiv:2402.00838]: 16L d=2048 16H (kv=16) ff=8192 v=50304,
non-parametric LayerNorm."""
from repro_torch.models.lm import LMConfig

ARCH_ID = "olmo-1b"
FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=8192, vocab=50304, act="swiglu",
        norm="layernorm_nonparam", dtype="bfloat16",
    )


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=256, vocab=512, act="swiglu",
        norm="layernorm_nonparam", dtype="float32", loss_chunks=4, remat=False,
    )
