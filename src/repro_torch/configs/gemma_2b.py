"""gemma-2b [arXiv:2403.08295]: 18L d=2048 8H MQA(kv=1) hd=256 GeGLU
ff=16384 v=256000."""
from repro_torch.models.lm import LMConfig

ARCH_ID = "gemma-2b"
FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        head_dim=256, d_ff=16384, vocab=256000, act="geglu", dtype="bfloat16",
    )


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=32, d_ff=256, vocab=512, act="geglu",
        dtype="float32", loss_chunks=4, remat=False,
    )
