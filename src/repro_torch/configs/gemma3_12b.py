"""gemma3-12b [hf:google/gemma-3-12b-pt]: 48L d=3840 16H (kv=8) hd=256
ff=15360 v=262144, 5 local(window=1024) : 1 global, 128k context."""
from repro_torch.models.lm import LMConfig

ARCH_ID = "gemma3-12b"
FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
        head_dim=256, d_ff=15360, vocab=262144, act="geglu",
        window=1024, local_ratio=5, dtype="bfloat16",
    )


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=256, vocab=512, act="geglu",
        window=8, local_ratio=5, dtype="float32", loss_chunks=4, remat=False,
    )
