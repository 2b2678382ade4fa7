"""deepseek-v2-236b [arXiv:2405.04434]: 60L d=5120 128H, MLA kv_lora=512
(q_lora=1536, rope=64), v=102400; MoE 160 routed top-6 + 2 shared,
expert ff=1536; layer 0 dense (ff=12288)."""
from repro_torch.models.lm import LMConfig

ARCH_ID = "deepseek-v2-236b"
FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        head_dim=128, d_ff=1536, vocab=102400, act="swiglu",
        attn="mla", q_lora=1536, kv_lora=512, rope_dim=64,
        moe=True, n_experts=160, top_k=6, n_shared=2, moe_dff=1536,
        dense_layers=1, dense_dff=12288, dtype="bfloat16",
        capacity_factor=1.1,
    )


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, act="swiglu",
        attn="mla", q_lora=32, kv_lora=16, rope_dim=8,
        moe=True, n_experts=8, top_k=2, n_shared=1, moe_dff=32,
        dense_layers=1, dense_dff=128, dtype="float32", loss_chunks=4,
        remat=False,
    )
