"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family]: 128 experts top-8.

94L, d_model=4096, 64 heads (GQA kv=4, head_dim=128), per-expert d_ff=1536,
vocab=151936.  QK-norm (Qwen3), no QKV bias, SwiGLU experts.  EP over the
model axis: 8 experts per TP shard.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3_moe_235b_a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    layer_pattern=("moe",),
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=1536),
    mlp_kind="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    supports_long_context=False,
    notes="128e top-8; qk-norm; ~22B active of 235B total",
)
