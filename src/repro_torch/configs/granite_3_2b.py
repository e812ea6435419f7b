"""IBM Granite-3.0 2B base [hf:ibm-granite/granite-3.0-2b-base]: dense GQA.

40L, d_model=2048, 32 heads (GQA kv=8, head_dim=64), d_ff=8192, vocab=49155.
SwiGLU, tied embeddings (per HF config), RoPE theta 10k.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_3_2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    layer_pattern=("attn",),
    mlp_kind="swiglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    microbatch_per_device=2,
    supports_long_context=False,
    notes="GQA 32q/8kv",
)
