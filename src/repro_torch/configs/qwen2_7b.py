"""Qwen2-7B [arXiv:2407.10671; hf]: dense GQA with QKV bias.

28L, d_model=3584, 28 heads (GQA kv=4, head_dim=128), d_ff=18944,
vocab=152064.  SwiGLU, RoPE theta 1e6.  The port carries it so that the
tests cover QKV bias and a large RoPE theta.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    layer_pattern=("attn",),
    mlp_kind="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    microbatch_per_device=2,
    supports_long_context=False,
    notes="QKV bias",
)
