"""Gemma-2 27B [arXiv:2408.00118; hf]: alternating local/global attention,
logit softcapping, GeGLU, tied embeddings, sqrt(d) embedding scale.

46L, d_model=4608, 32 heads (GQA kv=16, head_dim=128), d_ff=36864,
vocab=256000; local window 4096; attn softcap 50, final softcap 30;
query scale 1/sqrt(query_pre_attn_scalar=144).

Half the layers are window-4096 local, which ``PagedEngine`` does not
serve: the port serves it through the contiguous ``lm.prefill`` ->
``lm.decode_step`` path, as the JAX package does.  A window layer's prefill
cache is sized to the prompt (ROADMAP R4), so prompts of at least 4,096
tokens keep every key of the window at decode.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2_27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    layer_pattern=("win", "attn"),  # local, then global — 23 periods
    window=4096,
    mlp_kind="geglu",
    attn_softcap=50.0,
    final_softcap=30.0,
    attn_scale=144.0**-0.5,  # query_pre_attn_scalar = d_model / n_heads
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    supports_long_context=True,
    notes="local+global alternating, softcaps; hd=128 independent of d/H",
)
