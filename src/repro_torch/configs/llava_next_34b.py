"""LLaVA-NeXT 34B [hf:llava-hf/llava-v1.6 family]: VLM decoder backbone
(Yi/Nous-Hermes-34B-style), anyres vision tiling stubbed.

60L, d_model=7168, 56 heads (GQA kv=8, head_dim=128), d_ff=20480,
vocab=64000.  The anyres vision tower + projector is a STUB:
``input_specs()`` supplies precomputed patch embeddings ``[B, S, d_model]``
(mixed image-patch + text positions, already projected), so the backbone
runs through the contiguous ``lm.prefill`` -> ``lm.decode_step`` path fed
with embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava_next_34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    layer_pattern=("attn",),
    mlp_kind="swiglu",
    embed_inputs=False,  # vision frontend stub feeds embeddings
    rope_theta=5_000_000.0,
    supports_long_context=False,
    notes="VLM backbone; anyres frontend stubbed",
)
