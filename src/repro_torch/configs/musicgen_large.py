"""MusicGen-large [arXiv:2306.05284; hf]: decoder-only over EnCodec tokens.

48L, d_model=2048, 32 heads (kv=32 -> MHA, head_dim=64), d_ff=8192,
vocab=2048 (one EnCodec codebook; backbone-only per assignment).  The
modality frontend is a STUB: ``input_specs()`` supplies precomputed EnCodec
frame *embeddings* ``[B, S, d_model]``; the head predicts codebook ids.
Plain (ungated) GELU FFN as in the original transformer decoder.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    layer_pattern=("attn",),
    mlp_kind="gelu",
    embed_inputs=False,  # frontend stub feeds embeddings
    microbatch_per_device=2,
    supports_long_context=False,
    notes="audio backbone; MHA (kv=32); EnCodec frontend stubbed",
)
