"""Nemotron-4-340B [arXiv:2402.16819]: dense GQA decoder, squared-ReLU MLP.

96L, d_model=18432, 96 heads (GQA kv=8, head_dim=192), d_ff=73728,
vocab=256000.  Ungated squared-ReLU FFN (Primer), untied embeddings.
AdamW m/v and the gradient accumulator in bf16, as the reference keeps
them.  Served through ``PagedEngine``: 12 query rows a kv head at head_dim
192, the paged-decode kernel's hd-192 instance.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron_4_340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    layer_pattern=("attn",),
    mlp_kind="relu2",
    rope_theta=10_000.0,
    opt_state_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
    microbatch_per_device=2,
    supports_long_context=False,  # pure full attention: long_500k skipped
    notes="squared-ReLU (Primer) ungated FFN; GQA 96q/8kv @ hd=192",
)
