"""xLSTM-125M [arXiv:2405.04517]: sLSTM + mLSTM recurrent blocks.

12L, d_model=768, 4 heads, vocab=50304 (GPT-NeoX tokenizer rounding);
d_ff=0 — xLSTM blocks carry their own expansion (mLSTM pf=2, sLSTM ff 4/3).
Block placement: sLSTM at layers {3, 7, 11}, mLSTM elsewhere (xLSTM-[7:1]-
style minority-sLSTM; exact 125M placement unpublished — documented
assumption, DESIGN.md §5).

No KV cache: serving state is recurrent (paged-KV migration inapplicable;
morsel/data migration still applies).  Fully recurrent -> long_500k runs.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm_125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    tie_embeddings=True,
    microbatch_per_device=8,
    supports_long_context=True,
    notes="sequential sLSTM scan; mLSTM sequential baseline (chunkwise = perf lever)",
)
