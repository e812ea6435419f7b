"""RecurrentGemma-9B / Griffin [arXiv:2402.19427]: RG-LRU + local attention.

38L, d_model=4096, 16 heads (MQA kv=1, head_dim=256), d_ff=12288,
vocab=256000.  Pattern (rec, rec, win) — 2 recurrent blocks per local-
attention block, window 2048; 38 = 12×3 + 2 trailing recurrent layers.
lru_width = d_model (published lru_width unconfirmed for 9B — documented
assumption).  Bounded state -> long_500k runs.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma_9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=("rec", "rec", "win"),
    tail_pattern=("rec", "rec"),
    window=2048,
    mlp_kind="geglu",
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    supports_long_context=True,
    notes="RG-LRU 2:1 local attn (MQA); assoc-scan recurrence",
)
