"""DBRX-132B [hf:databricks/dbrx-base]: fine-grained MoE, 16 experts top-4.

40L, d_model=6144, 48 heads (GQA kv=8, head_dim=128), per-expert d_ff=10752,
vocab=100352.  Every layer: GQA attention + MoE FFN.  EP over the 16-wide
model axis puts exactly 1 expert per TP shard.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx_132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    layer_pattern=("moe",),
    moe=MoEConfig(n_experts=16, top_k=4, d_ff=10752),
    mlp_kind="swiglu",
    rope_theta=500_000.0,
    supports_long_context=False,
    notes="16e top-4 fine-grained MoE; EP=16 (1 expert/shard)",
)
