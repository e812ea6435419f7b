"""Reduced-config factory: same family/block structure, tiny dims.

A copy of the JAX package's ``configs/smoke.py``: the tests compare reduced
configs across the two packages, so the reduction must be the same.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig


def reduce(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to laptop scale, preserving its structure."""
    period = len(cfg.layer_pattern)
    tail = len(cfg.tail_pattern)
    n_layers = period * (2 if period > 1 else 2) + tail  # 2 periods + tail
    kvh = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1
    heads_per_kv = max(cfg.n_heads // cfg.n_kv_heads, 1)
    n_heads = kvh * min(heads_per_kv, 2)
    head_dim = 16
    d_model = 64
    moe = None
    if cfg.moe is not None:
        # capacity_factor large enough that no token drops: capacity dropping
        # is batch-dependent, which would (correctly, but unhelpfully) make
        # prefill and one-by-one decode disagree in the cache-equivalence test
        moe = MoEConfig(
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            d_ff=32,
            capacity_factor=8.0,
        )
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=kvh,
        head_dim=head_dim,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=128,
        window=min(cfg.window, 8) if cfg.window else 0,
        moe=moe,
        lru_width=None,
        param_dtype="float32",
        compute_dtype="float32",
        attn_chunk=16,
        name=cfg.name + "_smoke",
    )
