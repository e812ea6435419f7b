"""Analytic FLOP/byte accountant per (arch x shape) step.

The JAX package's ``roofline/flops.py``, the same arithmetic: every count
here equals the reference's for every arch, shape and chip count.  It is
exact for the model code (the math is written out per block kind), and the
reference calibrates it against XLA's cost analysis on scan-free probes.

Conventions:
  fwd flops for a matmul [a,b]x[b,c] = 2abc;
  train = 4x fwd for recomputed blocks (fwd + recompute + 2x bwd), 3x for
  the parts that are not recomputed (embed, head);
  attention context: causal full = S/2 average, window = min(W, S).

The training bytes assume the reference's mesh, data parallelism of 16 at
256 chips and of 32 otherwise (``_hbm_bytes``), unless ``step_cost`` is
given ``dp``: that is the reference's assumption about a TPU pod, kept so
that the counts agree.  The dry-run on one card passes ``dp=1`` and the
cell's cut shape (a ``ShapeSpec`` in place of the shape's name).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec, spec_of


@dataclasses.dataclass
class StepCost:
    fwd_flops: float  # whole step, all chips, forward only
    total_flops: float  # with bwd/remat multipliers (train) or == fwd
    hbm_bytes: float  # whole step, all chips
    detail: dict


def _block_fwd_flops_per_token(cfg: ModelConfig, kind: str, s_ctx: float) -> float:
    d, h, hd, kvh = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    f = 0.0
    if kind in ("attn", "win", "moe"):
        f += 2 * d * (cfg.q_dim + 2 * cfg.kv_dim)  # qkv proj
        f += 4 * h * hd * s_ctx  # scores + values
        f += 2 * cfg.q_dim * d  # o proj
        if kind == "moe":
            mc = cfg.moe
            f += 2 * d * mc.n_experts  # router
            n_mats = 3  # swiglu experts
            f += mc.top_k * n_mats * 2 * d * mc.d_ff  # expert ffn
            # einsum dispatch+combine: 2 x (2·E·C·D) with E·C = k·Tg·cf
            tg = 512.0  # launcher targets ~512-token groups
            f += 2 * 2 * mc.top_k * tg * mc.capacity_factor * d
        else:
            n_mats = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
            f += n_mats * 2 * d * cfg.d_ff
    elif kind == "rec":
        r = cfg.rnn_width
        f += 3 * 2 * d * r  # w_x, gate branch, out
        f += 2 * 2 * r * r  # wi, wr gates
        f += 2 * cfg.conv_width * r + 10 * r  # conv + scan combine
        n_mats = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
        f += n_mats * 2 * d * cfg.d_ff
    elif kind == "mlstm":
        r = 2 * d
        hd_m = r // 4
        f += 2 * d * 2 * r  # up
        f += 3 * 2 * r * r  # q,k,v proj
        f += 2 * r * r  # skip
        f += 2 * cfg.conv_width * r
        f += 5 * r * hd_m  # cell (C update + readout)
        f += 2 * r * d  # down
    elif kind == "slstm":
        f += 4 * 2 * d * d  # gate projections
        f += 8 * d * (d // 4)  # block-diag recurrences
        f += 2 * d * d  # out proj
        f_up = int(d * 4 / 3)
        f += 2 * d * 2 * f_up + 2 * f_up * d  # GeGLU ff
    else:
        raise ValueError(kind)
    return f


def _layers(cfg: ModelConfig):
    return list(cfg.layer_kinds)


def step_cost(cfg: ModelConfig, shape: str | ShapeSpec, n_chips: int, *,
              dp: int | None = None) -> StepCost:
    """The step's counts.  ``shape`` is a name in ``SHAPES`` or a
    ``ShapeSpec`` (a cell cut to fit one card keeps its kind and sequence
    with a smaller batch); ``dp`` replaces the reference's data parallelism
    in the training bytes (16 at 256 chips, else 32).  Given a name and no
    ``dp``, the counts are the reference's."""
    sp = spec_of(shape)
    if sp.kind == "train":
        n_tokens = sp.global_batch * sp.seq_len
        s_ctx_full = sp.seq_len / 2
    elif sp.kind == "prefill":
        n_tokens = sp.global_batch * sp.seq_len
        s_ctx_full = sp.seq_len / 2
    else:  # decode: 1 token/seq against a seq_len cache
        n_tokens = sp.global_batch
        s_ctx_full = sp.seq_len

    layer_fwd_per_tok = 0.0
    for kind in _layers(cfg):
        s_ctx = min(cfg.window, s_ctx_full) if kind == "win" else s_ctx_full
        layer_fwd_per_tok += _block_fwd_flops_per_token(cfg, kind, s_ctx)
    head_fwd_per_tok = 2 * cfg.d_model * cfg.vocab_size
    if sp.kind == "decode":
        head_total = head_fwd_per_tok * sp.global_batch
    elif sp.kind == "prefill":
        head_total = head_fwd_per_tok * sp.global_batch  # last position only
    else:
        head_total = head_fwd_per_tok * n_tokens

    fwd = layer_fwd_per_tok * n_tokens + head_total
    if sp.kind == "train":
        total = 4.0 * layer_fwd_per_tok * n_tokens + 3.0 * head_total
    else:
        total = fwd

    hbm = _hbm_bytes(cfg, sp, n_chips, dp)
    return StepCost(
        fwd_flops=fwd,
        total_flops=total,
        hbm_bytes=hbm["total"],
        detail=hbm,
    )


def _itemsize(dtype_name: str) -> int:
    return getattr(torch, dtype_name).itemsize


def _param_bytes(cfg: ModelConfig) -> int:
    return cfg.param_count() * _itemsize(cfg.param_dtype)


def _cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Decode-cache bytes (KV for attn/win/moe layers + recurrent state)."""
    by = 0.0
    esz = _itemsize(cfg.compute_dtype)
    for kind in _layers(cfg):
        if kind in ("attn", "moe"):
            by += 2 * batch * seq * cfg.kv_dim * esz
        elif kind == "win":
            by += 2 * batch * min(cfg.window, seq) * cfg.kv_dim * esz
        elif kind == "rec":
            by += batch * cfg.rnn_width * (4 + (cfg.conv_width - 1) * esz)
        elif kind == "mlstm":
            r = 2 * cfg.d_model
            by += batch * (r // 4) * r * 4  # matrix memory fp32
        elif kind == "slstm":
            by += 4 * batch * cfg.d_model * 4
    return by


def _hbm_bytes(cfg: ModelConfig, sp: ShapeSpec, n_chips: int, dp: int | None) -> dict:
    """Whole-step HBM traffic (all chips), napkin-level but itemized."""
    p = _param_bytes(cfg)
    esz = _itemsize(cfg.compute_dtype)
    act_io_per_layer = cfg.d_model * esz * 2  # residual write+read per token
    n_layers = cfg.n_layers
    out = {}
    if sp.kind == "train":
        if dp is None:
            dp = 16 if n_chips == 256 else 32
        n_micro = max(1, sp.global_batch // (dp * cfg.microbatch_per_device))
        n_tokens = sp.global_batch * sp.seq_len
        out["weights"] = 3.0 * p * n_micro  # fwd + recompute + bwd reads
        out["activations"] = 3.0 * n_tokens * n_layers * act_io_per_layer
        o = 4 if cfg.opt_state_dtype == "float32" else 2
        out["optimizer"] = 2 * (2 * cfg.param_count() * o) + 3 * p  # rw m,v; rw p; read g
        out["grads"] = 2 * cfg.param_count() * 4
    elif sp.kind == "prefill":
        n_tokens = sp.global_batch * sp.seq_len
        out["weights"] = 1.0 * p
        out["activations"] = n_tokens * n_layers * act_io_per_layer
        out["cache_write"] = _cache_bytes(cfg, sp.global_batch, sp.seq_len)
    else:  # decode
        out["weights"] = 1.0 * p
        out["cache_read"] = _cache_bytes(cfg, sp.global_batch, sp.seq_len)
        out["activations"] = sp.global_batch * n_layers * act_io_per_layer
    out["total"] = float(sum(out.values()))
    return out
