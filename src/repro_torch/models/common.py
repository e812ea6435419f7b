"""Shared model components: norms, RoPE, MLP variants, initializers.

All math accumulates in fp32 where precision matters (norms, softmax) and
casts back to the compute dtype; parameters are stored in ``param_dtype``.
Weights keep the JAX package's ``[in, out]`` layout (``x @ W``), so weights
carry across unchanged.  The JAX package's sharding constraints are the
identity on one device, so the models call none; their rules are ported as
data in ``repro_torch.distributed.sharding``, which the dry-run reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.state import _default_device


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32 with a ``(1 + weight)`` scale (zero-initialised weight)."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# -- rotary position embeddings ------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """RoPE's ``(cos, sin)`` for ``positions [..., S]``, each ``[..., S, 1, hd/2]``.

    Every layer of a step rotates by the same positions, so a caller may
    compute these once and hand them to :func:`apply_rope`.
    """
    freqs = rope_freqs(head_dim, theta, positions.device)  # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, hd/2]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, cos_sin=None):
    """Half-split RoPE: the first and second halves of ``head_dim`` rotate as
    pairs ``(x[i], x[i + hd/2])``.

    x: [..., S, n_heads, head_dim]; positions: [..., S] (broadcastable);
    ``cos_sin``: :func:`rope_cos_sin` of the same positions, if precomputed.
    """
    hd = x.shape[-1]
    cos, sin = cos_sin if cos_sin is not None else rope_cos_sin(positions, hd, theta)
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2 :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- initializers ---------------------------------------------------------------


def _param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised inference-only parameter (filled by an init or a load)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def _truncated_normal(shape, gen: torch.Generator, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)


def dense_init(gen, shape, dtype, device=None, scale_axis: int = 0) -> torch.Tensor:
    """Truncated-normal fan-in init (stddev 1/sqrt(fan_in)), drawn in fp32 and
    scaled in place (one fp32 temporary a leaf: nemotron's 5 GiB MLP leaves)."""
    std = 1.0 / math.sqrt(shape[scale_axis])
    return _truncated_normal(shape, gen, _default_device(device)).mul_(std).to(dtype)


def embed_init(gen, shape, dtype, device=None) -> torch.Tensor:
    return _truncated_normal(shape, gen, _default_device(device)).to(dtype)


# -- MLPs -----------------------------------------------------------------------


class MLP(nn.Module):
    """Dense FFN weights: gated kinds hold ``w_gate, w_in [D,F]`` and
    ``w_out [F,D]``; ungated kinds ``w_in`` and ``w_out``."""

    def __init__(self, d_model: int, d_ff: int, kind: str, dtype, device=None):
        super().__init__()
        device = _default_device(device)
        self.w_in = _param((d_model, d_ff), dtype, device)
        self.w_out = _param((d_ff, d_model), dtype, device)
        if kind in ("swiglu", "geglu"):
            self.w_gate = _param((d_model, d_ff), dtype, device)


def mlp_forward(x: torch.Tensor, params, kind: str) -> torch.Tensor:
    """Dense FFN.  ``relu2`` is the squared-ReLU of Primer/Nemotron-4 (no gate);
    ``gelu`` is the tanh approximation, as ``jax.nn.gelu`` computes it."""
    if kind in ("swiglu", "geglu"):
        gate = x @ params.w_gate
        act = F.silu(gate) if kind == "swiglu" else F.gelu(gate, approximate="tanh")
        h = act * (x @ params.w_in)
    elif kind == "relu2":
        h = torch.square(F.relu(x @ params.w_in))
    elif kind == "gelu":
        h = F.gelu(x @ params.w_in, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    return h @ params.w_out


def mlp_init(gen, d_model: int, d_ff: int, kind: str, dtype, device=None) -> MLP:
    device = _default_device(device)
    mlp = MLP(d_model, d_ff, kind, dtype, device)
    with torch.no_grad():
        mlp.w_in.copy_(dense_init(gen, (d_model, d_ff), dtype, device))
        mlp.w_out.copy_(dense_init(gen, (d_ff, d_model), dtype, device, scale_axis=0))
        if kind in ("swiglu", "geglu"):
            mlp.w_gate.copy_(dense_init(gen, (d_model, d_ff), dtype, device))
    return mlp
