"""Shared model components: norms, RoPE, MLP variants, initializers.

All math accumulates in fp32 where precision matters (norms, softmax) and
casts back to the compute dtype; parameters are stored in ``param_dtype``.
Weights keep the JAX package's ``[in, out]`` layout (``x @ W``), so weights
carry across unchanged.  The JAX package's sharding constraints become, on
a device mesh, tensor-parallel compute: a layer handed a :class:`Split` in
place of its parameters runs on each of a group's tensor-parallel
positions over that position's block of its weights and joins the partial
products with the collectives of ``repro_torch.distributed.collectives``
(Megatron's column- and row-parallel layout); ``models/tensor_parallel.py``
decides which layers split, by the reference's own conditions.  Called
with its parameters, a layer runs whole, as on one device.

Under sequence parallelism (the reference's residual constraint ``("dp",
"seq", None)`` with ``seq`` on the model axis) the residual stream of a
group is a list: ``x[t]`` position ``t``'s rows of ``[B, S, D]`` on its
device.  A split layer then takes its input all-gathered over the
sequence onto every position and leaves each position its rows of the
sum of the partial outputs, a reduce-scatter (:func:`tp_inputs`,
:func:`tp_output`: Megatron's sequence-parallel pair in place of its f
and g).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.state import _default_device
from repro_torch.distributed import collectives as col


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


# -- tensor-parallel layers ------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Split:
    """A layer's parameters over a data-parallel group's tensor-parallel
    positions (``models/tensor_parallel.py`` builds it): ``parts[t]`` is the
    layer's module on position ``t`` with its block of each split weight
    bound, ``cfgs[t]`` the config that block computes under (its heads or
    channels), ``spans[t]`` the range of the split dim it holds (heads,
    channels or experts) and ``group`` the positions
    (``distributed/collectives.py`` ``Group``)."""

    parts: list
    group: col.Group
    cfgs: list
    spans: list


def stream_norm(x, weight: torch.Tensor, group: col.Group | None, eps: float):
    """RMS norm of the residual stream; split by sequence, on each
    position's rows with its copy of the weight (bound on the lead and
    broadcast, so its gradient adds the positions')."""
    if not isinstance(x, list):
        return rms_norm(x, weight, eps)
    return [rms_norm(xi, w, eps) for xi, w in zip(x, col.broadcast(weight, group))]


def stream_add(x, y):
    """``x + y`` of two streams in the same layout, whole or split."""
    return [a + b for a, b in zip(x, y)] if isinstance(x, list) else x + y


def tp_inputs(x, group: col.Group) -> list[torch.Tensor]:
    """Each position's copy of a split layer's input: ``x`` whole on the
    lead broadcast, or a stream split by sequence (a list of the
    positions' rows) all-gathered along the sequence onto every position.
    Backward, the positions' gradients added (and each position's rows
    handed back to it)."""
    if isinstance(x, list):
        return col.broadcast(col.all_gather(x, group, dim=1), group)
    return col.broadcast(x, group)


def tp_output(parts: list[torch.Tensor], x, group: col.Group):
    """The sum of a split layer's partial outputs in ``x``'s layout and
    dtype: on the lead (an all-reduce), or for a stream split by sequence
    each position's rows (a reduce-scatter, the same sums bit for bit)."""
    if isinstance(x, list):
        return col.reduce_scatter(parts, group, dim=1, dtype=x[0].dtype)
    return col.all_reduce(parts, group, x.dtype)


class _PartialProduct(torch.autograd.Function):
    """``x @ w`` with an fp32 result; the backward's products in the
    operands' dtype, as autograd takes those of ``x @ w``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        else:  # the CPU has no mixed-dtype product: the same values through fp32
            y = x2.float() @ w.float()
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return g @ w.T, gw


def partial_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel partial product ``x @ w`` (``x`` a position's slice of
    the contracting dim, ``w`` its rows): in fp32, so that the all-reduce
    that adds the positions' partials rounds the sum once, as the whole
    product rounds once."""
    return x @ w if x.dtype == torch.float32 else _PartialProduct.apply(x, w)


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
    ``gelu`` is the tanh approximation, as ``jax.nn.gelu`` computes it.

    ``params`` a :class:`Split`: each position computes its columns of
    ``w_gate`` and ``w_in`` and its rows of ``w_out``, and one all-reduce
    adds the partial outputs (the reference's ``tp_worthwhile`` constraint
    on the hidden dim, ``src/repro/models/common.py:72-74``); ``x`` may be a
    stream split by sequence (the module docstring)."""
    if isinstance(params, Split):
        xs = tp_inputs(x, params.group)
        return tp_output([partial_product(_mlp_hidden(xi, p, kind), p.w_out)
                          for xi, p in zip(xs, params.parts)], x, params.group)
    return _mlp_hidden(x, params, kind) @ params.w_out


def _mlp_hidden(x: torch.Tensor, params, kind: str) -> torch.Tensor:
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
    return h


def mlp_init(gen, d_model: int, d_ff: int, kind: str, dtype, device=None) -> MLP:
    device = _default_device(device)
    mlp = MLP(d_model, d_ff, kind, dtype, device)
    with torch.no_grad():
        mlp.w_in.copy_(dense_init(gen, (d_model, d_ff), dtype, device))
        mlp.w_out.copy_(dense_init(gen, (d_ff, d_model), dtype, device, scale_axis=0))
        if kind in ("swiglu", "geglu"):
            mlp.w_gate.copy_(dense_init(gen, (d_model, d_ff), dtype, device))
    return mlp
