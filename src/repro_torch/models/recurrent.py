"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Block: dual-branch — x branch through a causal depthwise conv (width 4) into
the RG-LRU gated linear recurrence, gate branch through GeLU (the tanh form,
as ``jax.nn.gelu`` computes it); merged elementwise, projected back to
d_model.

The recurrence ``h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t ⊙ x_t)`` is linear in
``h``, so prefill and training run it through
:func:`repro_torch.kernels.ops.lru_scan`: the hand-written CUDA kernels
(forward and backward) for a CUDA tensor, their plain sequential versions
for a CPU tensor.  The JAX package sends only shapes with ``T % 8 == 0`` and
``R % 128 == 0`` (the TPU's sublane and lane granule) to its kernel and the
rest to an associative scan; the CUDA kernel takes any shape, so here every
shape goes through ``ops.lru_scan``.  Decode is a single step.  State is
fp32: ``lam``, ``bi`` and ``br`` stay fp32 under a bf16 ``param_dtype``.

Handed a ``common.Split``, the block runs tensor-parallel over the rnn
channels, where GSPMD leaves the weights' own layout
(``src/repro/models/recurrent.py:112-118`` constrains nothing): each
position computes its channels of both branches and of the conv, the gates
read the whole conv output (one all-gather) through its columns of ``wi``
and ``wr``, the scan (K5, and its backward in training) runs on its
``[B, S, R / tp]`` channels, and its rows of ``w_rnn_out`` give a partial
output, added over the positions by one all-reduce.  A decode cache is
then a list with one entry per position, each holding its channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.state import _default_device
from repro_torch.distributed import collectives as col
from repro_torch.kernels import ops
from repro_torch.models.common import (
    Split,
    _param,
    dense_init,
    partial_product,
    tp_inputs,
    tp_output,
)

_C = 8.0  # Griffin's gate temperature


class RGLRU(nn.Module):
    """The JAX ``rglru_init`` tree as parameters: ``w_x``, ``w_gate_branch``
    ``[D, R]``, ``w_rnn_out [R, D]``, ``conv_w [W, R]``, ``conv_b``, ``lam``,
    ``wi``, ``wr [R, R]``, ``bi``, ``br``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = _default_device(device)
        d, r, w, pd = cfg.d_model, cfg.rnn_width, cfg.conv_width, cfg.pdtype()
        f32 = torch.float32
        self.w_x = _param((d, r), pd, device)
        self.w_gate_branch = _param((d, r), pd, device)
        self.w_rnn_out = _param((r, d), pd, device)
        self.conv_w = _param((w, r), pd, device)
        self.conv_b = _param((r,), pd, device)
        self.lam = _param((r,), f32, device)
        self.wi = _param((r, r), pd, device)
        self.wr = _param((r, r), pd, device)
        self.bi = _param((r,), f32, device)
        self.br = _param((r,), f32, device)


def rglru_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> RGLRU:
    device = _default_device(device)
    p = RGLRU(cfg, device)
    d, r, w, pd = cfg.d_model, cfg.rnn_width, cfg.conv_width, cfg.pdtype()
    with torch.no_grad():
        # Λ init so a = σ(Λ)^c is spread over (0.9, 0.999) (Griffin appendix)
        u = torch.empty(r, dtype=torch.float32, device=device)
        u.uniform_(0.9**2, 0.999**2, generator=gen)
        p.lam.copy_(torch.log(u ** (1.0 / _C) / (1.0 - u ** (1.0 / _C))))
        p.w_x.copy_(dense_init(gen, (d, r), pd, device))
        p.w_gate_branch.copy_(dense_init(gen, (d, r), pd, device))
        p.w_rnn_out.copy_(dense_init(gen, (r, d), pd, device))
        p.conv_w.copy_(dense_init(gen, (w, r), pd, device))
        p.wi.copy_(dense_init(gen, (r, r), pd, device))
        p.wr.copy_(dense_init(gen, (r, r), pd, device))
        for zero in (p.conv_b, p.bi, p.br):
            zero.zero_()
    return p


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time.  x: [B,S,R]; w: [W,R].

    Tap ``i`` reads ``x`` shifted ``i`` steps later in time, zeros before the
    start, for any S (shorter sequences than the window included)."""
    width, s = w.shape[0], x.shape[1]
    out = x * w[-1]
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[-1 - i]
    return out + b


def _gates(xc: torch.Tensor, params: RGLRU, xc_all: torch.Tensor | None = None):
    """Recurrence weight a_t (log-space) and gated input, both fp32.  On a
    tensor-parallel position ``xc`` holds its channels and ``xc_all`` every
    channel, which the gate products read (``params`` its columns of ``wi``
    and ``wr``)."""
    x32 = xc.float()
    a32 = x32 if xc_all is None else xc_all.float()
    r_t = torch.sigmoid(a32 @ params.wr.float() + params.br)
    i_t = torch.sigmoid(a32 @ params.wi.float() + params.bi)
    log_a = -_C * r_t * F.softplus(-params.lam)  # log σ(Λ)^(c r_t)
    a = torch.exp(log_a)
    gated_x = i_t * x32
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * gated_x


def rglru_scan(xc: torch.Tensor, params: RGLRU, h0: torch.Tensor | None = None,
               xc_all: torch.Tensor | None = None):
    """Run the RG-LRU over a sequence.  xc: [B,S,R] (post-conv; on a
    tensor-parallel position its channels, ``xc_all`` every channel).

    Every (S, R) goes through ``ops.lru_scan`` (see the module docstring).
    Returns (y [B,S,R] in xc.dtype, h_last [B,R] fp32).
    """
    a, bx = _gates(xc, params, xc_all)  # [B,S,R] fp32
    batch, _, r = a.shape
    if h0 is None:
        h0 = torch.zeros((batch, r), dtype=torch.float32, device=xc.device)
    h = ops.lru_scan(a, bx, h0)
    # a copy, so that the cache does not hold the whole [B,S,R] scan alive
    return h.to(xc.dtype), h[:, -1].clone()


def rglru_step(xc: torch.Tensor, params: RGLRU, h: torch.Tensor,
               xc_all: torch.Tensor | None = None):
    """One decode step.  xc: [B,1,R]; h: [B,R] fp32 -> (y [B,1,R], h')."""
    a, bx = _gates(xc, params, xc_all)
    h_new = a[:, 0] * h + bx[:, 0]
    return h_new[:, None].to(xc.dtype), h_new


def init_rec_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    device = _default_device(device)
    r, w = cfg.rnn_width, cfg.conv_width
    return {
        "conv": torch.zeros((batch, w - 1, r), dtype=cfg.dtype(), device=device),
        "h": torch.zeros((batch, r), dtype=torch.float32, device=device),
    }


def _branches(x: torch.Tensor, params: RGLRU):
    """The x branch before its conv, and the GeLU gate branch."""
    return x @ params.w_x, F.gelu(x @ params.w_gate_branch, approximate="tanh")


def _split_conv(x: torch.Tensor, params: Split):
    """Each position's branches and conv output, and every position's copy
    of the whole conv output (one all-gather); ``x`` whole on the lead or
    a stream split by sequence (``common.tp_inputs``: the conv and the scan
    read the whole time axis)."""
    xs = tp_inputs(x, params.group)
    zs, gates, zcs = [], [], []
    for xi, p in zip(xs, params.parts):
        z, gate = _branches(xi, p)
        zs.append(z)
        gates.append(gate)
        zcs.append(causal_conv(z, p.conv_w, p.conv_b))
    zc_all = col.broadcast(col.all_gather(zcs, params.group), params.group)
    return zs, gates, zcs, zc_all


def rec_block_train(x: torch.Tensor, params: RGLRU, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence forward without a cache (training), differentiable: the
    scan's gradient comes from ``ops.lru_scan``'s backward."""
    if isinstance(params, Split):
        _, gates, zcs, zc_all = _split_conv(x, params)
        return tp_output([partial_product(rglru_scan(zc, p, xc_all=za)[0] * gate, p.w_rnn_out)
                          for zc, za, gate, p in zip(zcs, zc_all, gates, params.parts)],
                         x, params.group)
    z, gate = _branches(x, params)
    zc = causal_conv(z, params.conv_w, params.conv_b)
    y, _ = rglru_scan(zc, params)
    return (y * gate) @ params.w_rnn_out


def rec_block_prefill(x: torch.Tensor, params: RGLRU, cfg: ModelConfig):
    """[B,S,D] -> (out [B,S,D], cache {"conv" [B,W-1,R], "h" [B,R] fp32});
    split, the list of the positions' caches."""
    if isinstance(params, Split):
        zs, gates, zcs, zc_all = _split_conv(x, params)
        outs, caches = [], []
        for z, zc, za, gate, p in zip(zs, zcs, zc_all, gates, params.parts):
            y, h_last = rglru_scan(zc, p, xc_all=za)
            outs.append(partial_product(y * gate, p.w_rnn_out))
            caches.append({"conv": _conv_tail(z, cfg.conv_width), "h": h_last})
        return col.all_reduce(outs, params.group, x.dtype), caches
    z, gate = _branches(x, params)
    zc = causal_conv(z, params.conv_w, params.conv_b)
    y, h_last = rglru_scan(zc, params)
    out = (y * gate) @ params.w_rnn_out
    return out, {"conv": _conv_tail(z, cfg.conv_width), "h": h_last}


def _conv_tail(z: torch.Tensor, w: int) -> torch.Tensor:
    """The last ``w - 1`` steps of the x branch, the decode conv's history."""
    tail = z[:, -(w - 1) :].clone()
    if tail.shape[1] < w - 1:  # S < conv window: left-pad
        tail = F.pad(tail, (0, 0, w - 1 - tail.shape[1], 0))
    return tail


def _decode_conv(x: torch.Tensor, params: RGLRU, cache: dict):
    """The branches and the conv output of one decode step, and the conv's
    history with this step's input."""
    z, gate = _branches(x, params)  # z: [B,1,R]
    hist = torch.cat([cache["conv"], z], dim=1)  # [B,W,R]
    zc = torch.einsum("bwr,wr->br", hist.float(), params.conv_w.float())
    zc = (zc + params.conv_b.float())[:, None].to(z.dtype)
    return gate, hist, zc


def rec_block_decode(x: torch.Tensor, params: RGLRU, cfg: ModelConfig, cache: dict):
    """x: [B,1,D] -> (out [B,1,D], new cache); ``cache`` is left as it was
    (split: a list of the positions' caches, and a new list back)."""
    if isinstance(params, Split):
        steps = [_decode_conv(xi, p, c) for xi, p, c in
                 zip(col.broadcast(x, params.group), params.parts, cache)]
        zc_all = col.broadcast(col.all_gather([s[2] for s in steps], params.group),
                               params.group)
        outs, caches = [], []
        for (gate, hist, zc), za, p, c in zip(steps, zc_all, params.parts, cache):
            y, h_new = rglru_step(zc, p, c["h"], za)
            outs.append(partial_product(y * gate, p.w_rnn_out))
            caches.append({"conv": hist[:, 1:], "h": h_new})
        return col.all_reduce(outs, params.group, x.dtype), caches
    gate, hist, zc = _decode_conv(x, params, cache)
    y, h_new = rglru_step(zc, params, cache["h"])
    out = (y * gate) @ params.w_rnn_out
    return out, {"conv": hist[:, 1:], "h": h_new}
