"""xLSTM blocks: mLSTM (matrix memory, exponential gating) and sLSTM
(scalar memory, per-head recurrent gating) — arXiv:2405.04517.

Both cells keep fp32, max-stabilised gate states (``m``, initialised to
-1e30).  The JAX package runs them as ``lax.scan`` over time; here they are
Python loops over time in plain PyTorch (no Pallas kernel stands behind
either cell in the reference).  A prefill of at least ``2 * _CHUNK`` tokens
takes the chunkwise-parallel mLSTM, a shorter one the sequential cell, at
the reference's threshold, because the two differ in fp32 rounding.

Handed a ``common.Split``, either block runs tensor-parallel by heads over
a data-parallel group's positions (``models/tensor_parallel.py`` ``plan``:
each position holds its heads' columns, channels, recurrence blocks and
rows): the mLSTM gathers ``z`` and its conv output onto every position,
since q, k and v contract over every channel, then runs its heads' cell;
the sLSTM gathers its positions' conv outputs once and runs each head's
block-diagonal recurrence on its position for every step.  The partial
products of ``down`` and ``out_proj`` are added in fp32 (an all-reduce, or
the mLSTM's a reduce-scatter under sequence parallelism); the cells keep
the whole block's fp32 states and order of operations per head.  A decode
cache is then a list of the positions' states.

Block structure (paper appendix):
  mLSTM block: LN -> up-proj (pf=2) to (z, gate); causal conv4 on z; q,k
    from conv output, v from z; per-head mLSTM cell; out = cell ⊙ SiLU(gate);
    down-proj. Self-contained expansion (no separate FFN; d_ff=0).
  sLSTM block: LN -> causal conv4 -> cell (4 heads, block-diag recurrence)
    -> out-proj; then LN -> GeGLU MLP (pf 4/3 * 2) as in the paper.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.state import _default_device
from repro_torch.distributed import collectives as col
from repro_torch.models.common import (
    Split,
    _param,
    dense_init,
    in_layout,
    partial_product,
    stream_add,
    tp_inputs,
    tp_output,
)
from repro_torch.models.recurrent import causal_conv

N_HEADS = 4  # xLSTM-125M uses 4 heads for both cell types
_CHUNK = 64  # chunkwise-parallel mLSTM chunk length (sequential below 2x)
_M0 = -1e30  # the stabiliser's initial value


def _conv_tail(z: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width - 1`` rows of ``z`` [B,S,R], left-padded with zeros
    when S is shorter: the decode conv's history after a prefill."""
    tail = z[:, -(width - 1) :].clone()
    if tail.shape[1] < width - 1:
        tail = F.pad(tail, (0, 0, width - 1 - tail.shape[1], 0))
    return tail


def _conv_step(hist: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The decode conv in fp32: hist [B,W,R] against w [W,R] -> [B,R] fp32."""
    return torch.einsum("bwr,wr->br", hist.float(), w.float()) + b.float()


# =============================================================================
# mLSTM
# =============================================================================


class MLSTM(nn.Module):
    """The JAX ``mlstm_init`` tree: ``up [D, 2R]``, ``conv_w [W, R]``,
    ``conv_b``, ``wq``/``wk``/``wv``/``skip [R, R]``, ``down [R, D]`` in the
    param dtype; ``wi``/``wf [R, H]``, ``bi``/``bf [H]`` fp32 (R = 2D)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = _default_device(device)
        d, pd, f32 = cfg.d_model, cfg.pdtype(), torch.float32
        r = 2 * d
        self.up = _param((d, 2 * r), pd, device)
        self.conv_w = _param((cfg.conv_width, r), pd, device)
        self.conv_b = _param((r,), pd, device)
        self.wq = _param((r, r), pd, device)
        self.wk = _param((r, r), pd, device)
        self.wv = _param((r, r), pd, device)
        self.wi = _param((r, N_HEADS), f32, device)
        self.wf = _param((r, N_HEADS), f32, device)
        self.bi = _param((N_HEADS,), f32, device)
        self.bf = _param((N_HEADS,), f32, device)
        self.down = _param((r, d), pd, device)
        self.skip = _param((r, r), pd, device)


def mlstm_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> MLSTM:
    device = _default_device(device)
    p = MLSTM(cfg, device)
    with torch.no_grad():
        for name in ("up", "conv_w", "wq", "wk", "wv", "wi", "wf", "down", "skip"):
            t = getattr(p, name)
            t.copy_(dense_init(gen, tuple(t.shape), t.dtype, device))
        p.conv_b.zero_()
        p.bi.zero_()
        p.bf.fill_(3.0)  # forget-open init
    return p


def _mlstm_cell_step(state, inputs):
    """state: (C [B,H,hd,hd], n [B,H,hd], m [B,H]); one timestep (fp32)."""
    c, n, m = state
    q, k, v, logi, logf = inputs  # q/k/v: [B,H,hd]; logi/logf: [B,H]
    m_new = torch.maximum(logf + m, logi)
    i_p = torch.exp(logi - m_new)[..., None]  # [B,H,1]
    f_p = torch.exp(logf + m - m_new)[..., None]
    c_new = f_p[..., None] * c + i_p[..., None] * (v[..., :, None] * k[..., None, :])
    n_new = f_p * n + i_p * k
    denom = torch.clamp(torch.abs(torch.sum(n_new * q, dim=-1)), min=1.0)  # [B,H]
    h = torch.einsum("bhij,bhj->bhi", c_new, q) / denom[..., None]
    return (c_new, n_new, m_new), h


def mlstm_cell(q, k, v, logi, logf, state):
    """The cell over time, one step at a time.  q/k/v: [B,S,H,hd] fp32;
    gates [B,S,H].  Returns (h [B,S,H,hd], final state)."""
    hs = []
    for t in range(q.shape[1]):
        state, h = _mlstm_cell_step(state, (q[:, t], k[:, t], v[:, t], logi[:, t], logf[:, t]))
        hs.append(h)
    return torch.stack(hs, dim=1), state


def _cummax(x: torch.Tensor) -> torch.Tensor:
    """The running max of ``x`` along dim 1 (the reference's ``lax.cummax``)
    by doubling: ``log2 L`` elementwise maxima, the values of
    ``torch.cummax`` bit for bit.  ``torch.cummax``'s backward scatters its
    gradient with atomic adds on the card, so a training step's update
    would vary from run to run; this one's is elementwise."""
    step = 1
    while step < x.shape[1]:
        x = torch.cat([x[:, :step], torch.maximum(x[:, step:], x[:, :-step])], dim=1)
        step *= 2
    return x


def mlstm_cell_chunked(q, k, v, logi, logf, state, chunk: int = 64):
    """Chunkwise-parallel mLSTM: algebraically the sequential cell, with a
    serial depth of S/chunk.  Within a chunk the stabiliser recurrence
    m_t = max(logf_t + m_{t-1}, logi_t) expands to
    ``max(m_prev + b_t, cummax_{j<=t}(b_t - b_j + logi_j))`` with b the
    within-chunk cumulative log-forget, as in the reference."""
    b_, s, h, hd = q.shape
    L = next(d for d in range(min(chunk, s), 0, -1) if s % d == 0)
    nc = s // L
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    c_prev, n_prev, m_prev = state  # [B,H,hd,hd], [B,H,hd], [B,H]
    outs = []
    for ci in range(nc):
        sl = slice(ci * L, (ci + 1) * L)
        qc, kc, vc, lic, lfc = q[:, sl], k[:, sl], v[:, sl], logi[:, sl], logf[:, sl]
        b = torch.cumsum(lfc, dim=1)  # [B,L,H] cumulative log-forget
        g = lic - b  # [B,L,H]
        gmax = _cummax(g)
        m_t = torch.maximum(m_prev[:, None] + b, b + gmax)  # [B,L,H]
        inter = torch.exp(m_prev[:, None] + b - m_t)  # [B,L,H]
        # stabilised intra-chunk weights: logS[t,j] = b_t - m_t + g_j (j<=t)
        log_s = (b - m_t)[:, :, None] + g[:, None, :]  # [B,L,L,H]
        sw = torch.where(mask[None, :, :, None], torch.exp(log_s), 0.0)
        scores = torch.einsum("bthd,bjhd->btjh", qc, kc)
        num = torch.einsum("btjh,bjhd->bthd", sw * scores, vc)
        # inter-chunk readout: C[b,h,d,e] has d the v dim, e the k dim
        num = num + torch.einsum("bhde,bthe->bthd", c_prev, qc) * inter[..., None]
        n_t = n_prev[:, None] * inter[..., None] + torch.einsum("btjh,bjhd->bthd", sw, kc)
        denom = torch.clamp(torch.abs(torch.sum(n_t * qc, dim=-1)), min=1.0)
        outs.append(num / denom[..., None])
        # carry to the chunk's end (position L-1)
        b_tot = b[:, -1]  # [B,H]
        m_end = m_t[:, -1]
        carry_scale = torch.exp(m_prev + b_tot - m_end)  # [B,H]
        w_j = torch.exp((b_tot - m_end)[:, None] + g)  # [B,L,H]
        c_prev = c_prev * carry_scale[..., None, None] + torch.einsum(
            "bjhd,bjhe->bhde", w_j[..., None] * vc, kc
        )
        n_prev = n_prev * carry_scale[..., None] + torch.einsum("bjh,bjhd->bhd", w_j, kc)
        m_prev = m_end
    return torch.cat(outs, dim=1), (c_prev, n_prev, m_prev)


def init_mlstm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    device = _default_device(device)
    r = 2 * cfg.d_model
    hd = r // N_HEADS
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, r), dtype=cfg.dtype(), device=device),
            **_mlstm_state0(batch, N_HEADS, hd, device)}


def _mlstm_state0(batch: int, heads: int, hd: int, device) -> dict:
    """The cell's initial state over ``heads`` heads."""
    f32 = torch.float32
    return {"c": torch.zeros((batch, heads, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((batch, heads, hd), dtype=f32, device=device),
            "m": torch.full((batch, heads), _M0, dtype=f32, device=device)}


def _mlstm_qkv(z, zc, params: MLSTM, hd: int):
    """q, k, v and the gates of ``params``' heads (a tensor-parallel
    position's columns of ``wq``, ``wk``, ``wv``, ``wi`` and ``wf``) from
    every channel of ``z`` and ``zc``."""
    b, s, _ = z.shape
    q = (zc @ params.wq).reshape(b, s, -1, hd).float() * hd**-0.5
    k = (zc @ params.wk).reshape(b, s, -1, hd).float() * hd**-0.5
    v = (z @ params.wv).reshape(b, s, -1, hd).float()
    logi = zc.float() @ params.wi + params.bi
    logf = F.logsigmoid(zc.float() @ params.wf + params.bf)
    return q, k, v, logi, logf


def _mlstm_conv(z, params, cache: dict | None, width: int, mode: str):
    """The conv of ``z`` (a position's channels, with its ``conv_w`` and
    ``conv_b``) and the conv history a decode step reads next."""
    if mode == "decode":
        hist = torch.cat([cache["conv"], z], dim=1)
        return _conv_step(hist, params.conv_w, params.conv_b)[:, None].to(z.dtype), hist[:, 1:]
    if mode in ("train", "prefill"):
        return causal_conv(z, params.conv_w, params.conv_b), _conv_tail(z, width)
    raise ValueError(mode)


def _mlstm_heads(z, zc, params: MLSTM, hd: int, cache: dict | None, mode: str):
    """``params``' heads of the cell over ``z`` and ``zc`` from ``cache``'s
    state (or the initial one): (h ``[B, S, heads hd]`` fp32, final state);
    a prefill of at least ``2 * _CHUNK`` tokens takes the chunked cell."""
    b, s, _ = z.shape
    q, k, v, logi, logf = _mlstm_qkv(z, zc, params, hd)
    heads = q.shape[2]
    if cache is not None:  # continue from a prior state
        state = (cache["c"], cache["n"], cache["m"])
    else:
        state = tuple(_mlstm_state0(b, heads, hd, z.device).values())
    if mode == "decode":
        state, h = _mlstm_cell_step(state, (q[:, 0], k[:, 0], v[:, 0], logi[:, 0], logf[:, 0]))
        h = h[:, None]
    elif s >= 2 * _CHUNK:
        h, state = mlstm_cell_chunked(q, k, v, logi, logf, state, _CHUNK)
    else:
        h, state = mlstm_cell(q, k, v, logi, logf, state)
    return h.reshape(b, s, heads * hd), state


def _halves(t: torch.Tensor):
    """The two branches of an up projection's output, side by side."""
    half = t.shape[-1] // 2
    return t[..., :half], t[..., half:]


def mlstm_block(x, params: MLSTM, cfg: ModelConfig, cache: dict | None = None, *, mode: str):
    """mode: train | prefill | decode.  x: [B,S,D] ([B,1,D] for decode).
    Returns (out [B,S,D], new cache), ``cache`` left as it was; ``train``
    runs the prefill path and returns ``out`` alone, as the reference does.
    ``params`` a ``common.Split``: by heads over its positions
    (:func:`_mlstm_split`)."""
    if isinstance(params, Split):
        return _mlstm_split(x, params, cfg, cache, mode)
    hd = 2 * cfg.d_model // N_HEADS
    z, gate = _halves(x @ params.up)
    zc, conv = _mlstm_conv(z, params, cache, cfg.conv_width, mode)
    h, state = _mlstm_heads(z, zc, params, hd, cache, mode)
    hr = h.to(x.dtype) + zc @ params.skip
    out = (hr * F.silu(gate)) @ params.down
    if mode == "train":
        return out
    return out, {"conv": conv, "c": state[0], "n": state[1], "m": state[2]}


def _mlstm_split(x, params: Split, cfg: ModelConfig, cache: list | None, mode: str):
    """The mLSTM block over a group's positions, each holding its heads
    (``params.parts[t]``: its columns of ``up``'s two branches, ``wq``,
    ``wk``, ``wv``, ``skip``, ``wi`` and ``wf``, its channels of the conv,
    its rows of ``down``).  Each position computes its channels of ``z``
    and their conv; ``q``, ``k`` and ``v`` contract over every channel, so
    ``z`` and its conv are gathered onto every position; each position then
    runs its heads' cell, and the partial products of ``down`` meet in
    ``common.tp_output``.  ``x`` whole on the lead or a ``Stream``; a cache
    is a list of the positions' states."""
    group, hd = params.group, 2 * cfg.d_model // N_HEADS
    caches = cache if cache is not None else [None] * len(params.parts)
    xs = tp_inputs(x, group)
    zs, gates, zcs, convs = [], [], [], []
    for xi, p, c in zip(xs, params.parts, caches):
        z, gate = _halves(xi @ p.up)
        zc, conv = _mlstm_conv(z, p, c, cfg.conv_width, mode)
        zs.append(z)
        gates.append(gate)
        zcs.append(zc)
        convs.append(conv)
    z_all = col.broadcast(col.all_gather(zs, group), group)
    zc_all = col.broadcast(col.all_gather(zcs, group), group)
    outs, new = [], []
    for z, zc, gate, conv, p, c in zip(z_all, zc_all, gates, convs, params.parts, caches):
        h, state = _mlstm_heads(z, zc, p, hd, c, mode)
        hr = h.to(z.dtype) + zc @ p.skip
        outs.append(partial_product(hr * F.silu(gate), p.down))
        new.append({"conv": conv, "c": state[0], "n": state[1], "m": state[2]})
    out = tp_output(outs, x, group)
    return out if mode == "train" else (out, new)


# =============================================================================
# sLSTM
# =============================================================================


class SLSTM(nn.Module):
    """The JAX ``slstm_init`` tree: ``conv_w [W, D]``, ``conv_b``,
    ``out_proj [D, D]``, ``up [D, 2F]``, ``down [F, D]`` (F = 4D/3) in the
    param dtype; gate weights ``wi``/``wf``/``wz``/``wo_gate [D, D]``, biases
    and the block-diagonal recurrences ``ri``/``rf``/``rz``/``ro [H, hd, hd]``
    fp32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = _default_device(device)
        d, pd, f32 = cfg.d_model, cfg.pdtype(), torch.float32
        hd, f_up = d // N_HEADS, int(d * 4 / 3)
        self.conv_w = _param((cfg.conv_width, d), pd, device)
        self.conv_b = _param((d,), pd, device)
        for name in ("wi", "wf", "wz", "wo_gate"):
            setattr(self, name, _param((d, d), f32, device))
        for name in ("bi", "bf", "bz", "bo"):
            setattr(self, name, _param((d,), f32, device))
        for name in ("ri", "rf", "rz", "ro"):
            setattr(self, name, _param((N_HEADS, hd, hd), f32, device))
        self.out_proj = _param((d, d), pd, device)
        self.up = _param((d, 2 * f_up), pd, device)
        self.down = _param((f_up, d), pd, device)


def slstm_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> SLSTM:
    device = _default_device(device)
    p = SLSTM(cfg, device)
    with torch.no_grad():
        for name in ("conv_w", "wi", "wf", "wz", "wo_gate", "ri", "rf", "rz", "ro",
                     "out_proj", "up", "down"):
            t = getattr(p, name)
            axis = 1 if name in ("ri", "rf", "rz", "ro") else 0
            t.copy_(dense_init(gen, tuple(t.shape), t.dtype, device, scale_axis=axis))
        for name in ("conv_b", "bi", "bz", "bo"):
            getattr(p, name).zero_()
        p.bf.fill_(3.0)
    return p


def _rec(h: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-head recurrent contribution: h [B,d] x r [H,hd,hd] -> [B,d] (on a
    tensor-parallel position its heads: ``r`` its blocks)."""
    b, d = h.shape
    hh = h.reshape(b, r.shape[0], r.shape[1])
    return torch.einsum("bhi,hij->bhj", hh, r).reshape(b, d)


def _slstm_cell_step(params: SLSTM, state, x_t):
    """state: (c, n, m, h) each [B,d] fp32; x_t: [B,d] fp32 (post-conv)."""
    c, n, m, h = state
    raw_i = x_t @ params.wi + params.bi + _rec(h, params.ri)
    raw_f = x_t @ params.wf + params.bf + _rec(h, params.rf)
    raw_z = x_t @ params.wz + params.bz + _rec(h, params.rz)
    raw_o = x_t @ params.wo_gate + params.bo + _rec(h, params.ro)
    logf = F.logsigmoid(raw_f)
    m_new = torch.maximum(logf + m, raw_i)
    i_p = torch.exp(raw_i - m_new)
    f_p = torch.exp(logf + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(raw_z)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(raw_o) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h_new), h_new


def init_slstm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    device = _default_device(device)
    d = cfg.d_model
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, d), dtype=cfg.dtype(), device=device),
            **_slstm_state0(batch, d, device)}


def _slstm_state0(batch: int, width: int, device) -> dict:
    """The cell's initial state over ``width`` channels."""
    f32 = torch.float32
    return {"c": torch.zeros((batch, width), dtype=f32, device=device),
            "n": torch.zeros((batch, width), dtype=f32, device=device),
            "m": torch.full((batch, width), _M0, dtype=f32, device=device),
            "h": torch.zeros((batch, width), dtype=f32, device=device)}


def _slstm_conv(x, params, cache: dict | None, width: int, mode: str):
    """The conv of ``x`` (a position's channels, with its ``conv_w`` and
    ``conv_b``) in fp32, and the conv history a decode step reads next."""
    if mode == "decode":
        hist = torch.cat([cache["conv"], x], dim=1)
        return _conv_step(hist, params.conv_w, params.conv_b)[:, None], hist[:, 1:]
    if mode in ("train", "prefill"):
        return causal_conv(x, params.conv_w, params.conv_b).float(), _conv_tail(x, width)
    raise ValueError(mode)


def _slstm_heads(xc, params: SLSTM, cache: dict | None):
    """``params``' heads of the cell (a tensor-parallel position's columns of
    the gate weights, its recurrence blocks) over every channel of ``xc``
    [B,S,D] fp32, step by step from ``cache``'s state (or the initial
    one): (h [B,S,heads hd] fp32, final state)."""
    if cache is not None:
        state = (cache["c"], cache["n"], cache["m"], cache["h"])
    else:
        state = tuple(_slstm_state0(xc.shape[0], params.wi.shape[1], xc.device).values())
    hs = []
    for t in range(xc.shape[1]):  # the reference's lax.scan, one step at a time
        state, h_t = _slstm_cell_step(params, state, xc[:, t])
        hs.append(h_t)
    return torch.stack(hs, dim=1), state


def _geglu(y, params: SLSTM) -> torch.Tensor:
    """The FFN's hidden units (GeGLU, pf 4/3) of ``params``' columns of
    ``up``'s two branches."""
    u, g = _halves(y @ params.up)
    return F.gelu(g, approximate="tanh") * u


def _slstm_cache(conv, state) -> dict:
    return {"conv": conv, "c": state[0], "n": state[1], "m": state[2], "h": state[3]}


def slstm_block(x, params: SLSTM, cfg: ModelConfig, cache: dict | None = None, *, mode: str):
    """mode: train | prefill | decode.  x: [B,S,D].  Returns (the block's
    delta [B,S,D], new cache), ``cache`` left as it was; ``train`` returns the
    delta alone.  ``params`` a ``common.Split``: by heads over its positions
    (:func:`_slstm_split`)."""
    if isinstance(params, Split):
        return _slstm_split(x, params, cfg, cache, mode)
    xc, conv = _slstm_conv(x, params, cache, cfg.conv_width, mode)
    hs, state = _slstm_heads(xc, params, cache)
    cell_out = hs.to(x.dtype) @ params.out_proj
    # feed-forward sub-block (GeGLU, pf 4/3) around the cell's residual
    y = x + cell_out
    ff = _geglu(y, params) @ params.down
    out = ff + cell_out  # the block's delta (the caller adds the residual)
    if mode == "train":
        return out
    return out, _slstm_cache(conv, state)


def _slstm_split(x, params: Split, cfg: ModelConfig, cache: list | None, mode: str):
    """The sLSTM block over a group's positions, each holding its heads
    (``params.parts[t]``: its channels of the conv, its columns of the gate
    weights and biases, its recurrence blocks, its rows of ``out_proj``).
    Each position runs the conv on its channels; the gates read every
    channel of the conv output, so the positions' outputs are gathered onto
    every position once (for the whole prompt, or once a decode step); the
    recurrence is block-diagonal by head, so each position then runs its
    heads for every step alone.  Their partial products of ``out_proj``
    meet in an all-reduce on the lead, since the FFN reads ``x + cell_out``
    whole.  The FFN splits its hidden units where the spans hold an ``"f"``
    span (the rows of ``down``, both branches' columns of ``up``), its
    partials added in ``x``'s layout, else runs whole on the lead.  ``x``
    whole on the lead or a ``Stream``; a cache is a list of the positions'
    states."""
    group = params.group
    caches = cache if cache is not None else [None] * len(params.parts)
    xs = tp_inputs(x, group)
    xcs, convs = [], []
    for xi, p, span, c in zip(xs, params.parts, params.spans, caches):
        xc, conv = _slstm_conv(xi[..., slice(*span["c"])], p, c, cfg.conv_width, mode)
        xcs.append(xc)
        convs.append(conv)
    xc_all = col.broadcast(col.all_gather(xcs, group), group)
    dtype = xs[0].dtype
    cells, new = [], []
    for xc, conv, p, c in zip(xc_all, convs, params.parts, caches):
        hs, state = _slstm_heads(xc, p, c)
        cells.append(partial_product(hs.to(dtype), p.out_proj))
        new.append(_slstm_cache(conv, state))
    cell_out = col.all_reduce(cells, group, dtype)
    y = xs[0] + cell_out
    if "f" in params.spans[0]:
        ff = tp_output([partial_product(_geglu(yi, p), p.down)
                        for yi, p in zip(col.broadcast(y, group), params.parts)], x, group)
        out = stream_add(ff, in_layout(cell_out, x))
    else:
        lead = params.parts[0]
        out = in_layout(_geglu(y, lead) @ lead.down + cell_out, x)
    return out if mode == "train" else (out, new)
