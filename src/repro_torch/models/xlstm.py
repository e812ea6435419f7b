"""xLSTM blocks: mLSTM (matrix memory, exponential gating) and sLSTM
(scalar memory, per-head recurrent gating) — arXiv:2405.04517.

Both cells keep fp32, max-stabilised gate states (``m``, initialised to
-1e30).  The JAX package runs them as ``lax.scan`` over time; here they are
Python loops over time in plain PyTorch (no Pallas kernel stands behind
either cell in the reference).  A prefill of at least ``2 * _CHUNK`` tokens
takes the chunkwise-parallel mLSTM, a shorter one the sequential cell, at
the reference's threshold, because the two differ in fp32 rounding.

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
from repro_torch.models.common import _param, dense_init
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
        gmax = torch.cummax(g, dim=1).values
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
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, r), dtype=cfg.dtype(), device=device),
        "c": torch.zeros((batch, N_HEADS, hd, hd), dtype=f32, device=device),
        "n": torch.zeros((batch, N_HEADS, hd), dtype=f32, device=device),
        "m": torch.full((batch, N_HEADS), _M0, dtype=f32, device=device),
    }


def _mlstm_qkv(z, zc, params: MLSTM):
    b, s, r = z.shape
    hd = r // N_HEADS
    q = (zc @ params.wq).reshape(b, s, N_HEADS, hd).float() * hd**-0.5
    k = (zc @ params.wk).reshape(b, s, N_HEADS, hd).float() * hd**-0.5
    v = (z @ params.wv).reshape(b, s, N_HEADS, hd).float()
    logi = zc.float() @ params.wi + params.bi
    logf = F.logsigmoid(zc.float() @ params.wf + params.bf)
    return q, k, v, logi, logf


def mlstm_block(x, params: MLSTM, cfg: ModelConfig, cache: dict | None = None, *, mode: str):
    """mode: train | prefill | decode.  x: [B,S,D] ([B,1,D] for decode).
    Returns (out [B,S,D], new cache), ``cache`` left as it was; ``train``
    runs the prefill path and returns ``out`` alone, as the reference does."""
    b, s, d = x.shape
    r = 2 * d
    zg = x @ params.up
    z, gate = zg[..., :r], zg[..., r:]
    if mode == "decode":
        hist = torch.cat([cache["conv"], z], dim=1)
        zc = _conv_step(hist, params.conv_w, params.conv_b)[:, None].to(z.dtype)
        q, k, v, logi, logf = _mlstm_qkv(z, zc, params)
        state = (cache["c"], cache["n"], cache["m"])
        state, h1 = _mlstm_cell_step(state, (q[:, 0], k[:, 0], v[:, 0], logi[:, 0], logf[:, 0]))
        h = h1[:, None]
        conv = hist[:, 1:]
    elif mode in ("train", "prefill"):
        zc = causal_conv(z, params.conv_w, params.conv_b)
        q, k, v, logi, logf = _mlstm_qkv(z, zc, params)
        if cache is not None:  # continue from a prior state
            state = (cache["c"], cache["n"], cache["m"])
        else:
            hd = r // N_HEADS
            state = (
                torch.zeros((b, N_HEADS, hd, hd), dtype=torch.float32, device=x.device),
                torch.zeros((b, N_HEADS, hd), dtype=torch.float32, device=x.device),
                torch.full((b, N_HEADS), _M0, dtype=torch.float32, device=x.device),
            )
        if s >= 2 * _CHUNK:
            h, state = mlstm_cell_chunked(q, k, v, logi, logf, state, _CHUNK)
        else:
            h, state = mlstm_cell(q, k, v, logi, logf, state)
        conv = _conv_tail(z, cfg.conv_width)
    else:
        raise ValueError(mode)
    hr = h.reshape(b, s, r).to(x.dtype) + zc @ params.skip
    out = (hr * F.silu(gate)) @ params.down
    if mode == "train":
        return out
    return out, {"conv": conv, "c": state[0], "n": state[1], "m": state[2]}


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
    """Per-head recurrent contribution: h [B,d] x r [H,hd,hd] -> [B,d]."""
    b, d = h.shape
    hh = h.reshape(b, N_HEADS, d // N_HEADS)
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
    d, f32 = cfg.d_model, torch.float32
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, d), dtype=cfg.dtype(), device=device),
        "c": torch.zeros((batch, d), dtype=f32, device=device),
        "n": torch.zeros((batch, d), dtype=f32, device=device),
        "m": torch.full((batch, d), _M0, dtype=f32, device=device),
        "h": torch.zeros((batch, d), dtype=f32, device=device),
    }


def slstm_block(x, params: SLSTM, cfg: ModelConfig, cache: dict | None = None, *, mode: str):
    """mode: train | prefill | decode.  x: [B,S,D].  Returns (the block's
    delta [B,S,D], new cache), ``cache`` left as it was; ``train`` returns the
    delta alone."""
    b, s, d = x.shape
    if mode == "decode":
        hist = torch.cat([cache["conv"], x], dim=1)
        state = (cache["c"], cache["n"], cache["m"], cache["h"])
        state, h1 = _slstm_cell_step(params, state, _conv_step(hist, params.conv_w, params.conv_b))
        hs = h1[:, None]
        conv = hist[:, 1:]
    elif mode in ("train", "prefill"):
        xc = causal_conv(x, params.conv_w, params.conv_b).float()
        if cache is not None:
            state = (cache["c"], cache["n"], cache["m"], cache["h"])
        else:
            z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
            state = (z, z, torch.full((b, d), _M0, dtype=torch.float32, device=x.device), z)
        hs = []
        for t in range(s):  # the reference's lax.scan, one step at a time
            state, h_t = _slstm_cell_step(params, state, xc[:, t])
            hs.append(h_t)
        hs = torch.stack(hs, dim=1)
        conv = _conv_tail(x, cfg.conv_width)
    else:
        raise ValueError(mode)
    cell_out = hs.to(x.dtype) @ params.out_proj
    # feed-forward sub-block (GeGLU, pf 4/3) around the cell's residual
    y = x + cell_out
    f_up = params.down.shape[0]
    uz = y @ params.up
    u, g = uz[..., :f_up], uz[..., f_up:]
    ff = (F.gelu(g, approximate="tanh") * u) @ params.down
    out = ff + cell_out  # the block's delta (the caller adds the residual)
    if mode == "train":
        return out
    return out, {"conv": conv, "c": state[0], "n": state[1], "m": state[2], "h": state[3]}
