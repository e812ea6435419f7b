"""Attention: GQA/MQA/MHA with RoPE, sliding windows, logit softcaps, QKV
bias and QK-norm.

Three execution paths, as in the JAX package's ``models/attention.py``:

  * train and prefill: query-chunked causal attention in fp32 (a Python loop over
    query blocks, the JAX ``lax.scan``), so the score matrix never exceeds
    ``[B, KVH, G, chunk, Sk]``.  It stays plain PyTorch with the reference's
    chunking and softmax, so that the two packages agree;
  * decode: single-token attention against a contiguous cache, updated in
    place (global layers: length S_max; window layers: a rolling buffer);
  * paged decode (serving engine): the CUDA kernel behind
    ``repro_torch.kernels.ops.paged_decode_partial``, reading through a leap
    block table.

Handed a ``common.Split``, the train, prefill and decode paths run
tensor-parallel (the reference's head-sharded constraints,
``src/repro/models/attention.py:70-73`` and ``:160-161``): each position
projects its q heads and the KV heads they read, attends over them, and
multiplies by its rows of ``wo``; one all-reduce adds the partial outputs
(in training, over a stream split by sequence, a reduce-scatter:
``common.tp_output``).  A split prefill gathers the positions' KV heads
into the layer's whole cache on the lead, each head from the first
position that holds it.

Over a device mesh the decode cache is laid out by the reference's rule
(``distributed/sharding.py`` ``cache_spec``, ``src/repro/launch/dryrun.py:
83-108``): the time axis over a group's tensor-parallel positions, each
holding its slots of every KV head (:class:`SeqKV`), where the positions
divide the slot count; else whole on the group's lead.  A decode step then
combines flash-decode partials, the reference's all-reduces of a softmax
over a time-sharded cache (``src/repro/models/attention.py:8-11``): each
position attends every q head over its own slots, giving fp32 ``(acc, m,
l)`` (its softmax's unnormalised sum, max and denominator), and ``m =
max m_t``, ``l = Σ l_t e^{m_t - m}``, ``o = Σ acc_t e^{m_t - m} / l``.

A decode step's position ``pos`` is an int, or a 0-dim int64 tensor on the
lead's device (the reference's traced ``pos``: a captured step then serves
every position).  Everything that depends on it is computed from it on the
card, RoPE's positions, the masks and the rolling slots' positions alike,
and the new k and v are written by :func:`_write_kv`: given a tensor slot,
each position writes its local slot ``g - t T / n`` (``g`` the global slot)
only where that lies in its slots, and elsewhere writes the slot it names
back to itself.  A step over a :class:`SeqKV` or a split layer takes an int
``pos`` as such a tensor; only the unsharded step writes an int's slot
directly.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.state import _default_device
from repro_torch.distributed import collectives as col
from repro_torch.models.common import (
    Split,
    _param,
    apply_rope,
    dense_init,
    partial_product,
    rms_norm,
    softcap,
    tp_inputs,
    tp_output,
)

# -- params -------------------------------------------------------------------


class Attention(nn.Module):
    """Projection weights ``wq [D, H*hd]``, ``wk``/``wv [D, KVH*hd]``,
    ``wo [H*hd, D]``, and optional biases and QK-norm scales."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = _default_device(device)
        d, qd, kvd, pd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.pdtype()
        self.wq = _param((d, qd), pd, device)
        self.wk = _param((d, kvd), pd, device)
        self.wv = _param((d, kvd), pd, device)
        self.wo = _param((qd, d), pd, device)
        if cfg.qkv_bias:
            self.bq = _param((qd,), pd, device)
            self.bk = _param((kvd,), pd, device)
            self.bv = _param((kvd,), pd, device)
        if cfg.qk_norm:
            self.q_norm = _param((cfg.head_dim,), pd, device)
            self.k_norm = _param((cfg.head_dim,), pd, device)


def attn_init(gen, cfg: ModelConfig, device=None) -> Attention:
    device = _default_device(device)
    p = Attention(cfg, device)
    d, qd, kvd, pd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.pdtype()
    with torch.no_grad():
        p.wq.copy_(dense_init(gen, (d, qd), pd, device))
        p.wk.copy_(dense_init(gen, (d, kvd), pd, device))
        p.wv.copy_(dense_init(gen, (d, kvd), pd, device))
        p.wo.copy_(dense_init(gen, (qd, d), pd, device))
        for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
            if hasattr(p, name):
                getattr(p, name).zero_()
    return p


def _project_qkv(x, params: Attention, cfg: ModelConfig, positions, cos_sin=None):
    """x: [B,S,D] -> q [B,S,H,hd], k/v [B,S,KVH,hd] (RoPE applied; ``cos_sin``
    is RoPE's tables for ``positions`` when the caller computed them once)."""
    b, s, _ = x.shape
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.qkv_bias:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm, cfg.norm_eps)
        k = rms_norm(k, params.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cos_sin)
    k = apply_rope(k, positions, cfg.rope_theta, cos_sin)
    return q, k, v


def _scale(cfg: ModelConfig) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else cfg.head_dim**-0.5


# -- core: chunked causal attention --------------------------------------------


def _attend(q_blk, k, v, q_pos, k_pos, cfg: ModelConfig, window: int):
    """q_blk: [B,Cq,KVH,G,hd]; k/v: [B,Sk,KVH,hd]; positions int [Cq]/[Sk]."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q_blk.float() * _scale(cfg), k.float())
    s = softcap(s, cfg.attn_softcap)
    mask = k_pos[None, :] <= q_pos[:, None]  # causal
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    mask &= k_pos[None, :] >= 0  # rolling-cache slots not yet written
    s = torch.where(mask[None, None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.to(q_blk.dtype)


def causal_attention(q, k, v, cfg: ModelConfig, window: int = 0):
    """Full causal (optionally windowed) attention, chunked over queries.

    q: [B,S,H,hd]; k/v: [B,S,KVH,hd].  Returns [B,S,H,hd].
    """
    b, s, h, hd = q.shape
    kvh = cfg.n_kv_heads
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    # largest divisor of s not exceeding attn_chunk: no padding, so no
    # fully-masked softmax rows
    chunk = next(d for d in range(min(cfg.attn_chunk, s), 0, -1) if s % d == 0)
    k_pos = torch.arange(s, device=q.device)
    outs = []
    for start in range(0, s, chunk):
        q_blk = qg[:, start : start + chunk]
        q_pos = start + torch.arange(chunk, device=q.device)
        if window:
            # only the last (window + chunk) keys can be visible to this block
            klen = min(window + chunk, s)
            k_start = max(start + chunk - klen, 0)
            kp = k_start + torch.arange(klen, device=q.device)
            o = _attend(
                q_blk, k[:, k_start : k_start + klen], v[:, k_start : k_start + klen],
                q_pos, kp, cfg, window,
            )
        else:
            o = _attend(q_blk, k, v, q_pos, k_pos, cfg, window)
        outs.append(o)
    return torch.cat(outs, dim=1).reshape(b, s, h, hd)


# -- layer-level entry points ---------------------------------------------------


def cache_len(cfg: ModelConfig, window: int, max_len: int) -> int:
    return min(window, max_len) if window else max_len


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, window: int = 0, device=None):
    device = _default_device(device)
    t = cache_len(cfg, window, max_len)
    shape = (batch, t, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype(), device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype(), device=device),
    }


def _out_proj(out, params: Attention, partial: bool):
    """The heads' outputs through ``wo``: on a tensor-parallel position
    (``partial``) its rows, a partial product in fp32."""
    return partial_product(out, params.wo) if partial else out @ params.wo


def _attn_seq(x, params: Attention, cfg: ModelConfig, window: int, partial: bool = False):
    """Full-sequence attention: (out [B,S,D] @wo applied, RoPE'd k, v)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(x, params, cfg, positions)
    out = causal_attention(q, k, v, cfg, window)
    return _out_proj(out.reshape(b, s, -1), params, partial), k, v


def _over_positions(fn, x, params: Split):
    """``fn(x_t, part_t, cfg_t)`` on each position of a split layer (``x``
    whole on the lead, or a stream split by sequence); returns the sum of
    the partial outputs in ``x``'s layout and the list of the rest."""
    outs = [fn(xi, p, c) for xi, p, c in zip(tp_inputs(x, params.group), params.parts,
                                             params.cfgs)]
    return tp_output([o[0] for o in outs], x, params.group), [o[1] for o in outs]


def attn_train(x, params: Attention, cfg: ModelConfig, window: int = 0):
    """[B,S,D] -> [B,S,D]: the training forward (no cache), differentiable."""
    if isinstance(params, Split):
        return _over_positions(lambda xi, p, c: (_attn_seq(xi, p, c, window, True)[0], None),
                               x, params)[0]
    return _attn_seq(x, params, cfg, window)[0]


def attn_prefill(x, params: Attention, cfg: ModelConfig, window: int = 0):
    """Returns (out [B,S,D] @wo applied, cache dict) — cache holds RoPE'd keys;
    split, the layer's whole cache on the lead (:func:`gather_heads`)."""
    if isinstance(params, Split):
        out, caches = _over_positions(lambda xi, p, c: _prefill(xi, p, c, window, True), x,
                                      params)
        return out, {k: gather_heads([c[k] for c in caches], params) for k in ("k", "v")}
    return _prefill(x, params, cfg, window, False)


def _prefill(x, params: Attention, cfg: ModelConfig, window: int, partial: bool):
    b, s, _ = x.shape
    out, k, v = _attn_seq(x, params, cfg, window, partial)
    t = cache_len(cfg, window, s)
    if window and s > t:
        # rolling layout: absolute position p lands in slot p % W
        keep = torch.arange(s - t, s, device=x.device)
        slots = keep % t
        ck = torch.zeros((b, t) + k.shape[2:], dtype=k.dtype, device=x.device)
        cv = torch.zeros_like(ck)
        ck[:, slots] = k[:, keep]
        cv[:, slots] = v[:, keep]
    else:
        ck, cv = k, v
    return out, {"k": ck, "v": cv}


@dataclasses.dataclass(eq=False)
class SeqKV:
    """A layer's k and v cache over a group's positions by sequence:
    ``parts[t]`` holds ``{"k", "v"}`` ``[B, T / n, KVH, hd]``, the slots
    ``[t T / n, (t + 1) T / n)`` of every KV head, on ``group.devices[t]``."""

    parts: list
    group: col.Group


def attn_decode(x, params: Attention, cfg: ModelConfig, cache, pos, window: int = 0):
    """One decode step.  x: [B,1,D]; pos: the tokens already cached, an int
    or a 0-dim int64 tensor on the lead's device.

    Returns (out [B,1,D], cache), the cache updated in place.  ``cache`` is
    a dict (with ``params`` a ``Split``, on the group's lead), or a
    :class:`SeqKV` (the module docstring).
    """
    if isinstance(cache, SeqKV):
        return _seq_decode(x, params, cfg, cache.parts, cache.group, pos, window), cache
    if isinstance(params, Split):
        return _seq_decode(x, params, cfg, [cache], params.group, pos, window), cache
    return _decode(x, params, cfg, cache, pos, window)


def _sub_group(group: col.Group, ts: list[int]) -> col.Group:
    return col.Group(tuple(group.positions[t] for t in ts), tuple(group.devices[t] for t in ts))


def gather_heads(pieces: list, params: Split):
    """The positions' ``pieces`` of a split layer's KV heads (dim 2)
    concatenated on the lead, each KV head from the first position that
    reads it (under MQA every position reads the one head)."""
    spans = [s["kv"] for s in params.spans]
    kv = [t for t, span in enumerate(spans) if span not in spans[:t]]
    return col.all_gather([pieces[t] for t in kv], _sub_group(params.group, kv), dim=2)


def _split_qkv(x, params: Split, positions):
    """q, k and v of every head on the lead: each position projects its
    heads, and the heads are gathered (:func:`gather_heads`)."""
    qkv = [_project_qkv(xi, p, c, positions.to(xi.device))
           for xi, p, c in zip(col.broadcast(x, params.group), params.parts, params.cfgs)]
    return (col.all_gather([q for q, _, _ in qkv], params.group, dim=2),
            gather_heads([k for _, k, _ in qkv], params),
            gather_heads([v for _, _, v in qkv], params))


def _on(pos, device):
    """``pos`` (an int, or a 0-dim tensor) for use on ``device``."""
    return pos.to(device) if isinstance(pos, torch.Tensor) else pos


def _positions(pos, b: int, device) -> torch.Tensor:
    """RoPE's positions [B, 1] of a decode step at ``pos``."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).reshape(1, 1).expand(b, 1)
    return torch.full((b, 1), int(pos), dtype=torch.int64, device=device)


def _write_kv(cache: dict, slot, k, v) -> None:
    """The new token's k and v into ``slot`` of one position's cache, on its
    device.  A tensor ``slot`` (0-dim int64) is written only where it lies
    in the cache's slots; elsewhere the slot it names, clamped, is written
    back to itself, so that one captured step serves every position."""
    dev, n = cache["k"].device, cache["k"].shape[1]
    if not isinstance(slot, torch.Tensor):
        for name, new in (("k", k), ("v", v)):
            cache[name][:, slot : slot + 1] = new.to(dev)
        return
    slot = slot.to(dev)
    held = (slot >= 0) & (slot < n)
    idx = slot.clamp(0, n - 1).reshape(1)
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        c.index_copy_(1, idx, torch.where(held, new.to(dev), c.index_select(1, idx)))


def _partial(qg, k, v, pos, kpos, cfg: ModelConfig, window: int):
    """One position's flash-decode partial over its slots: qg [B,1,KVH,G,hd];
    k/v [B,T_t,KVH,hd]; kpos [T_t] the absolute position each slot holds;
    ``pos`` on qg's device.
    Returns fp32 (acc [B,KVH,G,1,hd], m and l [B,KVH,G,1,1]); a position
    with no visible key gives acc 0, m -inf and l 0."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float() * _scale(cfg), k.float())
    s = softcap(s, cfg.attn_softcap)
    mask = (kpos <= pos) & (kpos >= 0)
    if window:
        mask &= pos - kpos < window
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m))  # no -inf - -inf
    return torch.einsum("bkgqs,bskd->bkgqd", p, v.float()), m, p.sum(dim=-1, keepdim=True)


def _seq_decode(x, params, cfg: ModelConfig, parts: list, group: col.Group, pos,
                window: int):
    """A decode step against a cache whose slots lie over the first
    ``len(parts)`` positions of ``group`` (all of them, or the lead alone):
    q, k and v projected whole on the lead or by heads (``params`` a
    ``Split``, gathered onto the lead), the new k and v written into the
    position that owns the slot, every position's partial over its slots
    combined on the lead, and the output through ``wo`` (row-parallel
    where split).  Returns out [B,1,D]."""
    b, hd = x.shape[0], cfg.head_dim
    tn = parts[0]["k"].shape[1]
    total = tn * len(parts)
    holders = _sub_group(group, list(range(len(parts))))
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    positions = _positions(pos, b, x.device)
    if isinstance(params, Split):
        q, k, v = _split_qkv(x, params, positions)
    else:
        q, k, v = _project_qkv(x, params, cfg, positions)
    slot = pos % total if window else pos
    for t, part in enumerate(parts):  # each position writes where it holds the slot
        _write_kv(part, slot - t * tn, k, v)
    kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    stats = []
    for t, (qg, part) in enumerate(zip(col.broadcast(q.reshape(b, 1, kvh, g, hd), holders),
                                       parts)):
        j = t * tn + torch.arange(tn, device=qg.device)
        p = _on(pos, qg.device)
        kpos = p - torch.remainder(p - j, total) if window else j
        stats.append(_partial(qg, part["k"], part["v"], p, kpos, cfg, window))
    m = col.all_reduce_max([s[1] for s in stats], holders)
    terms = []
    for (acc, mt, lt), mm in zip(stats, col.broadcast(m, holders)):
        w = torch.exp(mt - mm)  # 0 where a position saw no key
        terms.append(torch.cat([acc * w, lt * w], dim=-1))
    sums = col.all_reduce(terms, holders)  # [B,KVH,G,1,hd + 1] fp32 on the lead
    out = (sums[..., :hd] / sums[..., hd:]).permute(0, 3, 1, 2, 4).reshape(b, 1, -1)
    out = out.to(x.dtype)
    if not isinstance(params, Split):
        return out @ params.wo
    return col.all_reduce([partial_product(o[..., slice(*span["q"])], p.wo) for o, p, span in
                           zip(col.broadcast(out, params.group), params.parts, params.spans)],
                          params.group, x.dtype)


def _decode(x, params: Attention, cfg: ModelConfig, cache: dict, pos, window: int):
    b = x.shape[0]
    t = cache["k"].shape[1]
    positions = _positions(pos, b, x.device)
    q, k, v = _project_qkv(x, params, cfg, positions)
    _write_kv(cache, pos % t if window else pos, k, v)
    j = torch.arange(t, device=x.device)
    p = _on(pos, x.device)
    kpos = p - torch.remainder(p - j, t) if window else j
    kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, 1, kvh, g, cfg.head_dim)
    out = _attend(qg, cache["k"], cache["v"], positions[0], kpos, cfg, window)
    return out.reshape(b, 1, -1) @ params.wo, cache
