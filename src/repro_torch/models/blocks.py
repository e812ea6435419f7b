"""Per-layer block assembly: one residual block per kind.

Blocks receive the residual-stream input and return the *new* stream (plus,
in training, the MoE aux-loss contribution and, in prefill/decode modes, the
layer cache).  Every kind of the JAX package's
``models/blocks.py`` is here: ``attn``, ``win`` and ``moe`` (attention, then
a dense or a mixture-of-experts FFN), ``rec`` (RG-LRU, then a dense FFN), and
the self-contained xLSTM kinds ``mlstm`` and ``slstm``.  The MoE aux loss
belongs to training (:func:`block_train`); prefill and decode drop it, as
the reference does.

In training over a device mesh the residual stream may be split by
sequence over a data-parallel group's tensor-parallel positions (the
reference's ``("dp", "seq", None)`` after every residual add,
``src/repro/models/blocks.py:51-52``): a list with each position's rows.
The norms and the residual adds then run on each position's rows, a split
sublayer takes the rows all-gathered and reduce-scatters its output
(``common.tp_inputs``), and a sublayer that runs whole gathers the rows
onto the group's lead and splits its output back.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import BLOCK_KINDS, ModelConfig
from repro_torch.core.state import _default_device
from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models import xlstm
from repro_torch.distributed import collectives as col
from repro_torch.models.common import (MLP, Split, _param, mlp_forward, mlp_init, rms_norm,
                                       stream_add, stream_norm)
from repro_torch.models.moe import MoE, moe_ffn, moe_init

_CELLS = {"mlstm": (xlstm.MLSTM, xlstm.mlstm_init), "slstm": (xlstm.SLSTM, xlstm.slstm_init)}


def _check_kind(kind: str) -> None:
    if kind not in BLOCK_KINDS:
        raise ValueError(kind)


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind == "win" else 0


class Block(nn.Module):
    """``norm1 -> mixer -> residual -> norm2 -> FFN -> residual``.  The mixer
    is ``attn`` (kinds ``attn``, ``win``, ``moe``) or the RG-LRU ``rec``
    (kind ``rec``); the FFN is ``mlp``, or ``moe`` for kind ``moe``.  The
    xLSTM kinds hold ``norm1`` and one ``cell`` that carries its own
    expansion."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None, mixer=None, ffn=None):
        super().__init__()
        _check_kind(kind)
        device = _default_device(device)
        self.kind = kind
        d, pd = cfg.d_model, cfg.pdtype()
        self.norm1 = _param((d,), pd, device)
        if kind in _CELLS:
            self.cell = mixer if mixer is not None else _CELLS[kind][0](cfg, device)
            return
        if kind == "rec":
            self.rec = mixer if mixer is not None else rec.RGLRU(cfg, device)
        else:
            self.attn = mixer if mixer is not None else attn.Attention(cfg, device)
        self.norm2 = _param((d,), pd, device)
        if kind == "moe":
            self.moe = ffn if ffn is not None else MoE(cfg, device)
        else:
            self.mlp = ffn if ffn is not None else MLP(d, cfg.d_ff, cfg.mlp_kind, pd, device)


def block_init(gen, cfg: ModelConfig, kind: str, device=None) -> Block:
    _check_kind(kind)
    device = _default_device(device)
    if kind in _CELLS:
        blk = Block(cfg, kind, device, mixer=_CELLS[kind][1](gen, cfg, device))
    else:
        mixer = (rec.rglru_init if kind == "rec" else attn.attn_init)(gen, cfg, device)
        if kind == "moe":
            ffn = moe_init(gen, cfg, device)
        else:
            ffn = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, cfg.pdtype(), device)
        blk = Block(cfg, kind, device, mixer=mixer, ffn=ffn)
        blk.norm2.data.zero_()
    blk.norm1.data.zero_()
    return blk


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int, device=None):
    _check_kind(kind)
    device = _default_device(device)
    if kind == "rec":
        return rec.init_rec_cache(cfg, batch, device)
    if kind == "mlstm":
        return xlstm.init_mlstm_cache(cfg, batch, device)
    if kind == "slstm":
        return xlstm.init_slstm_cache(cfg, batch, device)
    return attn.init_kv_cache(cfg, batch, max_len, _window(cfg, kind), device)


def ffn_forward(x, params: Block, cfg: ModelConfig):
    """The block's FFN on the normed stream: the dense MLP, or the MoE FFN
    with its aux loss dropped."""
    if params.kind == "moe":
        return moe_ffn(x, params.moe, cfg)[0]
    return mlp_forward(x, params.mlp, cfg.mlp_kind)


def _cell(x, params: Block, cfg: ModelConfig, kind: str, cache, mode: str):
    block = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    y, cache = block(h, params.cell, cfg, cache, mode=mode)
    return x + y, cache


def _sublayer(fn, h, sub, params):
    """``fn(h)``; for a stream split by sequence and a sublayer that runs
    whole (not a ``Split``), ``fn`` on the rows gathered onto the lead and
    its output (the first of a tuple) split back over the positions."""
    if not isinstance(h, list) or isinstance(sub, Split):
        return fn(h)
    out = fn(col.all_gather(h, params.group, dim=1))
    if isinstance(out, tuple):
        return col.split(out[0], params.group, dim=1), *out[1:]
    return col.split(out, params.group, dim=1)


def block_train(x, params: Block, cfg: ModelConfig, kind: str):
    """[B,S,D] -> ([B,S,D], aux loss fp32 scalar), differentiable; no cache.
    ``x`` may be a stream split by sequence (the module docstring; then
    ``params.group`` holds the positions), and comes back so."""
    _check_kind(kind)
    lead, group = (x[0], params.group) if isinstance(x, list) else (x, None)
    aux = torch.zeros((), dtype=torch.float32, device=lead.device)
    h = stream_norm(x, params.norm1, group, cfg.norm_eps)
    if kind in _CELLS:
        block = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
        return stream_add(x, _sublayer(lambda h: block(h, params.cell, cfg, mode="train"), h,
                                       params.cell, params)), aux
    if kind == "rec":
        x = stream_add(x, _sublayer(lambda h: rec.rec_block_train(h, params.rec, cfg), h,
                                    params.rec, params))
    else:
        window = _window(cfg, kind)
        x = stream_add(x, _sublayer(lambda h: attn.attn_train(h, params.attn, cfg, window), h,
                                    params.attn, params))
    h2 = stream_norm(x, params.norm2, group, cfg.norm_eps)
    if kind == "moe":
        y, aux = _sublayer(lambda h: moe_ffn(h, params.moe, cfg), h2, params.moe, params)
    else:
        y = _sublayer(lambda h: mlp_forward(h, params.mlp, cfg.mlp_kind), h2, params.mlp, params)
    return stream_add(x, y), aux


def block_prefill(x, params: Block, cfg: ModelConfig, kind: str):
    """[B,S,D] -> (x', cache) building the decode cache as it goes."""
    _check_kind(kind)
    if kind in _CELLS:
        return _cell(x, params, cfg, kind, None, "prefill")
    x, h2, cache = block_prefill_mixer(x, params, cfg, kind)
    return x + ffn_forward(h2, params, cfg), cache


def block_prefill_mixer(x, params: Block, cfg: ModelConfig, kind: str):
    """:func:`block_prefill` of a block with an FFN up to its second norm,
    as :func:`block_decode_mixer` is of a decode step."""
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    if kind == "rec":
        y, cache = rec.rec_block_prefill(h, params.rec, cfg)
    else:
        y, cache = attn.attn_prefill(h, params.attn, cfg, _window(cfg, kind))
    x = x + y
    return x, rms_norm(x, params.norm2, cfg.norm_eps), cache


def block_decode(x, params: Block, cfg: ModelConfig, kind: str, cache, pos):
    """[B,1,D] -> (x', cache').  An attention cache is updated in place and
    returned; a ``rec``, ``mlstm`` or ``slstm`` layer returns a new state.
    ``pos`` is an int or a 0-dim int64 tensor (``attention.attn_decode``)."""
    _check_kind(kind)
    if kind in _CELLS:
        return _cell(x, params, cfg, kind, cache, "decode")
    x, h2, cache = block_decode_mixer(x, params, cfg, kind, cache, pos)
    return x + ffn_forward(h2, params, cfg), cache


def block_decode_mixer(x, params: Block, cfg: ModelConfig, kind: str, cache, pos):
    """A decode step of a block with an FFN (not the xLSTM kinds) up to its
    second norm: (the stream after the mixer's residual add, its second
    norm, the cache as :func:`block_decode` returns it).  The FFN's output
    added to the stream completes the block; an executor that runs an FFN
    across data-parallel groups (expert-stationary MoE) takes it here."""
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    if kind == "rec":
        y, cache = rec.rec_block_decode(h, params.rec, cfg, cache)
    else:
        y, cache = attn.attn_decode(h, params.attn, cfg, cache, pos, _window(cfg, kind))
    x = x + y
    return x, rms_norm(x, params.norm2, cfg.norm_eps), cache
