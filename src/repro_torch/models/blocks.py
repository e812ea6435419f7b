"""Per-layer block assembly: one (mixer + FFN) residual block per kind.

Blocks receive the residual-stream input and return the *new* stream (and,
in prefill/decode modes, the layer cache).  The port carries the kinds
``attn``, ``win`` and ``rec``; the others raise until their slices land.
"""

from __future__ import annotations

from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.state import _default_device
from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models.common import MLP, _param, mlp_forward, mlp_init, rms_norm

# Block kinds the port does not carry yet, and the ROADMAP item that ports each.
_NOT_PORTED = {
    "moe": "ROADMAP.md queue 1 item 3: models/moe.py (serving, MoE stacks)",
    "mlstm": "ROADMAP.md queue 1 item 6: models/xlstm.py",
    "slstm": "ROADMAP.md queue 1 item 6: models/xlstm.py",
}


def _check_kind(kind: str) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet: {_NOT_PORTED[kind]}")
    if kind not in ("attn", "win", "rec"):
        raise ValueError(kind)


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind == "win" else 0


class Block(nn.Module):
    """``norm1 -> mixer -> residual -> norm2 -> MLP -> residual``; the mixer
    is ``attn`` (kinds ``attn``, ``win``) or the RG-LRU ``rec`` (kind ``rec``)."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None, mixer=None, mlp=None):
        super().__init__()
        _check_kind(kind)
        device = _default_device(device)
        self.kind = kind
        d, pd = cfg.d_model, cfg.pdtype()
        self.norm1 = _param((d,), pd, device)
        if kind == "rec":
            self.rec = mixer if mixer is not None else rec.RGLRU(cfg, device)
        else:
            self.attn = mixer if mixer is not None else attn.Attention(cfg, device)
        self.norm2 = _param((d,), pd, device)
        self.mlp = mlp if mlp is not None else MLP(d, cfg.d_ff, cfg.mlp_kind, pd, device)


def block_init(gen, cfg: ModelConfig, kind: str, device=None) -> Block:
    _check_kind(kind)
    device = _default_device(device)
    init = rec.rglru_init if kind == "rec" else attn.attn_init
    blk = Block(
        cfg, kind, device,
        mixer=init(gen, cfg, device),
        mlp=mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, cfg.pdtype(), device),
    )
    blk.norm1.data.zero_()
    blk.norm2.data.zero_()
    return blk


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int, device=None):
    _check_kind(kind)
    device = _default_device(device)
    if kind == "rec":
        return rec.init_rec_cache(cfg, batch, device)
    return attn.init_kv_cache(cfg, batch, max_len, _window(cfg, kind), device)


def block_prefill(x, params: Block, cfg: ModelConfig, kind: str):
    """[B,S,D] -> (x', cache) building the decode cache as it goes."""
    _check_kind(kind)
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    if kind == "rec":
        y, cache = rec.rec_block_prefill(h, params.rec, cfg)
    else:
        y, cache = attn.attn_prefill(h, params.attn, cfg, _window(cfg, kind))
    x = x + y
    h2 = rms_norm(x, params.norm2, cfg.norm_eps)
    x = x + mlp_forward(h2, params.mlp, cfg.mlp_kind)
    return x, cache


def block_decode(x, params: Block, cfg: ModelConfig, kind: str, cache, pos: int):
    """[B,1,D] -> (x', cache').  An attention cache is updated in place and
    returned; a ``rec`` layer returns a new ``{"conv", "h"}``."""
    _check_kind(kind)
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    if kind == "rec":
        y, cache = rec.rec_block_decode(h, params.rec, cfg, cache)
    else:
        y, cache = attn.attn_decode(h, params.attn, cfg, cache, pos, _window(cfg, kind))
    x = x + y
    h2 = rms_norm(x, params.norm2, cfg.norm_eps)
    x = x + mlp_forward(h2, params.mlp, cfg.mlp_kind)
    return x, cache
