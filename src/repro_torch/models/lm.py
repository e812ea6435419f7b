"""Causal LM over a stack of blocks, for inference.

:class:`CausalLM` holds the embedding, the final norm, an optional untied
head and its :class:`~repro_torch.models.blocks.Block` s in layer order
(the JAX package's ``[repeats, ...]`` period stacks, unstacked to layer
``rep * period + pos``, then the tail).  Entry points:

  ``prefill``      tokens -> (last-position logits, decode cache)
  ``decode_step``  one token + cache + pos -> (logits, cache updated in place)

The cache is a list with one entry per layer: ``{"k", "v"}`` for attention
and ``moe`` layers (written in place by decode); ``{"conv", "h"}`` for
``rec``, ``{"conv", "c", "n", "m"}`` for ``mlstm`` and ``{"conv", "c", "n",
"m", "h"}`` for ``slstm`` layers (each replaced in the list by the new state
its decode step returns).

The JAX module's function names (``init_params``, ``prefill``,
``decode_step``, ``init_cache``, ``embed_tokens``, ``lm_logits``) remain as
thin wrappers.  Weights keep the JAX ``[in, out]`` layout, so
:func:`params_from_numpy` carries a JAX parameter tree across exactly.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.state import _default_device, _tensor_from_host
from repro_torch.models import blocks as B
from repro_torch.models.common import _param, dense_init, embed_init, rms_norm, softcap


def _has_head(cfg: ModelConfig) -> bool:
    # stub-frontend models cannot tie (no input table); they always have a head
    return not cfg.tie_embeddings or not cfg.embed_inputs


class CausalLM(nn.Module):
    """The model on ``device``: the current CUDA device by default (raises
    without one)."""

    def __init__(self, cfg: ModelConfig, device=None, blocks=None):
        super().__init__()
        device = _default_device(device)
        self.cfg = cfg
        pd = cfg.pdtype()
        if cfg.embed_inputs:
            self.embed = _param((cfg.vocab_size, cfg.d_model), pd, device)
        if _has_head(cfg):
            self.lm_head = _param((cfg.d_model, cfg.vocab_size), pd, device)
        self.final_norm = _param((cfg.d_model,), pd, device)
        if blocks is None:
            blocks = [B.Block(cfg, kind, device) for kind in cfg.layer_kinds]
        self.blocks = nn.ModuleList(blocks)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # -- embedding / head ---------------------------------------------------------

    def embed_tokens(self, inputs: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.embed_inputs:
            x = self.embed[inputs].to(cfg.dtype())
        else:
            x = inputs.to(cfg.dtype())  # frontend stub: already embeddings
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype())
        return x

    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits of the head product taken in the compute dtype."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.lm_head if _has_head(self.cfg) else self.embed.T
        return softcap((x @ head).float(), self.cfg.final_softcap)

    # -- cache / prefill / decode ---------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> list[dict]:
        """One empty decode cache per layer, in layer order."""
        return init_cache(self.cfg, batch, max_len, self.device)

    @torch.no_grad()
    def prefill(self, inputs: torch.Tensor, max_len: int):
        """Process a prompt; returns (last-token logits [B,V], cache at pos=S)."""
        x = self.embed_tokens(inputs)
        cache = []
        for blk in self.blocks:
            x, c = B.block_prefill(x, blk, self.cfg, blk.kind)
            cache.append(c)
        logits = self.lm_logits(x[:, -1:])[:, 0]
        return logits, _grow_kv(cache, self.cfg, max_len)

    @torch.no_grad()
    def decode_step(self, cache: list[dict], inputs: torch.Tensor, pos: int):
        """One token for every sequence.  inputs: [B,1] ids; pos: int count of
        already-cached tokens.  Returns (logits [B,V], cache updated in place:
        attention layers write into their k/v tensors, and each recurrent
        layer's entry of the list is replaced by the state its step returns)."""
        x = self.embed_tokens(inputs)
        for i, blk in enumerate(self.blocks):
            x, cache[i] = B.block_decode(x, blk, self.cfg, blk.kind, cache[i], pos)
        return self.lm_logits(x)[:, 0], cache


def _grow_kv(cache: list[dict], cfg: ModelConfig, max_len: int) -> list[dict]:
    """Pad global-attention prefill caches (length S) out to max_len slots."""
    out = []
    for kind, c in zip(cfg.layer_kinds, cache):
        if kind in ("attn", "moe"):
            pad = max_len - c["k"].shape[1]
            if pad > 0:
                c = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)) for k, v in c.items()}
        out.append(c)
    return out


# -- parameters -----------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> CausalLM:
    """Random weights drawn from ``gen`` (on ``device``, the current CUDA
    device by default; raises without one), the JAX init's distributions:
    truncated normals, fan-in scaled, zero norms and biases."""
    device = _default_device(device)
    model = CausalLM(cfg, device, blocks=[])
    with torch.no_grad():
        if cfg.embed_inputs:
            model.embed.copy_(embed_init(gen, model.embed.shape, cfg.pdtype(), device))
        if _has_head(cfg):
            model.lm_head.copy_(dense_init(gen, model.lm_head.shape, cfg.pdtype(), device))
        model.final_norm.zero_()
    model.blocks = nn.ModuleList(B.block_init(gen, cfg, kind, device) for kind in cfg.layer_kinds)
    return model


def _load_tree(module: nn.Module, tree: dict, device, index=None) -> None:
    """Copy a nested dict of host arrays into the like-named parameters of
    ``module``; ``index`` picks one entry of each leaf's leading axis."""
    for name, val in tree.items():
        if isinstance(val, dict):
            _load_tree(getattr(module, name), val, device, index)
            continue
        arr = np.asarray(val) if index is None else np.asarray(val)[index]
        param = getattr(module, name)
        t = _tensor_from_host(arr, device)
        if tuple(t.shape) != tuple(param.shape) or t.dtype != param.dtype:
            raise ValueError(
                f"{name}: tree leaf {tuple(t.shape)} {t.dtype} does not fit "
                f"parameter {tuple(param.shape)} {param.dtype}"
            )
        setattr(module, name, nn.Parameter(t, requires_grad=False))


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> CausalLM:
    """A :class:`CausalLM` holding the JAX package's ``init_params`` tree.

    ``tree`` is that tree with every leaf a host array (``np.asarray`` of
    each).  The ``[repeats, ...]`` period leaves unstack into layer order
    ``rep * period + pos``; bfloat16 leaves (``ml_dtypes``) cross as raw bits.
    """
    device = torch.device(device)
    model = CausalLM(cfg, device="meta")
    for name in ("embed", "lm_head", "final_norm"):
        if name in tree:
            _load_tree(model, {name: tree[name]}, device)
    per = len(cfg.layer_pattern)
    for rep in range(cfg.repeats):
        for pos in range(per):
            _load_tree(model.blocks[rep * per + pos], tree["period"][pos], device, rep)
    for i, sub in enumerate(tree.get("tail", [])):
        _load_tree(model.blocks[cfg.repeats * per + i], sub, device)
    leftover = [n for n, p in model.named_parameters() if p.device.type == "meta"]
    if leftover:
        raise ValueError(f"tree lacks parameters {leftover}")
    return model


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count, from the model built on the meta device.
    ``active_only`` counts the expert weights a token touches: ``top_k`` of
    ``n_experts`` of each expert leaf, as the reference counts them."""
    total = 0
    for name, p in CausalLM(cfg, device="meta").named_parameters():
        n = p.numel()
        expert = name.rsplit(".", 1)[-1] in ("e_gate", "e_in", "e_out")
        if active_only and cfg.moe is not None and expert:
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        total += n
    return total


# -- the JAX package's function names ----------------------------------------------


def embed_tokens(params: CausalLM, inputs, cfg: ModelConfig = None):
    return params.embed_tokens(inputs)


def lm_logits(params: CausalLM, x, cfg: ModelConfig = None):
    return params.lm_logits(x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> list[dict]:
    device = _default_device(device)
    return [
        B.block_cache_init(cfg, kind, batch, max_len, device) for kind in cfg.layer_kinds
    ]


def prefill(params: CausalLM, inputs, cfg: ModelConfig, max_len: int):
    return params.prefill(inputs, max_len)


def decode_step(params: CausalLM, cache, inputs, pos, cfg: ModelConfig):
    return params.decode_step(cache, inputs, int(pos))
