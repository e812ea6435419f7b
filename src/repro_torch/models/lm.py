"""Causal LM over a stack of blocks.

:class:`CausalLM` holds the embedding, the final norm, an optional untied
head and its :class:`~repro_torch.models.blocks.Block` s in layer order
(the JAX package's ``[repeats, ...]`` period stacks, unstacked to layer
``rep * period + pos``, then the tail).  Entry points:

  ``train_loss``   tokens/embeds + labels -> (scalar loss, metrics)
  ``prefill``      tokens -> (last-position logits, decode cache)
  ``decode_step``  one token + cache + pos -> (logits, cache updated in place)

Parameters are built with ``requires_grad=False``, for inference; training
(``repro_torch.train``) switches them on.  ``train_loss`` recomputes each
block in the backward pass (``torch.utils.checkpoint``, non-reentrant), the
counterpart of the reference's ``jax.checkpoint(..., nothing_saveable)``
around each period: only the blocks' inputs stay alive between the passes.

The cache is a list with one entry per layer: ``{"k", "v"}`` for attention
and ``moe`` layers (written in place by decode); ``{"conv", "h"}`` for
``rec``, ``{"conv", "c", "n", "m"}`` for ``mlstm`` and ``{"conv", "c", "n",
"m", "h"}`` for ``slstm`` layers (each replaced in the list by the new state
its decode step returns).

A model placed over a device mesh (``distributed/sharding.py`` ``place``,
a ``PlacedModel``) runs block by block on each data-parallel group's
positions, its lead and the lead's tensor-parallel peers:
:func:`group_train`, :func:`prefill` and :func:`decode_step` bind a
stage's leaves (the embedding, one block, the final norm and head) just
before it runs and free them after.  Training runs one group's microbatch
rows through the whole model at a time; a prefill and a decode step run
layer by layer across the groups, so that an expert-stationary MoE layer
(``tensor_parallel.StationaryLayout``) can trade every group's tokens at
once, and bind a position's own shard without a copy wherever its region
is exactly that shard.  They are the reference's two jitted inference
programs (``src/repro/launch/dryrun.py:159-162`` and ``:194-198``), each a
``graphs.Program`` (:data:`PLACED_PREFILL`, :data:`PLACED_DECODE`): the
decode step's position is an operand, so one captured step serves a whole
decode loop, and it updates the cache in place.  A product that runs tensor-parallel
(``models/tensor_parallel.py`` ``plan``) binds on each position only that
position's block of its weights, gathered over the fsdp axis alone, and
the positions' partial products meet in all-reduces; the rest is gathered
whole onto the lead and runs there.  Under sequence parallelism
(``Plan.seq``) the training residual stream is a ``common.Stream`` of
each position's rows, and each position saves only its rows of each
block's input.  The training backward recomputes each block from its
saved input, binding it again, and reduces each position's gradient of its block into the shards
that hold that block as soon as the block is done.  A placed decode's
cache lies over the positions by the reference's rule
(``tensor_parallel.place_caches``): :func:`init_group_caches` makes it
empty, :func:`place_group_caches` lays out a whole one, and a placed
:func:`prefill` returns it so laid out.

The JAX module's function names (``init_params``, ``train_loss``,
``prefill``, ``decode_step``, ``init_cache``, ``embed_tokens``,
``lm_logits``) remain as thin wrappers.  Weights keep the JAX ``[in, out]`` layout, so
:func:`params_from_numpy` carries a JAX parameter tree across exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import graphs
from repro_torch.core.state import _default_device, _tensor_from_host
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as sh
from repro_torch.models import attention as attn
from repro_torch.models import blocks as B
from repro_torch.models import tensor_parallel as tp
from repro_torch.models import xlstm
from repro_torch.models.common import (Stream, _param, dense_init, embed_init, rms_norm,
                                       softcap, stream_norm, stream_tensors)
from repro_torch.models.moe import dp_config, moe_stationary


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
        # a frontend stub's inputs are already embeddings
        return _embedded(self.embed[inputs] if self.cfg.embed_inputs else inputs, self.cfg)

    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits of the head product taken in the compute dtype."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return _head_logits(x, self)

    @property
    def head(self) -> torch.Tensor:
        """The head's ``[D, V]`` weight: ``lm_head``, or the tied embedding."""
        return self.lm_head if _has_head(self.cfg) else self.embed.T

    # -- training -------------------------------------------------------------------

    def train_loss(self, batch: dict):
        """batch: {"inputs": [B,S] int (or [B,S,D] embeds), "labels": [B,S] int}.

        Returns (loss, metrics): the mean NLL over fp32 logits of positions
        whose label is >= 0 (label -100 is masked), plus for MoE stacks
        ``aux_loss_weight * aux / n_layers``.  Differentiable; with grad
        enabled each block is recomputed in the backward pass.
        """
        cfg = self.cfg
        x = self.embed_tokens(batch["inputs"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.blocks:
            if torch.is_grad_enabled():
                x, a = checkpoint(B.block_train, x, blk, cfg, blk.kind,
                                  use_reentrant=False, preserve_rng_state=False)
            else:
                x, a = B.block_train(x, blk, cfg, blk.kind)
            aux = aux + a
        nll = masked_nll_sum(self.lm_logits(x), batch["labels"])  # fp32 logits
        denom = label_count(batch["labels"])
        loss = nll / denom
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_weight * aux / max(cfg.n_layers, 1)
        return loss, {"nll": loss, "tokens": denom}

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


def _embedded(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Embedding rows (or a stub's embeddings) in the compute dtype, scaled."""
    x = x.to(cfg.dtype())
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype())
    return x


def _head_logits(x: torch.Tensor, model) -> torch.Tensor:
    """fp32 logits of ``x`` (final-normed) against ``model``'s head (on a
    tensor-parallel position, its vocabulary slice), softcapped."""
    return softcap((x @ model.head).float(), model.cfg.final_softcap)


def masked_nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The summed NLL of fp32 ``logits`` [B,S,V] at the positions whose label
    is >= 0 (label -100 is masked)."""
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    return ((lse - ll) * (labels >= 0).float()).sum()


def vocab_parallel_nll_sum(parts: list, labels: torch.Tensor, spans: list,
                           group: col.Group) -> torch.Tensor:
    """:func:`masked_nll_sum` of logits split over a group's positions by
    vocabulary: ``parts[t]`` fp32 ``[B, S, V_t]``, the logits of vocabulary
    ``spans[t]`` on position ``t``.  The log-sum-exp's max and its sum of
    exponentials are all-reduced over the positions (the sum, and the
    label's logit from the one position whose slice holds it, in one
    all-reduce), so no position holds more than its slice; returns the sum
    on the lead."""
    shift = col.all_reduce_max([z.amax(dim=-1, keepdim=True) for z in parts], group)
    labels = labels.long()
    stats = []
    for z, (v0, v1), dev in zip(parts, spans, group.devices):
        local = labels.to(dev) - v0
        held = (local >= 0) & (local < v1 - v0)
        ll = torch.gather(z, -1, local.clamp(0, v1 - v0 - 1)[..., None])
        stats.append(torch.cat([torch.exp(z - shift.to(dev)).sum(dim=-1, keepdim=True),
                                torch.where(held[..., None], ll, 0.0)], dim=-1))
    total = col.all_reduce(stats, group)  # [B, S, 2]: sum of exponentials, label logit
    lse = (shift + torch.log(total[..., :1]))[..., 0]
    return ((lse - total[..., 1]) * (labels >= 0).float()).sum()


def label_count(labels: torch.Tensor) -> torch.Tensor:
    """The loss's denominator: the labels >= 0, at least 1, as an fp32 0-d tensor."""
    return torch.clamp((labels >= 0).float().sum(), min=1.0)


def _grow_kv(cache: list[dict], cfg: ModelConfig, max_len: int) -> list[dict]:
    """Pad global-attention prefill caches (length S) out to max_len slots."""
    return [_grown(kind, c, max_len) for kind, c in zip(cfg.layer_kinds, cache)]


def _grown(kind: str, c: dict, max_len: int) -> dict:
    """One layer's prefill cache, a global-attention one padded to max_len slots."""
    if kind in ("attn", "moe"):
        pad = max_len - c["k"].shape[1]
        if pad > 0:
            c = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)) for k, v in c.items()}
    return c


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


def _walk(tree: dict, prefix: str = "", index=None):
    """(dotted name, host array) of every leaf of a nested dict; ``index``
    picks one entry of each leaf's leading axis."""
    for name, val in tree.items():
        if isinstance(val, dict):
            yield from _walk(val, f"{prefix}{name}.", index)
        else:
            yield prefix + name, np.asarray(val) if index is None else np.asarray(val)[index]


def _set_param(module: nn.Module, name: str, arr, device) -> None:
    """Replace the parameter at dotted ``name`` by host array ``arr`` on ``device``."""
    owner, _, leaf = name.rpartition(".")
    sub = module.get_submodule(owner)
    param = getattr(sub, leaf)
    t = _tensor_from_host(arr, device)
    if tuple(t.shape) != tuple(param.shape) or t.dtype != param.dtype:
        raise ValueError(
            f"{name}: tree leaf {tuple(t.shape)} {t.dtype} does not fit "
            f"parameter {tuple(param.shape)} {param.dtype}"
        )
    setattr(sub, leaf, nn.Parameter(t, requires_grad=False))


def _load_tree(module: nn.Module, tree: dict, device, index=None) -> None:
    """Copy a nested dict of host arrays into the like-named parameters of
    ``module``; ``index`` picks one entry of each leaf's leading axis."""
    for name, arr in _walk(tree, index=index):
        _set_param(module, name, arr, device)


def named_leaves(tree: dict, cfg: ModelConfig) -> dict:
    """The JAX package's ``init_params``-shaped ``tree`` (or any tree of that
    shape, such as its optimizer's m and v) as ``{parameter name: host
    array}`` in this module's names: the ``[repeats, ...]`` period leaves
    unstack into layer ``rep * period + pos``, the tail follows."""
    out = dict(_walk({k: tree[k] for k in ("embed", "lm_head", "final_norm") if k in tree}))
    per = len(cfg.layer_pattern)
    for rep in range(cfg.repeats):
        for pos in range(per):
            out.update(_walk(tree["period"][pos], f"blocks.{rep * per + pos}.", rep))
    for i, sub in enumerate(tree.get("tail", [])):
        out.update(_walk(sub, f"blocks.{cfg.repeats * per + i}."))
    return out


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> CausalLM:
    """A :class:`CausalLM` holding the JAX package's ``init_params`` tree.

    ``tree`` is that tree with every leaf a host array (``np.asarray`` of
    each).  The ``[repeats, ...]`` period leaves unstack into layer order
    ``rep * period + pos``; bfloat16 leaves (``ml_dtypes``) cross as raw bits.
    """
    model = CausalLM(cfg, device="meta")
    for name, arr in named_leaves(tree, cfg).items():
        _set_param(model, name, arr, torch.device(device))
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


def train_loss(params: CausalLM, batch: dict, cfg: ModelConfig = None):
    return params.train_loss(batch)


def prefill(params, inputs, cfg: ModelConfig, max_len: int):
    """A prompt's last-position logits and decode cache.  ``params`` a
    :class:`CausalLM`, or a model placed over a device mesh, run under a ctx
    over that mesh (:func:`_placed_prefill`: one :data:`PLACED_PREFILL`
    variant a signature), whose cache comes back laid out as
    :func:`place_group_caches` lays out a whole one."""
    if isinstance(params, sh.PlacedModel):
        return _placed_prefill(params, inputs, cfg, max_len)
    return params.prefill(inputs, max_len)


def decode_step(params, cache, inputs, pos, cfg: ModelConfig):
    """One decode step.  ``params`` a :class:`CausalLM`, or a model placed
    over a device mesh with ``cache`` from :func:`init_group_caches`,
    :func:`place_group_caches` or a placed :func:`prefill`, run under a ctx
    over that mesh (:func:`_placed_decode`: one :data:`PLACED_DECODE`
    variant serves every position).  ``pos`` is an int or a 0-dim integer
    tensor."""
    if isinstance(params, sh.PlacedModel):
        return _placed_decode(params, cache, inputs, pos, cfg)
    return params.decode_step(cache, inputs, pos if isinstance(pos, torch.Tensor) else int(pos))


# -- a model placed over a device mesh ------------------------------------------------


def _skeletons(placed: sh.PlacedModel, n: int) -> list[CausalLM]:
    """The model's modules on ``meta``, one set per tensor-parallel position
    of a group, whose parameters a stage binds to gathered tensors while it
    runs."""
    if not hasattr(placed, "_skeletons"):
        placed._skeletons = []
    while len(placed._skeletons) < n:
        placed._skeletons.append(CausalLM(placed.cfg, device="meta"))
    return placed._skeletons[:n]


def _stages(placed: sh.PlacedModel) -> tuple[list[str], list[list[str]], list[str]]:
    """The leaf names of the embedding, of each block and of the head."""
    cfg, names = placed.cfg, list(placed.leaves)
    embed = ["embed"] if cfg.embed_inputs else []
    blocks = [[n for n in names if n.startswith(f"blocks.{i}.")] for i in range(cfg.n_layers)]
    return embed, blocks, ["final_norm", "lm_head" if _has_head(cfg) else "embed"]


@contextlib.contextmanager
def _bound(skels: list, placed: sh.PlacedModel, names: list[str], plan: tp.Plan,
           group: col.Group, grad: bool, own: bool = False):
    """Bind the leaves ``names`` as the skeletons' parameters: on each
    tensor-parallel position ``t`` the region ``plan.regions[name][t]``
    gathered onto its device (with ``requires_grad`` if ``grad``; with
    ``own``, a read-only step's, the position's shard itself where it is
    that region: ``sharding.bind_region``).  Yields ``[(name, region,
    parameter)]``, and puts the ``meta`` parameters back after, which frees
    the gathered ones once the caller drops them."""
    bind = sh.bind_region if own else sh.gather_region
    old, bound = [], []
    for name in names:
        owner, _, leaf = name.rpartition(".")
        for skel, pos, region in zip(skels, group.positions, plan.regions[name]):
            if region is None:
                continue
            sub = skel.get_submodule(owner)
            old.append((sub, leaf, getattr(sub, leaf)))
            p = nn.Parameter(tp.bind_leaf(placed.leaves[name], region, pos, bind),
                             requires_grad=grad)
            setattr(sub, leaf, p)
            bound.append((name, region, p))
    try:
        yield bound
    finally:
        for sub, leaf, p in reversed(old):
            setattr(sub, leaf, p)


def _reduce_grads(bound: list, grads, into: dict) -> None:
    """Add each bound parameter's gradient into ``into``'s shards that hold
    its region (``sharding.constrain_params``)."""
    pieces = {}
    for (name, region, _), g in zip(bound, grads):
        pieces.setdefault(name, []).extend(tp.region_blocks(region, g))
    sh.constrain_params(pieces, into=into)


def _embed(skels: list, inputs: torch.Tensor, plan: tp.Plan, group: col.Group, cfg):
    """The embedding stage: whole on the lead, or each position's rows of a
    vocabulary-split table, a token outside its slice a zero row, added by
    one all-reduce (exact: one term of each sum is not zero).  Under
    sequence parallelism the stream comes out split by sequence: the
    all-reduce a reduce-scatter, a whole embedding split from the lead."""
    if plan.vocab is None or not cfg.embed_inputs:
        x = skels[0].embed_tokens(inputs)
        return Stream.split(x, group) if plan.seq else x
    parts = []
    for skel, (v0, v1), dev in zip(skels, plan.vocab, group.devices):
        ids = inputs.to(dev).long() - v0
        held = (ids >= 0) & (ids < v1 - v0)
        parts.append(torch.where(held[..., None], skel.embed[ids.clamp(0, v1 - v0 - 1)], 0))
    if plan.seq:
        return Stream([_embedded(x, cfg) for x in col.reduce_scatter(parts, group, dim=1)], group)
    return _embedded(col.all_reduce(parts, group), cfg)


def _final_norm(skels: list, x) -> torch.Tensor:
    """The final norm, on the lead; of a stream split by sequence, on each
    position's rows (the weight broadcast from the lead), then gathered
    onto the lead."""
    x = stream_norm(x, skels[0].final_norm, skels[0].cfg.norm_eps)
    return x.whole() if isinstance(x, Stream) else x


def _logit_parts(skels: list, x, plan: tp.Plan, group: col.Group) -> list:
    """The final norm (:func:`_final_norm`), then each position's fp32
    logits of its vocabulary slice."""
    x = _final_norm(skels, x)
    return [_head_logits(xi, s) for xi, s in zip(col.broadcast(x, group), skels)]


def _detached(x):
    """The stream as a leaf of a new autograd graph."""
    out = [xi.detach().requires_grad_(True) for xi in stream_tensors(x)]
    return Stream(out, x.group) if isinstance(x, Stream) else out[0]


def group_train(placed: sh.PlacedModel, batch: dict, cfg: ModelConfig, plan: tp.Plan,
                group: col.Group, denom: torch.Tensor, aux_scale: float,
                into: dict) -> torch.Tensor:
    """One data-parallel group's share of a training microbatch, on its
    positions ``group`` (the lead first), laid out by ``plan``.

    ``batch`` holds the group's rows, on the lead's device; ``denom`` is the
    count of labels >= 0 over the whole microbatch (the reference's masked
    mean is global) and ``aux_scale`` the MoE aux term's weight for this
    group's mean over its routing groups.  The forward pass saves each
    block's input and nothing else (under ``plan.seq`` each position's
    rows of it, on its device); the backward pass recomputes each block
    from it (as the reference's per-period remat does) and reduces each
    stage's gradients into ``into``'s shards as soon as that stage is done,
    each position's gradient of its block into the shards of that block
    (``sharding.constrain_params(..., into=)``), so no whole-model gradient,
    and no whole gradient of a split leaf, is ever alive.  Returns the
    group's loss term: its masked NLL sum over ``denom`` plus ``aux_scale``
    times its summed aux losses.
    """
    if plan.stationary:
        raise ValueError("a MoE model placed in the inference layout (expert-stationary) "
                         "decodes; place it with inference=False to train")
    skels = _skeletons(placed, plan.n)
    embed, blocks, head = _stages(placed)
    lead = group.devices[0]
    with torch.no_grad():
        with _bound(skels, placed, embed, plan, group, False):
            x = _embed(skels, batch["inputs"], plan, group, cfg)
        saved, aux = [], torch.zeros((), dtype=torch.float32, device=lead)
        for i, names in enumerate(blocks):
            saved.append(x)
            with _bound(skels, placed, names, plan, group, False):
                x, a = B.block_train(x, tp.block_view(skels, i, plan, group), cfg,
                                     cfg.layer_kinds[i])
            aux = aux + a
    x = _detached(x)
    k = len(stream_tensors(x))  # the stream's tensors: 1, or a position's rows each
    with _bound(skels, placed, head, plan, group, True) as bound:
        if plan.vocab is None:
            nll = masked_nll_sum(_head_logits(_final_norm(skels, x), skels[0]),
                                 batch["labels"])
        else:
            nll = vocab_parallel_nll_sum(_logit_parts(skels, x, plan, group), batch["labels"],
                                         plan.vocab, group)
        nll = nll / denom
        grads = torch.autograd.grad(nll, [*stream_tensors(x), *(p for _, _, p in bound)])
    dx, grads = grads[:k], grads[k:]
    _reduce_grads(bound, grads, into)
    seed = torch.full((), aux_scale, dtype=torch.float32, device=lead)
    for i in reversed(range(len(blocks))):
        xi = _detached(saved.pop())
        with _bound(skels, placed, blocks[i], plan, group, True) as bound:
            y, a = B.block_train(xi, tp.block_view(skels, i, plan, group), cfg,
                                 cfg.layer_kinds[i])
            outs, seeds = stream_tensors(y), list(dx)
            if a.requires_grad:
                outs, seeds = outs + [a], seeds + [seed]
            grads = torch.autograd.grad(outs, [*stream_tensors(xi), *(p for _, _, p in bound)],
                                        seeds, allow_unused=True, materialize_grads=True)
        dx, grads = grads[:k], grads[k:]
        _reduce_grads(bound, grads, into)
    if embed:
        with _bound(skels, placed, embed, plan, group, True) as bound:
            x = _embed(skels, batch["inputs"], plan, group, cfg)
            grads = torch.autograd.grad(stream_tensors(x), [p for _, _, p in bound], list(dx))
        _reduce_grads(bound, grads, into)
    return nll.detach() + aux_scale * aux


def init_group_caches(placed: sh.PlacedModel, batch: int, max_len: int) -> list[list]:
    """One empty decode cache per data-parallel group of the current ctx, for
    the group's rows of ``batch``: a layer an entry, laid out over the
    group's positions by the reference's rule (``tensor_parallel.
    place_caches``: an attention layer's slots over the positions where
    they divide, an RG-LRU layer's channels where they split, a split xLSTM
    block's states by heads, else whole on the lead), each state at
    ``init_cache``'s values."""
    ctx, plan, groups = _decode_groups(placed, batch)
    shapes = init_cache(placed.cfg, batch // len(groups), max_len, "meta")
    caches = [tp.place_caches(plan, placed.cfg, ctx, shapes, grp, batch,
                              lambda t, d: torch.zeros(t.shape, dtype=t.dtype, device=d))
              for grp in groups]
    for cache in caches:  # the xLSTM stabiliser starts at xlstm._M0, not 0
        for kind, layer in zip(placed.cfg.layer_kinds, cache):
            if kind in ("mlstm", "slstm"):
                for piece in layer if isinstance(layer, list) else [layer]:
                    piece["m"].fill_(xlstm._M0)
    return caches


def place_group_caches(placed: sh.PlacedModel, cache: list[dict]) -> list[list]:
    """A whole decode cache (``prefill``'s, or ``init_cache``'s: a dict a
    layer, every row of the batch, on any device) laid out as
    :func:`init_group_caches` lays out an empty one, under the current ctx:
    each data-parallel group's rows over its positions.  The reference's
    ``jax.device_put(cache, _cache_shardings(...))``."""
    first = next(iter(cache[0].values()))
    batch = first.shape[0]
    ctx, plan, groups = _decode_groups(placed, batch)
    rows = batch // len(groups)
    return [tp.place_caches(plan, placed.cfg, ctx,
                            [{k: v[g * rows:(g + 1) * rows] for k, v in layer.items()}
                             for layer in cache], grp, batch,
                            lambda t, d: t.to(device=d, copy=True))
            for g, grp in enumerate(groups)]


def _decode_groups(placed: sh.PlacedModel, batch: int):
    """The current ctx over ``placed``'s mesh, the plan of a decode step of
    ``batch`` rows, and each data-parallel group's positions."""
    ctx = sh.executor_ctx(placed.mesh)
    leads = sh.dp_leads(ctx)
    _group_rows(batch, len(leads))
    plan = tp.plan(placed, ctx, (batch, 1, placed.cfg.d_model))
    return ctx, plan, [tp.group(placed, ctx, lead) for lead in leads]


def cache_position_bytes(placed: sh.PlacedModel, caches: list[list]) -> list[int]:
    """Bytes of the decode caches ``caches`` (:func:`init_group_caches`'s)
    each position of the mesh holds, under the current ctx."""
    ctx = sh.executor_ctx(placed.mesh)
    out = [0] * placed.mesh.size
    for lead, cache in zip(sh.dp_leads(ctx), caches):
        positions = sh.tp_peers(ctx, lead)
        for layer in cache:
            parts = layer.parts if isinstance(layer, attn.SeqKV) else layer
            for pos, part in zip(positions, parts if isinstance(parts, list) else [parts]):
                out[pos] += sum(t.numel() * t.element_size() for t in part.values())
    return out


def _group_rows(batch: int, dp: int) -> int:
    if batch % dp:
        raise ValueError(f"a batch of {batch} rows (dim 0) does not split over {dp} "
                         "data-parallel groups")
    return batch // dp


# the reference's two jitted inference programs over a mesh
# (src/repro/launch/dryrun.py:159-162 and :194-198): a variant a mesh, ctx,
# input signature and cache layout (decode) or max_len (prefill), never a
# position, which a decode step reads from a device tensor.  Both hand out
# fresh outputs: the logits, and the prefill's caches, are the caller's.
PLACED_DECODE = graphs.Program("placed_decode_step", eager_first=True, fresh=True)
PLACED_PREFILL = graphs.Program("placed_prefill", eager_first=True, fresh=True)


def _shards(placed: sh.PlacedModel) -> list[torch.Tensor]:
    """Every position's shard of every leaf: the tensors a placed program
    reads besides its operands."""
    return [t for x in placed.leaves.values() for t in x.shards]


def _layout(layer) -> tuple:
    """A layer's decode cache as a variant key: its pieces' names, shapes,
    dtypes and devices."""
    if isinstance(layer, attn.SeqKV):
        return ("seq", layer.group.positions, tuple(_layout(p) for p in layer.parts))
    if isinstance(layer, list):
        return ("positions", tuple(_layout(p) for p in layer))
    return tuple((k, tuple(layer[k].shape), layer[k].dtype, layer[k].device) for k in sorted(layer))


def _placed_decode(placed: sh.PlacedModel, caches: list, inputs: torch.Tensor, pos,
                   cfg: ModelConfig):
    """``decode_step`` over a placed model as a variant of
    :data:`PLACED_DECODE`, keyed as the reference's jit keys its step: the
    mesh and ctx, the inputs' shape and dtype, each layer's kind and cache
    layout, and the config.  ``pos`` is an operand, on the card a device
    tensor the replay copies in, so that a decode loop captures once.  The
    graph belongs to every shard of the model and every tensor of the
    caches (the reference donates the cache), which it updates in place."""
    mesh = placed.mesh
    ctx = sh.executor_ctx(mesh)
    if len(caches) != len(sh.dp_leads(ctx)):
        raise ValueError(f"{len(caches)} caches for {len(sh.dp_leads(ctx))} data-parallel groups")
    layout = tuple(tuple(zip(cfg.layer_kinds, (_layout(layer) for layer in cache)))
                   for cache in caches)
    key = (mesh, ctx, tuple(inputs.shape), inputs.dtype, layout, cfg)
    pos = torch.as_tensor(pos).to(torch.int64).reshape(())

    def body(inputs, pos):
        return _placed_decode_step(placed, caches, inputs, pos, cfg)

    logits = PLACED_DECODE(key, body, [inputs, pos],
                           _shards(placed) + list(graphs.tensors(caches)), device=mesh.devices[0])
    return logits, caches


def _copy_into(old, new) -> None:
    """A layer's new decode state copied into its old tensors: a dict, or a
    list of the positions' dicts."""
    if isinstance(old, dict):
        for k, t in old.items():
            if new[k] is not t:
                t.copy_(new[k])
    else:
        for o, n in zip(old, new):
            _copy_into(o, n)


@torch.no_grad()
def _placed_decode_step(placed: sh.PlacedModel, caches: list, inputs: torch.Tensor, pos,
                        cfg: ModelConfig) -> torch.Tensor:
    """The body of :data:`PLACED_DECODE`: ``decode_step`` over a placed model,
    in the layout of ``tensor_parallel.plan`` at ``[B, 1, D]``, layer by
    layer across the data-parallel groups (:func:`_over_groups`); each
    group's attention half on its positions with its cache there, and the
    FFN, per group for a dense MLP or a MoE layer in the training layout,
    across the groups for an expert-stationary MoE layer.  ``pos`` is a
    0-dim int64 tensor on position 0's device.  Every cache tensor is
    updated in place: a layer whose step returns a new state (RG-LRU,
    xLSTM) has it copied into its old tensors, as the reference's donated
    cache is (``launch/dryrun.py`` ``_decode_in_place`` on one device).
    Returns the logits [B,V] on position 0's device."""
    ctx = sh.executor_ctx(placed.mesh)
    groups = [tp.group(placed, ctx, lead) for lead in sh.dp_leads(ctx)]
    _group_rows(inputs.shape[0], len(groups))
    plan = tp.plan(placed, ctx, (*inputs.shape[:2], cfg.d_model))

    def block(g, i, x, view, local, stationary):
        kind, cache = cfg.layer_kinds[i], caches[g][i]
        if stationary:
            x, h, new = B.block_decode_mixer(x, view, local, kind, cache, pos)
        else:
            (x, new), h = B.block_decode(x, view, local, kind, cache, pos), None
        if new is not cache:
            _copy_into(cache, new)
        return x, h

    return _over_groups(placed, inputs, cfg, plan, groups, block)


def _placed_prefill(placed: sh.PlacedModel, inputs: torch.Tensor, cfg: ModelConfig,
                    max_len: int):
    """``prefill`` over a placed model as a variant of :data:`PLACED_PREFILL`,
    keyed on the mesh and ctx, the inputs' shape and dtype, ``max_len`` and
    the config (the reference jits ``lm.prefill`` with the parameters'
    and the inputs' shardings); its graph belongs to every shard of the
    model.  Returns (logits [B,V] on position 0's device, one cache a
    data-parallel group)."""
    mesh = placed.mesh
    ctx = sh.executor_ctx(mesh)
    key = (mesh, ctx, tuple(inputs.shape), inputs.dtype, max_len, cfg)

    def body(inputs):
        return _placed_prefill_step(placed, inputs, cfg, max_len)

    return PLACED_PREFILL(key, body, [inputs], _shards(placed), device=mesh.devices[0])


@torch.no_grad()
def _placed_prefill_step(placed: sh.PlacedModel, inputs: torch.Tensor, cfg: ModelConfig,
                         max_len: int):
    """The body of :data:`PLACED_PREFILL`: the prompt through the blocks
    layer by layer across the data-parallel groups (:func:`_over_groups`),
    in the layout of ``tensor_parallel.plan`` at ``[B, S, D]`` with the
    residual stream whole on each group's lead (a prefill saves nothing for
    a backward; split by sequence its sums are the same bit for bit).  The
    MoE layers route ``B S`` tokens (``moe.dp_config``).  Each block's cache
    is laid out at once by the decode's rule (``tensor_parallel.place_layer``,
    as :func:`place_group_caches` lays out a whole cache): an attention
    cache, whole on the group's lead (a split layer's KV heads gathered),
    grown to ``max_len`` slots first; a split RG-LRU or xLSTM state (by
    channels, by heads) kept on its positions where the decode splits it
    the same way."""
    ctx = sh.executor_ctx(placed.mesh)
    b, s = inputs.shape[:2]
    groups = [tp.group(placed, ctx, lead) for lead in sh.dp_leads(ctx)]
    _group_rows(b, len(groups))
    plan = dataclasses.replace(tp.plan(placed, ctx, (b, s, cfg.d_model)), seq=False)
    layout = tp.plan(placed, ctx, (b, 1, cfg.d_model))  # the decode's
    caches = [[] for _ in groups]

    def block(g, i, x, view, local, stationary):
        kind, group = cfg.layer_kinds[i], groups[g]
        if stationary:
            x, h, c = B.block_prefill_mixer(x, view, local, kind)
        else:
            (x, c), h = B.block_prefill(x, view, local, kind), None
        if not isinstance(c, list):
            c = _grown(kind, c, max_len)
        caches[g].append(tp.place_layer(layout, ctx, i, kind, c, group, b,
                                        lambda t, d: t.to(device=d, copy=True)))
        return x, h

    return _over_groups(placed, inputs, cfg, plan, groups, block), caches


def _over_groups(placed: sh.PlacedModel, inputs: torch.Tensor, cfg: ModelConfig,
                 plan: tp.Plan, groups: list, block) -> torch.Tensor:
    """A placed forward layer by layer across the data-parallel groups
    ``groups``, each group's rows of ``inputs`` on its positions: every
    group's embedding; then for each block ``i`` and group ``g``, with the
    block's leaves bound, ``block(g, i, x, view, local, stationary)`` ->
    (the stream, and for an expert-stationary MoE layer its second norm,
    else None), and the stationary FFN across the groups
    (``moe.moe_stationary``: each group's tokens to the groups that hold
    their experts and back); then each group's head at its last position.
    Each stage binds its leaves as it runs, a position's own shard without
    a copy wherever its region is that shard; a split head's logits are
    gathered onto the lead.  Returns the logits [B,V] on position 0's
    device."""
    dp = len(groups)
    local = dp_config(cfg, inputs.shape[0] * inputs.shape[1], dp)
    skels = _skeletons(placed, plan.n)
    embed, blocks, head = _stages(placed)
    xs = []
    for group, rows in zip(groups, inputs.chunk(dp)):
        with _bound(skels, placed, embed, plan, group, False, own=True):
            xs.append(_embed(skels, rows.to(group.devices[0]), plan, group, cfg))
    for i, names in enumerate(blocks):
        hs = []
        for g, group in enumerate(groups):
            with _bound(skels, placed, names, plan, group, False, own=True):
                xs[g], h = block(g, i, xs[g], tp.block_view(skels, i, plan, group), local,
                                 i in plan.stationary)
            if h is not None:
                hs.append(h)
        if hs:
            ys = moe_stationary(hs, tp.bind_stationary(placed, plan, i, groups), local)
            xs = [x + y for x, y in zip(xs, ys)]
    home, out = placed.mesh.devices[0], []
    for group, x in zip(groups, xs):
        x = x[:, -1:]
        with _bound(skels, placed, head, plan, group, False, own=True):
            if plan.vocab is None:
                logits = skels[0].lm_logits(x)
            else:
                logits = col.all_gather(_logit_parts(skels, x, plan, group), group)
        out.append(logits[:, 0].to(home))
    return torch.cat(out)
