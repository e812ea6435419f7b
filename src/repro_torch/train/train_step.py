"""The training step: gradient accumulation over microbatches, the
block-recomputing model forward, and the AdamW update, as in the JAX
package's ``train/train_step.py``.

The global batch splits into ``n_micro`` microbatches along its leading
axis; each microbatch's gradients (in the parameter dtype) accumulate into
``accum_dtype`` buffers, which are then divided by ``n_micro``.  With one
microbatch the gradients are used as they come, as in the reference.  The
step updates the state in place.

Over a device mesh the entry is the reference's own: place the state by the
rules (``distributed/sharding.py`` ``place``), then call :func:`train_step`
under ``use_ctx(make_ctx(mesh))``.  One controller runs the step, a
captured ``graphs.Program`` (a variant per mesh and batch signature; eager
on the CPU):

  * each microbatch's rows split evenly over the ctx's data-parallel
    groups (the reference's ``P(("data",), None)`` batch), and each group
    computes on its positions (``models/lm.py`` ``group_train``), groups
    and microbatches in a fixed order;
  * a group's positions along the model axis run the products the
    reference's rules and constraints put there tensor-parallel, each over
    its block of the weights (``models/tensor_parallel.py`` ``plan``, taken
    on the global microbatch's shape as the reference's jitted step sees
    it); the rest runs whole on the group's lead;
  * under ``make_ctx``'s default ``seq_shard=True``, where the group's
    positions divide the sequence, the residual stream lies by rows over
    them (sequence parallelism: ``models/tensor_parallel.py`` ``Plan.seq``),
    each position saving only its rows of each block's input;
  * the loss's denominator is the microbatch's whole count of labels >= 0,
    taken before any backward pass, and an MoE layer routes the reference's
    global groups (``models/moe.py`` ``dp_config``), its aux term their mean;
  * each block's gradients are reduced into ``accum_dtype`` shards of the
    parameters' layout as soon as its backward is done, each position's
    gradient of its block into the shards of that block, the reference's
    ``constrain_params`` on each microbatch gradient and on the accumulator;
  * AdamW runs shard by shard (``optimizer.apply_sharded_updates``).

A model axis of size 1 runs every product whole on a group's one position.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import graphs
from repro_torch.core.state import _default_device, _tensor_from_host
from repro_torch.distributed import sharding as sh
from repro_torch.models import lm
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.moe import dp_config
from repro_torch.train.optimizer import (
    OptimizerConfig,
    apply_sharded_updates,
    apply_updates,
    init_opt_state,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_micro: int = 1  # gradient-accumulation steps
    accum_dtype: str = "float32"
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)


@dataclasses.dataclass
class TrainState:
    """The model (parameters with ``requires_grad``) and the optimizer state
    ``{"m": {name: tensor}, "v": {name: tensor}, "step": int32 0-d tensor}``."""

    params: lm.CausalLM
    opt: dict


def init_train_state(gen: torch.Generator, cfg: ModelConfig, tcfg: TrainConfig,
                     device=None) -> TrainState:
    """Random weights from ``gen`` on ``device`` (the current CUDA device by
    default; raises without one) and zero optimizer state."""
    model = lm.init_params(gen, cfg, _default_device(device)).requires_grad_(True)
    return TrainState(params=model, opt=init_opt_state(model, tcfg.optimizer))


def train_state_from_numpy(tree, cfg: ModelConfig, device) -> TrainState:
    """The JAX package's ``TrainState`` (``params`` and ``opt``, every leaf a
    host array: ``jax.tree.map(np.asarray, state)``) as a port state on
    ``device``: the model through ``lm.params_from_numpy``, m and v unstacked
    the same way, and the step count."""
    device = torch.device(device)
    model = lm.params_from_numpy(tree.params, cfg, device).requires_grad_(True)
    names = [n for n, _ in model.named_parameters()]
    opt = {"step": torch.tensor(int(np.asarray(tree.opt["step"])), dtype=torch.int32,
                                device=device)}
    for key in ("m", "v"):
        leaves = lm.named_leaves(tree.opt[key], cfg)
        if sorted(leaves) != sorted(names):
            raise ValueError(f"opt[{key!r}] does not hold one leaf per parameter")
        opt[key] = {n: _tensor_from_host(leaves[n], device) for n in names}
    return TrainState(params=model, opt=opt)


def _microbatch(batch: dict, n_micro: int) -> list[dict]:
    for x in batch.values():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch of {x.shape[0]} does not split into {n_micro} microbatches")
    return [{k: v.chunk(n_micro)[i] for k, v in batch.items()} for i in range(n_micro)]


def _loss_and_grads(model: lm.CausalLM, batch: dict, params: list):
    loss = model.train_loss(batch)[0]
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    return loss.detach(), grads


def grad_accum(model: lm.CausalLM, batch: dict, cfg: ModelConfig, tcfg: TrainConfig):
    """Accumulate gradients over the microbatches; returns
    ``({name: grad}, mean loss)``."""
    names, params = zip(*model.named_parameters())
    if tcfg.n_micro == 1:
        loss, grads = _loss_and_grads(model, batch, params)
        return dict(zip(names, grads)), loss
    adt = getattr(torch, tcfg.accum_dtype)
    acc = [torch.zeros(p.shape, dtype=adt, device=p.device) for p in params]
    loss_sum = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for mb in _microbatch(batch, tcfg.n_micro):
        loss, grads = _loss_and_grads(model, mb, params)
        for a, g in zip(acc, grads):
            a.add_(g.to(adt))
        del grads
        loss_sum = loss_sum + loss
    return {n: a.div_(tcfg.n_micro) for n, a in zip(names, acc)}, loss_sum / tcfg.n_micro


def state_tensors(state: TrainState) -> list[torch.Tensor]:
    """The tensors a training step updates in place: parameters, m, v and the
    step counter (what the reference donates); of a placed state, every
    position's shards of them."""
    if isinstance(state.params, sh.PlacedModel):
        return [s for x in sh.sharded_leaves(state) for s in x.shards]
    opt = state.opt
    return (list(state.params.parameters()) + list(state.params.buffers())
            + list(opt["m"].values()) + list(opt["v"].values()) + [opt["step"]])


# the sharded step: a variant per mesh and batch signature (the module docstring)
SHARDED_STEP = graphs.Program("sharded_train_step", eager_first=True, fresh=True)


def train_step(state: TrainState, batch: dict, cfg: ModelConfig, tcfg: TrainConfig):
    """(state, batch) -> (state, metrics ``loss``, ``grad_norm``, ``lr``), the
    state updated in place.  ``batch`` holds tensors on the model's device;
    of a placed state, on the host or on position 0's device, the step run
    under a ctx over the state's mesh."""
    if isinstance(state.params, sh.PlacedModel):
        return state, _sharded_step(state, batch, cfg, tcfg)
    grads, loss = grad_accum(state.params, batch, cfg, tcfg)
    _, opt, om = apply_updates(state.params, grads, state.opt, tcfg.optimizer)
    state.opt = opt
    return state, {"loss": loss, **om}


def _sharded_step(state: TrainState, batch: dict, cfg: ModelConfig, tcfg: TrainConfig) -> dict:
    """The step over a placed state, as a variant of :data:`SHARDED_STEP`."""
    mesh = state.params.mesh
    ctx = sh.executor_ctx(mesh)
    names = list(batch)
    values = [batch[k] for k in names]
    key = (mesh, ctx, tuple((k, tuple(t.shape), t.dtype) for k, t in zip(names, values)), cfg,
           tcfg)

    def body(*values):
        return _step_over_mesh(state, dict(zip(names, values)), cfg, tcfg, ctx)

    return SHARDED_STEP(key, body, values, state_tensors(state), device=mesh.devices[0])


def _step_over_mesh(state: TrainState, batch: dict, cfg: ModelConfig, tcfg: TrainConfig,
                    ctx: sh.ShardCtx) -> dict:
    """The body of :func:`_sharded_step` (the module docstring's design)."""
    model, mesh = state.params, state.params.mesh
    leads = sh.dp_leads(ctx)
    dp, home = len(leads), mesh.devices[0]
    adt = getattr(torch, tcfg.accum_dtype)
    acc = {n: x.zeros(adt) for n, x in model.leaves.items()}
    aux_scale = cfg.moe.aux_loss_weight / max(cfg.n_layers, 1) / dp if cfg.moe else 0.0
    loss = torch.zeros((), dtype=torch.float32, device=home)
    for mb in _microbatch(batch, tcfg.n_micro):
        for k, v in mb.items():
            if v.shape[0] % dp:
                raise ValueError(f"a microbatch of {v.shape[0]} rows of {k!r} (dim 0) does not "
                                 f"split over {dp} data-parallel groups")
        parts = [{k: v.chunk(dp)[g] for k, v in mb.items()} for g in range(dp)]
        local = dp_config(cfg, mb["labels"].numel(), dp)
        denom = lm.label_count(mb["labels"])  # the whole microbatch's, before any backward
        plan = tp.plan(model, ctx, (*mb["inputs"].shape[:2], cfg.d_model))
        for lead, part in zip(leads, parts):
            group = tp.group(model, ctx, lead)
            dev = group.devices[0]
            part = {k: v.to(dev) for k, v in part.items()}
            loss += lm.group_train(model, part, local, plan, group, denom.to(dev), aux_scale,
                                   acc).to(home)
    if tcfg.n_micro > 1:
        for x in acc.values():
            for s in x.shards:
                s.div_(tcfg.n_micro)
    metrics = apply_sharded_updates(model, acc, state.opt, tcfg.optimizer)
    return {"loss": loss / tcfg.n_micro, **metrics}
