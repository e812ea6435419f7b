"""The training step: gradient accumulation over microbatches, the
block-recomputing model forward, and the AdamW update, as in the JAX
package's ``train/train_step.py``.

The global batch splits into ``n_micro`` microbatches along its leading
axis; each microbatch's gradients (in the parameter dtype) accumulate into
``accum_dtype`` buffers, which are then divided by ``n_micro``.  With one
microbatch the gradients are used as they come, as in the reference.  The
reference's ``constrain_params`` is a sharding hint with no meaning on one
device, so it has no counterpart.  The step updates the state in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.state import _default_device, _tensor_from_host
from repro_torch.models import lm
from repro_torch.train.optimizer import OptimizerConfig, apply_updates, init_opt_state


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
    step counter (what the reference donates)."""
    opt = state.opt
    return (list(state.params.parameters()) + list(state.params.buffers())
            + list(opt["m"].values()) + list(opt["v"].values()) + [opt["step"]])


def train_step(state: TrainState, batch: dict, cfg: ModelConfig, tcfg: TrainConfig):
    """(state, batch) -> (state, metrics ``loss``, ``grad_norm``, ``lr``), the
    state updated in place.  ``batch`` holds tensors on the model's device."""
    grads, loss = grad_accum(state.params, batch, cfg, tcfg)
    _, opt, om = apply_updates(state.params, grads, state.opt, tcfg.optimizer)
    state.opt = opt
    return state, {"loss": loss, **om}
