"""AdamW with decoupled weight decay, global-norm clipping, and a linear
warmup + cosine decay schedule, built from scratch, as in the JAX package's
``train/optimizer.py``.

Parameters are a :class:`~repro_torch.models.lm.CausalLM` (its named
parameters) or a plain ``{name: tensor}`` dict; gradients, m and v are
``{name: tensor}`` dicts under the same names.  The port's parameter names
end in the JAX leaf names, so the decay mask reads the same last component.

Optimizer state dtype is configurable: fp32 by default, bf16 m/v for the
nemotron-style configs (``state_dtype``).  The schedule, the clip scale and
the bias corrections are fp32 tensors, as the reference computes them, not
Python floats; their constants are filled on the device, so a step copies
nothing from the host and can be captured.  The update runs under
``torch.no_grad()`` in place (the reference's donated buffers), the step
counter included, one leaf at a time and each leaf in flat
slices of at most ``_SLICE`` elements, so the fp32 temporaries never exceed
a few slices' worth; the arithmetic is elementwise, so slicing changes no
bit.  ``chunked_update`` is accepted and does nothing: the reference keeps
it as a refuted memory experiment (its ``lax.map`` over layer chunks broke
buffer aliasing), and the slicing above is what bounds memory here.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

_SLICE = 1 << 26  # elements of a leaf updated at once


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"
    chunked_update: bool = False  # accepted, no effect (see the module docstring)


def _f32(x, device) -> torch.Tensor:
    """``x`` as an fp32 0-d tensor, filled on ``device`` (no host copy)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), as an fp32 0-d tensor."""
    dev = step.device
    step = step.to(torch.float32)
    warm = cfg.peak_lr * torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.end_lr_frac + (1 - cfg.end_lr_frac) * 0.5 * (1 + torch.cos(_f32(math.pi, dev) * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def _named(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params, cfg: OptimizerConfig) -> dict:
    """``{"m": {name: zeros}, "v": {name: zeros}, "step": int32 0}`` on the
    parameters' device, m and v in ``state_dtype``."""
    named = _named(params)
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    dev = next(iter(named.values())).device
    return {
        "m": {n: zeros(p) for n, p in named.items()},
        "v": {n: zeros(p) for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _slices(t: torch.Tensor):
    flat = t.reshape(-1)
    return flat.split(_SLICE) if flat.numel() > _SLICE else (flat,)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares."""
    sums = [sum(torch.sum(torch.square(s.float())) for s in _slices(g)) for g in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def sharded_global_norm(grads: dict, device) -> torch.Tensor:
    """:func:`global_norm` of ``{name: Sharded}`` gradients, on ``device``:
    each leaf's distinct blocks summed once (a dim copied to several
    positions counts once), in position order."""
    sums = [sum(torch.sum(torch.square(s.float())) for s in _slices(x.shards[pos])).to(device)
            for x in grads.values() for pos in x.owners]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _decay_mask(name: str) -> bool:
    """Decay matrices; skip norms/biases/scalars (standard practice).  Reads
    the last component of a dotted parameter name."""
    name = name.rsplit(".", 1)[-1]
    return not (
        "norm" in name or name.startswith("b") or name in ("lam", "bi", "bf", "bz", "bo")
    )


def _scalars(cfg: OptimizerConfig, step_now: torch.Tensor, gnorm: torch.Tensor) -> dict:
    """The step's fp32 scalars on ``step_now``'s device: the next step, the
    clip scale, the learning rate and the two bias corrections."""
    step = step_now + 1
    dev = step.device
    step32 = step.to(torch.float32)
    return {
        "step": step,
        "scale": torch.clamp(_f32(cfg.clip_norm, dev) / torch.clamp(gnorm, min=1e-9), max=1.0),
        "lr": lr_at(cfg, step),
        "bc1": 1.0 - torch.pow(_f32(cfg.b1, dev), step32),
        "bc2": 1.0 - torch.pow(_f32(cfg.b2, dev), step32),
    }


def _adamw(name: str, p, g, m, v, k: dict, cfg: OptimizerConfig) -> None:
    """One leaf's AdamW update in place, ``k`` from :func:`_scalars`."""
    decay = bool(cfg.weight_decay) and _decay_mask(name)
    b1, b2 = cfg.b1, cfg.b2
    for ps, gs, ms, vs in zip(*map(_slices, (p, g, m, v))):
        g32 = gs.float() * k["scale"]
        m32 = b1 * ms.float() + (1 - b1) * g32
        v32 = b2 * vs.float() + (1 - b2) * torch.square(g32)
        update = (m32 / k["bc1"]) / (torch.sqrt(v32 / k["bc2"]) + cfg.eps)
        if decay:
            update = update + cfg.weight_decay * ps.float()
        ps.copy_(ps.float() - k["lr"] * update)
        ms.copy_(m32)
        vs.copy_(v32)


@torch.no_grad()
def apply_updates(params, grads: dict, opt_state: dict, cfg: OptimizerConfig):
    """One AdamW step, in place.  Returns (params, opt_state, metrics), the
    same objects updated: parameters, m and v are overwritten and the
    ``step`` tensor is incremented in place."""
    named = _named(params)
    gnorm = global_norm(grads)
    k = _scalars(cfg, opt_state["step"], gnorm)
    for name, p in named.items():
        _adamw(name, p, grads[name], opt_state["m"][name], opt_state["v"][name], k, cfg)
    opt_state["step"].copy_(k["step"])
    return params, opt_state, {"grad_norm": gnorm, "lr": k["lr"]}


@torch.no_grad()
def apply_sharded_updates(model, grads: dict, opt_state: dict, cfg: OptimizerConfig) -> dict:
    """:func:`apply_updates` over a model placed on a device mesh (a
    ``PlacedModel``), shard by shard: parameters, ``{name: Sharded}``
    gradients, m and v in the same layouts, and the step on every position.
    Each position updates its own shards with its own copy of the step's
    scalars, so positions that hold one block stay equal.  Returns the
    metrics, on position 0's device."""
    mesh = model.mesh
    gnorm = sharded_global_norm(grads, mesh.devices[0])
    steps = opt_state["step"].shards
    ks = {}  # one set of scalars a device
    for pos, dev in enumerate(mesh.devices):
        if dev not in ks:
            ks[dev] = _scalars(cfg, steps[pos], gnorm.to(dev))
    for name, x in model.leaves.items():
        m, v, g = opt_state["m"][name], opt_state["v"][name], grads[name]
        for pos, dev in enumerate(mesh.devices):
            _adamw(name, x.shards[pos], g.shards[pos], m.shards[pos], v.shards[pos], ks[dev], cfg)
    for s, dev in zip(steps, mesh.devices):
        s.copy_(ks[dev]["step"])
    return {"grad_norm": gnorm, "lr": ks[mesh.devices[0]]["lr"]}
