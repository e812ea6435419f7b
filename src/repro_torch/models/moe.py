"""Mixture-of-experts FFN: top-k token-choice routing with per-expert
capacity buffers (GShard/Switch semantics), for dbrx (16e top-4) and
qwen3-moe (128e top-8).

The JAX package builds one-hot ``[T, E, C]`` dispatch and combine tensors
and moves tokens with einsums.  Here routing yields, for every (token,
rank), the buffer slot ``e * C + position`` its token fills, or a trash slot
when the expert's capacity is full; dispatch is a scatter of token rows into
``[G, E*C + 1, D]`` buffers and combine a gather of the expert outputs.  The
kept set, the positions and the weights are the reference's, so the result
is the same arithmetic up to the order of sums.  :func:`route` rebuilds the
reference's dense tensors from the slots, for tests.

The JAX package's two ``dispatch_mode`` branches (experts gathered or
tokens moved) are the same arithmetic on one device, so one path runs
there.  Over a device mesh each data-parallel group routes, on its own
rows, exactly the reference's routing groups that fall in them
(:func:`dp_config`), and the layer runs in the layout its expert leaves
were placed in:

  * the training layout (``src/repro/models/moe.py:104-112``), the experts
    over the model axis: handed a ``common.Split``, every tensor-parallel
    position routes the same tokens with the whole router, runs the
    products of its ``E / tp`` experts and combines only the picks they
    hold; one all-reduce adds the partial combines;
  * the inference layout (``sharding._EXPERT_INFERENCE``, the reference's
    ``"tokens"`` branch, ``src/repro/models/moe.py:93-103``), the experts
    stationary over the data axis and each expert's hidden dim over the
    model axis: :func:`moe_stationary` runs one layer for every
    data-parallel group at once.  Each group fills its ``[G/dp, E, C, D]``
    buffers, an all-to-all sends each block of ``E/dp`` experts to the group
    that holds them, every position of that group runs its ``d_ff`` block
    of those experts on the buffers of all ``G`` routing groups, the
    ``e_out`` partial sums add in fp32 over the positions, and a second
    all-to-all returns each group's rows for its combine.  Where the layout
    leaves the experts whole (``make_decode_2d_ctx``, or ``E`` that the
    groups do not divide) each group runs every expert on its own buffers,
    ``d_ff`` still over its positions, and nothing is traded.

The expert products are batched matrix products over the expert axis, as
the reference's are einsums outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.state import _default_device
from repro_torch.distributed import collectives as col
from repro_torch.models.common import Split, _param, dense_init, tp_inputs, tp_output


class MoE(nn.Module):
    """The JAX ``moe_init`` tree as parameters: ``router [D, E]`` fp32,
    ``e_gate``/``e_in [E, D, F]`` and ``e_out [E, F, D]`` in the param dtype."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = _default_device(device)
        mc, d, pd = cfg.moe, cfg.d_model, cfg.pdtype()
        e, f = mc.n_experts, mc.d_ff
        self.router = _param((d, e), torch.float32, device)
        self.e_gate = _param((e, d, f), pd, device)
        self.e_in = _param((e, d, f), pd, device)
        self.e_out = _param((e, f, d), pd, device)


def moe_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> MoE:
    """The reference's distributions: fan-in truncated normals over axis 0
    (``router``, ``e_gate``, ``e_in``) and axis 1 (``e_out``)."""
    device = _default_device(device)
    p = MoE(cfg, device)
    pd = cfg.pdtype()
    with torch.no_grad():
        p.router.copy_(dense_init(gen, tuple(p.router.shape), torch.float32, device))
        p.e_gate.copy_(dense_init(gen, tuple(p.e_gate.shape), pd, device))
        p.e_in.copy_(dense_init(gen, tuple(p.e_in.shape), pd, device))
        p.e_out.copy_(dense_init(gen, tuple(p.e_out.shape), pd, device, scale_axis=1))
    return p


def capacity(mc: MoEConfig, n_tokens: int) -> int:
    c = int(mc.capacity_factor * mc.top_k * n_tokens / mc.n_experts)
    return max(c, 1)


def _pick_groups(t: int, target: int) -> int:
    return next(g for g in range(min(target, t), 0, -1) if t % g == 0)


def dp_config(cfg: ModelConfig, tokens: int, dp: int) -> ModelConfig:
    """``cfg`` for each of ``dp`` data-parallel groups that run a call of
    ``tokens`` tokens (a step's rows split evenly over the groups).

    The reference picks ``g = _pick_groups(tokens, moe.groups)`` over the
    whole batch, and each routing group (a contiguous run of tokens) has its
    own capacity.  A dp group holds the rows of ``g / dp`` of them, so it
    routes with ``groups = g / dp``, which its own token count picks back
    exactly.  Raises ``ValueError`` naming ``moe.groups`` where ``g`` does not
    split over the dp groups: no other routing is the reference's.
    """
    if cfg.moe is None or dp == 1:
        return cfg
    g = _pick_groups(tokens, cfg.moe.groups)
    if g % dp:
        raise ValueError(
            f"moe.groups={cfg.moe.groups} routes {tokens} tokens in {g} groups, which do not "
            f"split over {dp} data-parallel groups: set moe.groups so that they do")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, groups=g // dp))


def route_slots(gates: torch.Tensor, mc: MoEConfig, cap: int):
    """Token-choice top-k routing with per-expert capacity, in slot form.

    gates: [G, T, E] fp32 softmax probabilities.  Returns ``(slot [G, T, k]
    int64, weight [G, T, k] fp32, aux [G] fp32)``: ``slot`` is ``e * cap +
    position`` for a kept pick and ``E * cap`` (the trash slot) for a pick
    over its expert's capacity; ``weight`` is the (renormalised) gate of a
    kept pick and 0 for a dropped one.

    Ranks pick experts in descending gate order, an exact tie taking the
    lower expert id first, as ``jax.lax.top_k`` orders them.  Positions are
    rank-major: every token's first pick is placed before any second pick,
    then token order within a rank.
    """
    g, t, e = gates.shape
    k = mc.top_k
    # a stable descending sort puts equal gates in expert order
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]  # [G, T, k]
    if mc.norm_topk:
        topv = topv / (torch.sum(topv, dim=-1, keepdim=True) + 1e-9)
    # A pick's position is the number of earlier picks of its expert in
    # rank-major order (the reference's cumsum over one-hot [k*T, E] rows).
    # A stable sort by expert keeps that order within each expert, so the
    # position is the pick's index in the sorted order less its expert's
    # first index there.
    flat = topi.transpose(1, 2).reshape(g, k * t)  # expert of each pick, rank-major
    order = torch.sort(flat, dim=1, stable=True).indices
    counts = torch.zeros((g, e), dtype=torch.int64, device=gates.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))  # picks of each expert
    first = torch.cumsum(counts, dim=1) - counts  # [G, E]
    ranks = torch.arange(k * t, device=gates.device).expand(g, k * t)
    pos = torch.empty_like(flat).scatter_(
        1, order, ranks - torch.gather(first, 1, torch.gather(flat, 1, order)))
    pos = pos.reshape(g, k, t).transpose(1, 2)  # [G, T, k]
    keep = pos < cap
    slot = torch.where(keep, topi * cap + pos, e * cap)
    weight = torch.where(keep, topv, torch.zeros_like(topv))
    # load-balancing auxiliary loss (Switch): E * sum_e f_e * p_e, where f_e
    # counts every pick of e, the dropped ones too
    frac_tokens = counts.float() / t  # [G, E]
    frac_probs = torch.mean(gates, dim=1)
    aux = e * torch.sum(frac_tokens * frac_probs, dim=-1)
    return slot, weight, aux


def route(gates: torch.Tensor, mc: MoEConfig, cap: int):
    """The reference's ``route`` for one group: gates [T, E] -> (dispatch
    [T, E, C] bool, combine [T, E, C] fp32, aux scalar), from
    :func:`route_slots`."""
    t, e = gates.shape
    slot, weight, aux = route_slots(gates[None], mc, cap)
    combine = torch.zeros((t, e * cap + 1), dtype=torch.float32, device=gates.device)
    combine.scatter_(1, slot[0], weight[0])
    dispatch = torch.zeros((t, e * cap + 1), dtype=torch.bool, device=gates.device)
    dispatch.scatter_(1, slot[0], True)
    combine = combine[:, : e * cap].reshape(t, e, cap)
    return dispatch[:, : e * cap].reshape(t, e, cap), combine, aux[0]


def moe_ffn(x: torch.Tensor, params: MoE, cfg: ModelConfig):
    """x: [B, S, D] -> (out [B, S, D], aux loss scalar).

    Tokens split into ``moe.groups`` routing groups (the largest divisor of
    B*S not above it); capacity applies per group.  Each group's buffers
    hold ``E * C`` expert rows and one trash row that takes the dropped
    picks, which :func:`moe_ffn` never reads back.  ``params`` a ``Split``:
    the experts over the tensor-parallel positions (the module docstring),
    the aux loss the lead's; ``x`` may then be a stream split by sequence
    (``common.tp_inputs``), whose tokens every position routes gathered.
    """
    if isinstance(params, Split):
        xs = tp_inputs(x, params.group)
        outs = [_moe_local(xi, p, cfg, span) for xi, p, span in zip(xs, params.parts, params.spans)]
        return tp_output([y for y, _ in outs], x, params.group), outs[0][1]
    y, aux = _moe_local(x, params, cfg, (0, cfg.moe.n_experts))
    return y.to(x.dtype), aux


def _moe_local(x: torch.Tensor, params: MoE, cfg: ModelConfig, span: tuple[int, int]):
    """:func:`moe_ffn` over the experts ``span`` (``params``' expert leaves
    hold those): (the fp32 combine of the picks they hold [B, S, D], the
    aux loss).  The other experts' picks go to the trash row."""
    xt, cap, slot, weight, aux = _route(x, params.router, cfg.moe)
    e = span[1] - span[0]
    slot = slot - span[0] * cap
    slot = torch.where((slot >= 0) & (slot < e * cap), slot, e * cap)
    flat, xe = _dispatch(xt, slot, e, cap)
    h = _hidden(xe, params.e_gate, params.e_in)
    ye = _by_group(torch.bmm(h, params.e_out), xe.shape[0])
    return _combine(ye, flat, weight, x.dtype).reshape(x.shape), torch.mean(aux)


def _route(x: torch.Tensor, router: torch.Tensor, mc: MoEConfig):
    """``x`` [B, S, D] in its routing groups (the largest divisor of B*S not
    above ``mc.groups``): (xt [G, T/G, D], the capacity, and
    :func:`route_slots`' slot, weight and aux)."""
    b, s, d = x.shape
    g = _pick_groups(b * s, mc.groups)
    tg = b * s // g
    xt = x.reshape(g, tg, d)
    gates = torch.softmax(xt.float() @ router, dim=-1)
    cap = capacity(mc, tg)
    return (xt, cap, *route_slots(gates, mc, cap))


def _dispatch(xt: torch.Tensor, slot: torch.Tensor, e: int, cap: int):
    """Every pick's token row into its slot: (each pick's row among the
    groups' ``[E * C + 1]`` rows, flat; the buffers [G, E, C, D] without
    the trash row).  Only the trash row is written twice, and nothing reads
    it."""
    g, tg, d = xt.shape
    k = slot.shape[-1]
    rows = e * cap + 1  # buffer rows a group, the last the trash row
    flat = (torch.arange(g, device=xt.device)[:, None, None] * rows + slot).reshape(-1)
    xe = xt.new_zeros((g * rows, d))
    xe[flat] = xt[:, :, None, :].expand(g, tg, k, d).reshape(-1, d)
    return flat, xe.view(g, rows, d)[:, : e * cap].reshape(g, e, cap, d)


def _hidden(xe: torch.Tensor, e_gate: torch.Tensor, e_in: torch.Tensor) -> torch.Tensor:
    """The experts' gated hidden units [E, G*C, F] of buffers [G, E, C, D],
    expert-major for the products."""
    g, e, cap, d = xe.shape
    xe = xe.transpose(0, 1).reshape(e, g * cap, d)
    return F.silu(torch.bmm(xe, e_gate)) * torch.bmm(xe, e_in)


def _by_group(ye: torch.Tensor, g: int) -> torch.Tensor:
    """Expert-major outputs [E, G*C, D] as buffers [G, E, C, D]."""
    e, gc, d = ye.shape
    return ye.reshape(e, g, gc // g, d).transpose(0, 1)


def _combine(ye: torch.Tensor, flat: torch.Tensor, weight: torch.Tensor, dtype) -> torch.Tensor:
    """Each token's kept picks of the expert outputs ``ye`` [G, E, C, D],
    weighted by their gates cast to the compute dtype as the reference casts
    its combine tensor, summed in fp32: [G, T/G, D]; a dropped pick reads
    the zero trash row."""
    g, e, cap, d = ye.shape
    ye = torch.cat([ye.reshape(g, e * cap, d), ye.new_zeros((g, 1, d))], dim=1).reshape(-1, d)
    w = weight.to(dtype).float().reshape(-1, 1)
    return (ye[flat].float() * w).reshape(g, -1, weight.shape[-1], d).sum(dim=2)


# -- expert-stationary decode ------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Stationary:
    """An inference-layout MoE layer bound for every data-parallel group at
    once (``models/tensor_parallel.py`` ``bind_stationary`` builds it).

    ``routers[g]`` is group ``g``'s router on its lead; ``parts[g][t]`` the
    ``{"e_gate", "e_in", "e_out"}`` blocks that the ``t``-th of
    ``groups[g]``'s positions holds (its experts, its ``d_ff`` block);
    ``groups[g]`` those positions, the lead first; ``exchanges`` the sets of
    groups that trade tokens, each ``(group indices, collectives.Group`` of
    their leads``)`` in the order of the expert blocks they hold (none where
    every group holds every expert)."""

    routers: list
    parts: list
    groups: list
    exchanges: list


def _bmm32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` batched, with an fp32 result (a partial sum over ``d_ff``)."""
    if h.dtype == torch.float32:
        return torch.bmm(h, w)
    if h.is_cuda:
        return torch.bmm(h, w, out_dtype=torch.float32)
    return torch.bmm(h.float(), w.float())  # the CPU has no mixed-dtype product


def _sum_partials(parts: list, group: col.Group, dtype) -> torch.Tensor:
    """The positions' ``e_out`` partial sums added in fp32 on the lead."""
    return col.all_reduce(parts, group, dtype)


def _held_experts(xe: torch.Tensor, parts: list, group: col.Group) -> torch.Tensor:
    """The outputs [G, E_g, C, D] of the experts a group holds, on its lead,
    for buffers ``xe`` [G, E_g, C, D] on its lead: each position runs its
    ``d_ff`` block of every expert, and the ``e_out`` products' partial
    sums add in fp32 over the positions."""
    ins = col.broadcast(xe, group)
    return _by_group(_sum_partials([_bmm32(_hidden(x, p["e_gate"], p["e_in"]), p["e_out"])
                                    for x, p in zip(ins, parts)], group, xe.dtype), xe.shape[0])


def _trade(bufs: list, layer: Stationary, split_dim: int, cat_dim: int) -> list:
    """``bufs`` (a group's each) after an all-to-all within each exchange."""
    out = list(bufs)
    for idx, leads in layer.exchanges:
        for g, b in zip(idx, col.all_to_all([bufs[g] for g in idx], leads, split_dim, cat_dim)):
            out[g] = b
    return out


@torch.no_grad()
def moe_stationary(xs: list, layer: Stationary, cfg: ModelConfig) -> list:
    """One inference-layout MoE layer for every data-parallel group: ``xs[g]``
    group ``g``'s normed rows [B_g, S, D] on its lead, ``cfg`` a group's
    config (:func:`dp_config`).  Returns each group's FFN output, in the
    rows' dtype, on its lead (the module docstring).  The products equal
    the reference's ``"tokens"`` branch; its aux loss belongs to training
    and is dropped."""
    mc = cfg.moe
    routed, bufs = [], []
    for x, router in zip(xs, layer.routers):
        xt, cap, slot, weight, _ = _route(x, router, mc)
        flat, xe = _dispatch(xt, slot, mc.n_experts, cap)
        routed.append((flat, weight))
        bufs.append(xe)
    # [G/dp, E, C, D] a group -> [G, E/dp, C, D] on the group that holds those experts
    bufs = _trade(bufs, layer, 1, 0)
    outs = [_held_experts(xe, parts, group)
            for xe, parts, group in zip(bufs, layer.parts, layer.groups)]
    outs = _trade(outs, layer, 0, 1)
    return [_combine(ye, flat, weight, x.dtype).reshape(x.shape).to(x.dtype)
            for ye, (flat, weight), x in zip(outs, routed, xs)]
