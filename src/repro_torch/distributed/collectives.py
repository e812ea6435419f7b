"""Distributed-optimisation collectives: int8 gradient compression.

The JAX package's ``distributed/collectives.py``.  ``quantized_mean``
compresses each gradient leaf around the data-parallel reduction: a
per-leaf symmetric scale, int8 quantisation, the mean, dequantisation.
Without an axis name it models the wire format alone (quantise, then
dequantise), as the reference's path without one does.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the two
packages give the same int8 payload bit for bit.

With an ``axis_name`` the reference runs inside ``shard_map`` and
all-gathers the int8 payload over a mesh axis
(``src/repro/distributed/collectives.py:42-46``).  Here that is a leaf
:class:`~repro_torch.distributed.sharding.Sharded` over the current ctx's
``DeviceMesh``, each position's shard its own value (``shard_map``'s local
block): each position quantises its shard, the int8 payloads and scales of
the positions along the axis are copied to it (int8 between devices), and
it dequantises them and takes their mean in axis order.

The tensor-parallel collectives over a data-parallel group's positions
along the ctx's model axes (a :class:`Group`) are Megatron's f and g, each
a ``torch.autograd.Function``:

  * :func:`broadcast` (f) copies a replicated activation to every position;
    its backward is an all-reduce of the positions' gradients;
  * :func:`all_reduce` (g) adds the positions' partial products, in fp32 in
    position order, and casts the sum once; its backward is the identity
    (the gradient copied back to each position);
  * :func:`all_gather` concatenates the positions' slices (its backward
    hands each position its slice of the gradient), and
    :func:`all_reduce_max` takes an elementwise max, with no gradient;
  * :func:`reduce_scatter` and :func:`split` are the pair of sequence
    parallelism: a reduce-scatter adds the positions' partial products as
    :func:`all_reduce` does and leaves each position its slice of the sum
    (its backward gathers the slices' gradients onto every position), and
    a split hands each position its slice of a tensor on the lead (its
    backward gathers the slices' gradients onto the lead).

Between data-parallel groups, :func:`all_to_all` trades blocks among the
groups' positions that share a tensor-parallel index: expert-stationary
MoE decode (``models/moe.py`` ``moe_stationary``) sends each group's token
buffers to the groups that hold their experts and the outputs back.

One controller drives every position, so a reduction lands once on the
group's lead and the next :func:`broadcast` copies it: every position gets
the same bits.  :data:`counts` counts each collective as it runs.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.distributed.sharding import (
    Sharded,
    axis_group,
    current_ctx,
    has_devices,
)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation: returns (q, scale), scale an
    fp32 0-d tensor."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _tree_map(fn, tree):
    if isinstance(tree, (torch.Tensor, Sharded)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def all_gather_int8(x: Sharded, axis_name: str) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """For each position of ``x``'s mesh: the int8 payloads ``[n, *local]``
    and fp32 scales ``[n]`` of the ``n`` positions along ``axis_name`` (its
    own among them), in the axis's order, on its device: the reference's
    ``all_gather`` of ``quantize_int8``'s outputs."""
    payload = [quantize_int8(t) for t in x.shards]
    out = []
    for pos, dev in enumerate(x.mesh.devices):
        peers = axis_group(x.mesh, pos, axis_name)
        out.append((torch.stack([payload[p][0].to(dev) for p in peers]),
                    torch.stack([payload[p][1].to(dev) for p in peers])))
    return out


def quantized_mean(tree, axis_name: str | None = None):
    """Compress-and-reduce a gradient tree (tensors in nested dicts, lists
    and tuples); each leaf comes back in its own dtype.

    Without ``axis_name``: the round trip (quantise, then dequantise), which
    is what one process can verify numerically.  With it: every leaf is a
    ``Sharded`` value over the current ctx's ``DeviceMesh``; each position
    gets the mean over the axis of the dequantised payloads
    (:func:`all_gather_int8`), each term multiplied and added in one
    rounding, in axis order.
    """
    if axis_name is None:
        def one(g):
            q, s = quantize_int8(g)
            return dequantize_int8(q, s, g.dtype)

        return _tree_map(one, tree)
    ctx = current_ctx()
    if ctx is None or not has_devices(ctx.mesh):
        raise ValueError(f"quantized_mean over mesh axis {axis_name!r} runs under a ctx over a "
                         "DeviceMesh")
    if axis_name not in ctx.mesh.axis_names:
        raise ValueError(f"the ctx's mesh axes {ctx.mesh.axis_names} have no axis {axis_name!r}")

    def reduce(x):
        if not isinstance(x, Sharded) or x.mesh != ctx.mesh:
            raise TypeError("quantized_mean over a mesh axis takes Sharded leaves on the ctx's "
                            "mesh")
        shards = []
        for qf, sf in all_gather_int8(x, axis_name):
            total = torch.zeros(qf.shape[1:], dtype=torch.float32, device=qf.device)
            for q, s in zip(qf, sf):
                # one rounding a term, as XLA fuses the reference's product into its sum
                total = torch.addcmul(total, q.float(), s)
            shards.append((total / len(qf)).to(x.dtype))
        return dataclasses.replace(x, shards=shards)

    return _tree_map(reduce, tree)


# -- tensor-parallel collectives over a group's positions ------------------------

# collectives run, by kind: "all_reduce" (forward), "all_reduce_grad" (a
# broadcast's backward), "all_gather", "all_reduce_max", "all_to_all",
# "broadcast", "reduce_scatter", "split"
counts: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Group:
    """The positions of a mesh along some of its axes, in the axes' order,
    and their devices; ``devices[0]``, the lead's, holds what a reduction
    returns."""

    positions: tuple[int, ...]
    devices: tuple[torch.device, ...]

    @classmethod
    def along(cls, mesh, pos: int, axes) -> Group:
        """``pos`` and its peers along ``axes`` (a mesh axis or a tuple)."""
        ps = tuple(axis_group(mesh, pos, axes))
        return cls(ps, tuple(mesh.devices[p] for p in ps))


def _sum32(parts, device) -> torch.Tensor:
    """The fp32 sum of ``parts`` on ``device``, added in their order.  f64
    parts add in f64: no model hands them over, but ``gradcheck`` of these
    collectives needs the double-precision sums."""
    dtype = torch.promote_types(parts[0].dtype, torch.float32)
    total = parts[0].to(device=device, dtype=dtype, copy=True)
    for p in parts[1:]:
        total.add_(p.to(device=device, dtype=dtype))
    return total


def _spans(size: int, n: int, what: str) -> list[tuple[int, int]]:
    """The ``n`` even slices of a dim of ``size``; raises where ``n`` does
    not divide it."""
    if size % n:
        raise ValueError(f"{what}: a dim of {size} does not split over {n} positions")
    return [(t * size // n, size // n) for t in range(n)]


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, x):
        ctx.device, ctx.dtype = x.device, x.dtype
        return tuple(x.view_as(x) if d == x.device else x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        counts["all_reduce_grad"] += 1
        return None, _sum32(grads, ctx.device).to(ctx.dtype)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, dtype, *parts):
        ctx.devices, ctx.dtypes = devices, [p.dtype for p in parts]
        return _sum32(parts, devices[0]).to(dtype)

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *(grad.to(device=d, dtype=t) for d, t in zip(ctx.devices, ctx.dtypes)))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, dim, *parts):
        ctx.devices, ctx.dim = devices, dim
        ctx.sizes = [p.shape[dim] for p in parts]
        return torch.cat([p.to(devices[0]) for p in parts], dim=dim)

    @staticmethod
    def backward(ctx, grad):
        pieces = grad.split(ctx.sizes, dim=ctx.dim)
        return (None, None, *(g.to(d) for g, d in zip(pieces, ctx.devices)))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, dim, dtype, *parts):
        ctx.devices, ctx.dim, ctx.dtypes = devices, dim, [p.dtype for p in parts]
        spans = _spans(parts[0].shape[dim], len(devices), "reduce_scatter")
        return tuple(_sum32([p.narrow(dim, *span) for p in parts], d).to(dtype)
                     for span, d in zip(spans, devices))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, *(torch.cat([g.to(d) for g in grads], dim=ctx.dim).to(t)
                                    for d, t in zip(ctx.devices, ctx.dtypes)))


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, dim, x):
        ctx.device, ctx.dim = x.device, dim
        spans = _spans(x.shape[dim], len(devices), "split")
        # each slice an allocation of its own, so that it outlives x alone
        return tuple(x.narrow(dim, *span).to(device=d, copy=True)
                     for span, d in zip(spans, devices))

    @staticmethod
    def backward(ctx, *grads):
        return None, None, torch.cat([g.to(ctx.device) for g in grads], dim=ctx.dim)


def broadcast(x: torch.Tensor, group: Group) -> list[torch.Tensor]:
    """Megatron's f: ``x`` (on the lead) on every position of ``group``;
    backward, the positions' gradients added in fp32 in position order and
    cast once to ``x``'s dtype."""
    counts["broadcast"] += 1
    return list(_Broadcast.apply(group.devices, x))


def all_reduce(parts: list[torch.Tensor], group: Group, dtype=None) -> torch.Tensor:
    """Megatron's g: the sum of the positions' ``parts`` on the lead, added
    in fp32 in position order and cast once to ``dtype`` (by default the
    parts'); backward, the gradient copied to every position."""
    counts["all_reduce"] += 1
    return _AllReduce.apply(group.devices, dtype or parts[0].dtype, *parts)


def all_gather(parts: list[torch.Tensor], group: Group, dim: int = -1) -> torch.Tensor:
    """The positions' ``parts`` concatenated along ``dim``, in position order,
    on the lead; backward, each position's slice of the gradient."""
    counts["all_gather"] += 1
    return _AllGather.apply(group.devices, dim, *parts)


def reduce_scatter(parts: list[torch.Tensor], group: Group, dim: int = 1,
                   dtype=None) -> list[torch.Tensor]:
    """The sum of the positions' ``parts``, each position left its slice
    along ``dim`` on its device (the dim splits evenly over the group, or
    this raises): each slice added in fp32 in position order and cast once
    to ``dtype`` (by default the parts'), so that it equals the same slice
    of :func:`all_reduce`'s sum bit for bit.  Backward, the slices'
    gradients concatenated onto every position (an all-gather)."""
    counts["reduce_scatter"] += 1
    return list(_ReduceScatter.apply(group.devices, dim, dtype or parts[0].dtype, *parts))


def split(x: torch.Tensor, group: Group, dim: int = 1) -> list[torch.Tensor]:
    """``x`` (on the lead) cut evenly along ``dim``, position ``t``'s slice a
    copy on its device (the dim splits over the group, or this raises);
    backward, the slices' gradients concatenated on the lead."""
    counts["split"] += 1
    return list(_Split.apply(group.devices, dim, x))


@torch.no_grad()
def all_reduce_max(parts: list[torch.Tensor], group: Group) -> torch.Tensor:
    """The elementwise max of the positions' ``parts`` on the lead (no
    gradient: a vocabulary-parallel log-softmax's shift)."""
    counts["all_reduce_max"] += 1
    out = parts[0].to(group.devices[0], copy=True)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(group.devices[0]))
    return out


@torch.no_grad()
def all_to_all(parts: list[torch.Tensor], group: Group, split_dim: int,
               cat_dim: int) -> list[torch.Tensor]:
    """What each position of ``group`` receives when every position ``i``
    cuts its ``parts[i]`` evenly along ``split_dim`` (the dim splits over
    the group, or this raises) and sends block ``j`` to position ``j``:
    position ``j``'s blocks from every position, concatenated along
    ``cat_dim`` in position order, on its device.  ``group`` holds the
    data-parallel groups' positions that share a tensor-parallel index.
    Decode alone trades tokens this way, so it has no backward (no
    autograd ``Function``)."""
    counts["all_to_all"] += 1
    n = len(group.devices)
    if len(parts) != n:
        raise ValueError(f"all_to_all: {len(parts)} parts for {n} positions")
    spans = _spans(parts[0].shape[split_dim], n, "all_to_all")
    return [torch.cat([p.narrow(split_dim, *span).to(d) for p in parts], dim=cat_dim)
            for span, d in zip(spans, group.devices)]
