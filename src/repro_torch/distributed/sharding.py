"""Sharding rules: logical axes -> mesh axes, parameter rules, activation
constraints, and placement of parameters over a device mesh.

The JAX package's ``distributed/sharding.py``, with its rules kept as data.
Model code there asks for logical axes ("dp", "tp", "fsdp", "seq") through
a context, and GSPMD applies the resulting specs.  The port has no GSPMD:
a single controller drives every position of a mesh.

Two kinds of mesh:
  * a :class:`MeshShape`: axis names and sizes, no devices (what the
    reference reads through ``mesh.shape[...]`` and ``mesh.axis_names``).
    The dry-run (``launch/dryrun.py``) reads per-device shapes off the
    rules on the production meshes with it, tensors on ``meta``;
  * a ``launch/mesh.py`` ``DeviceMesh``: a ``MeshShape`` plus one
    ``torch.device`` per position, row-major.  Positions may share a device
    (every position on one card, or on the CPU in the tests) or lie on
    distinct cards; only the copies between positions differ.

On a ``DeviceMesh``, :func:`shard` lays a tensor out as a :class:`Sharded`
value (one local tensor per position, replicated dims copied to each) and
:func:`place` applies the parameter rules leaf by leaf to a model or a
training state.  A data-parallel group is its lead position and the lead's
peers along the ctx's tensor-parallel axes (:func:`tp_peers`).  The
executor (``models/lm.py``, ``models/tensor_parallel.py``,
``train/train_step.py``) runs the products that the reference constrains
to the model axis tensor-parallel over a group's positions, Megatron's
column- and row-parallel layout: each position binds only its block of a
weight (:func:`gather_region`, over the fsdp axis alone; a decode step
binds a position's own shard without a copy, :func:`bind_region`), and the
``distributed/collectives.py`` all-reduces join the partial products.
:func:`constrain` resolves and checks a spec and returns its input, since
the executor, not a constraint, lays the activations out;
:func:`tp_worthwhile` is the reference's rule for which dense products run
tensor-parallel.  :func:`constrain_params` is the reduction of gradients,
whole or a position's block, into the parameters' shards.

A spec is a plain tuple with one entry per dim: ``None``, an axis name or a
tuple of names (the reference's ``PartitionSpec``).  A dim over a tuple of
axes takes the first axis as the major one, as JAX does.

Default production mapping (DESIGN.md §6):
  dp    = ("pod", "data")   batch parallel (pods are pure DP)
  fsdp  = "data"            parameter/optimizer sharding (intra-pod)
  tp    = "model"           tensor parallel (heads / ff columns / vocab / EP)
  seq   = "model"           sequence parallelism on the residual stream
                            (a data-parallel group's rows of a training
                            microbatch split over its tensor-parallel
                            positions where they divide the sequence)

:func:`cache_spec` is the reference's rule for the decode cache, which the
placed decode (``models/tensor_parallel.py`` ``place_caches``) and the
dry-run's accounting (``launch/dryrun.py`` ``account``) both follow.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import math
import threading

import torch
from torch import nn

Spec = tuple  # one entry per dim: None, an axis name, or a tuple of names


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A device mesh by axis names and sizes alone."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.sizes)} sizes for axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        return math.prod(self.sizes)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: MeshShape
    dp: tuple[str, ...] = ("data",)
    fsdp: str | None = "data"
    tp: str | tuple[str, ...] | None = "model"
    seq_shard: bool = True  # sequence parallelism on residual stream

    def resolve(self, logical: str | None):
        if logical is None:
            return None
        if logical == "dp":
            return self.dp or None
        if logical == "fsdp":
            return self.fsdp
        if logical == "tp":
            return self.tp
        if logical == "seq":
            return self.tp if self.seq_shard else None
        raise ValueError(f"unknown logical axis {logical}")


def make_decode_2d_ctx(mesh: MeshShape) -> ShardCtx:
    """Inference layout for dense models too large to data-replicate: all
    mesh axes become one flat tensor-parallel axis (weights sharded over
    every device), the KV cache seq-shards over the same flat axis, and the
    batch is replicated (decode activations are tiny)."""
    return ShardCtx(mesh=mesh, dp=(), fsdp=None, tp=tuple(mesh.axis_names), seq_shard=True)


_local = threading.local()


def current_ctx() -> ShardCtx | None:
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def use_ctx(ctx: ShardCtx | None):
    prev = current_ctx()
    _local.ctx = ctx
    try:
        yield
    finally:
        _local.ctx = prev


def make_ctx(mesh: MeshShape, *, seq_shard: bool = True) -> ShardCtx:
    names = mesh.axis_names
    dp = tuple(n for n in ("pod", "data") if n in names) or (names[0],)
    tp = "model" if "model" in names else None
    fsdp = "data" if "data" in names else None
    return ShardCtx(mesh=mesh, dp=dp, fsdp=fsdp, tp=tp, seq_shard=seq_shard)


def spec(*logical: str | None) -> Spec:
    """A spec from logical axis names under the current ctx (``()`` without one)."""
    ctx = current_ctx()
    if ctx is None:
        return ()
    return tuple(ctx.resolve(lg) for lg in logical)


def _axis_prod(mesh: MeshShape, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh.shape[entry]
    n = 1
    for a in entry:
        n *= mesh.shape[a]
    return n


def sanitize_spec(spec: Spec, shape: tuple[int, ...], mesh: MeshShape) -> Spec:
    """Drop mesh axes from dims they don't divide (batch=1 decode, 49155-row
    vocabs, 4-head state tensors...) — replicate those dims instead."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(
        entry if dim % _axis_prod(mesh, entry) == 0 else None
        for dim, entry in zip(shape, entries)
    )


def shard_shape(shape: tuple[int, ...], spec: Spec, mesh: MeshShape) -> tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape`` laid out by
    ``spec`` (already sanitized: every entry divides its dim)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        n = _axis_prod(mesh, entry)
        if dim % n:
            raise ValueError(f"dim {dim} does not split {n} ways (sanitize the spec first)")
        out.append(dim // n)
    return tuple(out)


def constrain(x, *logical: str | None):
    """The reference's ``with_sharding_constraint``: the identity outside a
    ctx.  Under one, the spec is resolved (an unknown logical axis raises
    ``ValueError``) and sanitized against ``x``'s shape, and ``x`` comes
    back unchanged: on a ``DeviceMesh`` the executor lays the activations
    out itself (a group's rows on its positions, a tensor-parallel
    product's heads, columns, channels, experts or vocabulary slice on each
    of the group's tp positions, and under sequence parallelism each tp
    position's rows of the residual stream: ``models/tensor_parallel.py``)."""
    ctx = current_ctx()
    if ctx is not None:
        sanitize_spec(tuple(ctx.resolve(lg) for lg in logical), tuple(x.shape), ctx.mesh)
    return x


def tp_worthwhile(x_shape: tuple[int, ...], w_elems: int) -> bool:
    """Should a layer force Megatron TP sharding on its activations?

    The reference's napkin rule: constrain iff the layer's weight elements
    exceed 2x the per-device activation elements.  False outside a ctx.
    ``x_shape`` is the global activation the reference's jitted step sees
    (a whole microbatch ``[B, S, D]``, a decode step's ``[B, 1, D]``): the
    rule divides its tokens by the data-parallel size itself.  On a
    ``DeviceMesh`` the executor runs an attention or dense MLP layer
    tensor-parallel over the model axis exactly when this holds
    (``models/tensor_parallel.py`` ``plan``), and whole on a group's lead
    otherwise.
    """
    ctx = current_ctx()
    if ctx is None:
        return False
    dp = 1
    for a in ctx.dp:
        dp *= ctx.mesh.shape[a]
    tokens_dev = 1
    for d in x_shape[:-1]:
        tokens_dev *= d
    tokens_dev = max(tokens_dev // dp, 1)
    return w_elems > 2 * tokens_dev * x_shape[-1]


def constrain_params(grads: dict, into: dict | None = None):
    """The reference's ``constrain_params`` on each microbatch gradient and on
    the gradient accumulator (``src/repro/train/train_step.py:81-83``),
    which pins both to the parameters' shardings so that adding them lowers
    to a reduce-scatter into the sharded accumulator.  Here it is that
    reduction: under a ``DeviceMesh`` ctx each gradient ``grads[name]`` is
    added into the :class:`Sharded` accumulator ``into[name]`` in the
    accumulator's dtype, in place; returns ``into``.  A gradient is a whole
    tensor (:meth:`Sharded.add_`) or, for a leaf bound block by block on a
    group's tensor-parallel positions, a list of ``(region, block)`` pairs,
    each added into the shards that hold that block
    (:meth:`Sharded.add_region_`), so that no whole gradient of such a leaf
    is formed.  This is the step's reduction of a block's gradients
    (``models/lm.py`` ``group_train``).

    Without ``into`` it changes no value and returns ``grads``, under any
    ctx or none, as a sharding constraint does.
    """
    if into is None:
        return grads
    ctx = current_ctx()
    if ctx is None or not has_devices(ctx.mesh):
        raise ValueError("constrain_params(into=...) reduces into shards on a DeviceMesh: "
                         "call it under use_ctx(make_ctx(mesh)) with one")
    for name, g in grads.items():
        if isinstance(g, torch.Tensor):
            into[name].add_(g)
        else:
            for region, block in g:
                into[name].add_region_(block, region)
    return into


# ---------------------------------------------------------------------------
# Parameter sharding rules (by leaf name).
#
# Conventions: 2D weights are sharded (fsdp, tp) with the contracting /
# row dim on fsdp and the output/column dim on tp (Megatron column-parallel)
# or flipped for the second matmul (row-parallel) so activations come back
# with a single all-reduce.  MoE experts put the expert dim on tp (EP).
# A leaf stacked over layers (rank one higher than its rule) leaves the
# stacking dim unsharded; the port keeps one leaf a layer, so its leaves
# take the rule as it stands.
# ---------------------------------------------------------------------------

_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    # attention
    ("wq", ("fsdp", "tp")),
    ("wk", ("fsdp", "tp")),
    ("wv", ("fsdp", "tp")),
    ("wo", ("tp", "fsdp")),
    ("bq", ("tp",)),
    ("bk", ("tp",)),
    ("bv", ("tp",)),
    # dense mlp
    ("w_gate", ("fsdp", "tp")),
    ("w_in", ("fsdp", "tp")),
    ("w_out", ("tp", "fsdp")),
    # moe — training layout: experts over tp, rows FSDP over data; the
    # inference layout (_EXPERT_INFERENCE) keeps experts stationary on data
    ("router", ("fsdp", None)),
    ("e_gate", ("tp", "fsdp", None)),
    ("e_in", ("tp", "fsdp", None)),
    ("e_out", ("tp", None, "fsdp")),
    # embeddings / head
    ("embed", ("tp", "fsdp")),
    ("lm_head", ("fsdp", "tp")),
    # recurrent blocks: route big matrices like mlp, vectors replicated
    ("w_x", ("fsdp", "tp")),
    ("w_gate_branch", ("fsdp", "tp")),
    ("w_rnn_out", ("tp", "fsdp")),
    ("wi", ("fsdp", "tp")),
    ("wf", ("fsdp", "tp")),
    ("wz", ("fsdp", "tp")),
    ("wo_gate", ("fsdp", "tp")),
    ("up", ("fsdp", "tp")),
    ("down", ("tp", "fsdp")),
]


_EXPERT_LEAVES = ("e_gate", "e_in", "e_out")
# inference layout: experts stationary on the data axis, hidden on tp
_EXPERT_INFERENCE = {
    "e_gate": ("fsdp", None, "tp"),
    "e_in": ("fsdp", None, "tp"),
    "e_out": ("fsdp", "tp", None),
}


def param_spec(path: tuple[str, ...], ndim: int, *, inference: bool = False) -> Spec:
    """Logical spec of a parameter leaf, given its path and rank.

    The rule matches the last path component; a leading stacked-layer dim
    (rank one higher than the rule) is left unsharded.

    ``inference=True`` drops the fsdp axis from dense weights (decode pays a
    per-layer all-gather per token otherwise); expert leaves keep it (there
    fsdp shards the expert dim, which is stationary under all-to-all
    dispatch).
    """
    name = path[-1]
    for key, axes in _RULES:
        if name == key:
            if inference:
                if name in _EXPERT_LEAVES:
                    axes = _EXPERT_INFERENCE[name]
                else:
                    axes = tuple(None if a == "fsdp" else a for a in axes)
            if ndim == len(axes):
                return tuple(axes)
            if ndim == len(axes) + 1:  # stacked for scan
                return (None, *axes)
            break
    # norms, biases, gates, small vectors: replicated (possibly stacked)
    return (None,) * ndim


def param_shardings(model_or_named_leaves, mesh: MeshShape, ctx: ShardCtx, *,
                    inference: bool = False) -> dict[str, Spec]:
    """``{dotted parameter name: mesh spec}`` for a model (anything with
    ``named_parameters``, such as ``lm.CausalLM`` on ``meta``) or a
    ``{name: tensor}`` dict.  The port's names end in the reference's leaf
    names (``blocks.3.attn.wq``)."""
    leaves = model_or_named_leaves
    if hasattr(leaves, "named_parameters"):
        leaves = dict(leaves.named_parameters())
    return {name: rule_spec(name, tuple(t.shape), ctx, mesh, inference=inference)
            for name, t in leaves.items()}


def rule_spec(name: str, shape: tuple[int, ...], ctx: ShardCtx, mesh: MeshShape | None = None,
              *, inference: bool = False) -> Spec:
    """The mesh spec the rules give the leaf ``name`` (dotted) of ``shape``
    under ``ctx``, sanitized against ``mesh`` (by default the ctx's)."""
    logical = param_spec(tuple(name.split(".")), len(shape), inference=inference)
    resolved = tuple(ctx.resolve(a) if isinstance(a, str) else a for a in logical)
    return sanitize_spec(resolved, tuple(shape), ctx.mesh if mesh is None else mesh)


def cache_spec(name: str, shape: tuple[int, ...], ctx: ShardCtx, *, long: bool = False) -> Spec:
    """The reference's ``_cache_shardings`` rule (``src/repro/launch/dryrun.py:
    83-108``) for one layer's decode-cache leaf ``name`` of global ``shape``,
    sanitized: k and v ``(dp, tp, None, None)``, their time axis over the
    tensor-parallel axes (``long``: over every mesh axis, the reference's
    ``long_500k``); the recurrent and xLSTM states' channels over tp."""
    seq_axes = tuple(ctx.mesh.axis_names) if long else ctx.tp
    base, dp = len(shape), ctx.dp
    if name in ("k", "v") and base == 4:
        spec = (dp, seq_axes, None, None)
    elif name == "conv" and base == 3:
        spec = (dp, None, ctx.tp)
    elif name == "c" and base == 4:  # mlstm matrix memory
        spec = (dp, None, ctx.tp, None)
    elif name == "n" and base == 3:
        spec = (dp, None, ctx.tp)
    elif name in ("h", "c", "n", "m") and base == 2:
        spec = (dp, ctx.tp)
    else:
        spec = (None,) * base
    return sanitize_spec(spec, shape, ctx.mesh)


# ---------------------------------------------------------------------------
# Placement over a DeviceMesh (launch/mesh.py): one local tensor a position.
# ---------------------------------------------------------------------------


def has_devices(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (a ``MeshShape`` with devices)."""
    return getattr(mesh, "devices", None) is not None


def _require_devices(mesh) -> None:
    if not has_devices(mesh):
        raise ValueError(f"{type(mesh).__name__} {mesh.shape} has no devices: place values on a "
                         "launch.mesh.DeviceMesh")


def coords(mesh: MeshShape, pos: int) -> tuple[int, ...]:
    """Position ``pos``'s index along each axis (row-major)."""
    return tuple(int(i) for i in _unravel(pos, mesh.sizes))


def _unravel(pos: int, sizes) -> list[int]:
    out = []
    for n in reversed(sizes):
        out.append(pos % n)
        pos //= n
    return out[::-1]


def position(mesh: MeshShape, index: dict[str, int]) -> int:
    """The position at ``{axis: index}`` (axes left out at 0)."""
    pos = 0
    for name, n in zip(mesh.axis_names, mesh.sizes):
        pos = pos * n + index.get(name, 0)
    return pos


def _entry_index(mesh: MeshShape, at: dict[str, int], entry) -> int:
    """The block a position holds along a dim laid out over ``entry``."""
    if entry is None:
        return 0
    idx = 0
    for a in (entry,) if isinstance(entry, str) else entry:
        idx = idx * mesh.shape[a] + at[a]
    return idx


def axis_group(mesh: MeshShape, pos: int, axes) -> list[int]:
    """The positions that differ from ``pos`` along ``axes`` (an axis name or
    a tuple of them) alone, in row-major order over ``axes``, the first axis
    the major one (``pos`` among them)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no axis {a!r}")
    at = dict(zip(mesh.axis_names, coords(mesh, pos)))
    return [position(mesh, {**at, **dict(zip(axes, combo))})
            for combo in itertools.product(*(range(mesh.shape[a]) for a in axes))]


def tp_axes(ctx: ShardCtx) -> tuple[str, ...]:
    """The ctx's tensor-parallel axes as a tuple (empty without any)."""
    return () if ctx.tp is None else (ctx.tp,) if isinstance(ctx.tp, str) else tuple(ctx.tp)


def tp_peers(ctx: ShardCtx, lead: int) -> list[int]:
    """A data-parallel group's positions: ``lead`` and its peers along the
    ctx's tensor-parallel axes, in the order of the tensor-parallel index
    (a dim laid out over those axes puts its ``t``-th block on the
    ``t``-th)."""
    return axis_group(ctx.mesh, lead, tp_axes(ctx))


def dp_leads(ctx: ShardCtx) -> list[int]:
    """The lead position of each data-parallel group of ``ctx``, in the
    order of the batch's blocks over the dp axes: the group's index along
    them, every other axis at 0.  One group (position 0) when ``ctx.dp`` is
    empty, as under ``make_decode_2d_ctx``."""
    mesh = ctx.mesh
    return [position(mesh, dict(zip(ctx.dp, combo)))
            for combo in itertools.product(*(range(mesh.shape[a]) for a in ctx.dp))]


@dataclasses.dataclass(eq=False)
class Sharded:
    """A tensor of global ``shape`` and ``dtype`` laid out over a
    ``DeviceMesh`` by ``spec`` (sanitized): ``shards[p]`` is position ``p``'s
    local tensor, of :func:`shard_shape`, on ``mesh.devices[p]``.  A dim
    the spec leaves whole is copied to every position, so positions that
    hold the same block hold equal tensors."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: Spec
    mesh: MeshShape
    shards: list

    def __post_init__(self) -> None:
        _require_devices(self.mesh)
        if len(self.shards) != self.mesh.size:
            raise ValueError(f"{len(self.shards)} shards for {self.mesh.size} positions")
        local = shard_shape(self.shape, self.spec, self.mesh)
        entries = list(self.spec) + [None] * (len(self.shape) - len(self.spec))
        self.slices, blocks = [], {}
        for pos in range(self.mesh.size):
            at = dict(zip(self.mesh.axis_names, coords(self.mesh, pos)))
            idx = tuple(_entry_index(self.mesh, at, e) for e in entries)
            self.slices.append(tuple(slice(i * n, (i + 1) * n) for i, n in zip(idx, local)))
            blocks.setdefault(idx, pos)
        # the first position holding each distinct block, in position order
        self.owners = sorted(blocks.values())

    def zeros(self, dtype: torch.dtype | None = None) -> Sharded:
        """Zeros of this layout (in ``dtype``, by default this one's)."""
        dtype = dtype or self.dtype
        return dataclasses.replace(self, dtype=dtype, shards=[
            torch.zeros(s.shape, dtype=dtype, device=s.device) for s in self.shards])

    @torch.no_grad()
    def add_(self, full: torch.Tensor) -> Sharded:
        """Add the whole tensor ``full`` in place: each position adds its
        slice, copied to its device, in this value's dtype."""
        if tuple(full.shape) != self.shape:
            raise ValueError(f"adding {tuple(full.shape)} to a sharded {self.shape}")
        return self.add_region_(full, whole(self.shape))

    @torch.no_grad()
    def add_region_(self, block: torch.Tensor, region: tuple) -> Sharded:
        """Add ``block``, this tensor's ``region`` (a slice a dim, as
        :func:`gather_region` takes it), in place: each position adds the
        part of ``block`` that falls in its shard, copied to its device, in
        this value's dtype; a position whose shard lies outside the region
        adds nothing."""
        if tuple(block.shape) != region_shape(region):
            raise ValueError(f"a block {tuple(block.shape)} for a region {region_shape(region)}")
        for s, sl in zip(self.shards, self.slices):
            cut = _intersect(sl, region)
            if cut is not None:
                s[_within(cut, sl)].add_(block[_within(cut, region)].to(s.device))
        return self


@torch.no_grad()
def shard(t: torch.Tensor, spec: Spec, mesh: MeshShape) -> Sharded:
    """``t`` laid out over the ``DeviceMesh`` ``mesh`` by ``spec`` (sanitized
    against ``t``'s shape first): each position's block copied to its
    device, in an allocation of its own."""
    _require_devices(mesh)
    spec = sanitize_spec(tuple(spec), tuple(t.shape), mesh)
    local = shard_shape(tuple(t.shape), spec, mesh)
    x = Sharded(tuple(t.shape), t.dtype, spec, mesh, [None] * mesh.size)
    x.shards = [torch.empty(local, dtype=t.dtype, device=d).copy_(t[sl])
                for d, sl in zip(mesh.devices, x.slices)]
    return x


def whole(shape) -> tuple:
    """The region that covers a tensor of ``shape``."""
    return tuple(slice(0, n) for n in shape)


def region_shape(region: tuple) -> tuple[int, ...]:
    return tuple(r.stop - r.start for r in region)


def _intersect(a: tuple, b: tuple):
    """The region both ``a`` and ``b`` cover, or None."""
    out = tuple(slice(max(x.start, y.start), min(x.stop, y.stop)) for x, y in zip(a, b))
    return None if any(r.start >= r.stop for r in out) else out


def _within(region: tuple, outer: tuple) -> tuple:
    """``region`` in the coordinates of ``outer``'s first element."""
    return tuple(slice(r.start - o.start, r.stop - o.start) for r, o in zip(region, outer))


# the bytes gather_region has copied onto each position, by position (read
# around a step; reset with .clear())
gathered_bytes: collections.Counter = collections.Counter()


@torch.no_grad()
def gather_region(x: Sharded, region: tuple, pos: int) -> torch.Tensor:
    """``region`` of the tensor (a slice a dim) on position ``pos``'s
    device, each piece copied from the first position that holds it: a
    tensor-parallel position's block of a weight, gathered over the fsdp
    axis alone, or with :func:`whole` the whole leaf.  The bytes copied
    count in :data:`gathered_bytes` under ``pos``."""
    out = torch.empty(region_shape(region), dtype=x.dtype, device=x.mesh.devices[pos])
    for owner in x.owners:
        sl = x.slices[owner]
        cut = _intersect(sl, region)
        if cut is not None:
            out[_within(cut, region)].copy_(x.shards[owner][_within(cut, sl)])
    gathered_bytes[pos] += out.numel() * out.element_size()
    return out


def bind_region(x: Sharded, region: tuple, pos: int) -> torch.Tensor:
    """``region`` of the tensor on position ``pos``'s device for a read-only
    step (decode): the position's own shard itself where the region is
    exactly the block it holds (no copy, nothing counted in
    :data:`gathered_bytes`), else :func:`gather_region`'s copy."""
    if tuple(region) == x.slices[pos]:
        return x.shards[pos]
    return gather_region(x, region, pos)


@torch.no_grad()
def gather(x: Sharded, device) -> torch.Tensor:
    """The whole tensor on ``device``, bit for bit: each distinct block copied
    once from the first position that holds it."""
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    for pos in x.owners:
        out[x.slices[pos]].copy_(x.shards[pos])
    return out


@dataclasses.dataclass(eq=False)
class PlacedModel:
    """A model's parameters placed over a ``DeviceMesh``: ``leaves`` maps each
    dotted parameter name (the model's ``named_parameters`` order) to its
    :class:`Sharded` value.  ``models/lm.py`` runs it block by block
    (``train_step``, ``decode_step``)."""

    cfg: object
    leaves: dict

    @property
    def mesh(self) -> MeshShape:
        return next(iter(self.leaves.values())).mesh

    def named_parameters(self):
        return self.leaves.items()


def place(tree, mesh: MeshShape, ctx: ShardCtx, *, inference: bool = False):
    """Lay a model or a training state out over the ``DeviceMesh`` ``mesh`` by
    :func:`param_shardings`, leaf by leaf (the reference's
    ``jax.device_put(state, param_shardings(...))``).

    * a model (``named_parameters`` and ``cfg``): a :class:`PlacedModel`;
    * a training state (a dataclass with ``params`` and ``opt``): the same
      dataclass with the placed model, m and v laid out as their parameters
      and the step counter on every position;
    * ``{name: tensor}``: ``{name: Sharded}`` by the parameter rules.
    """
    _require_devices(mesh)
    if ctx.mesh != mesh:
        raise ValueError("the ctx's mesh is not the mesh to place on")
    if isinstance(tree, nn.Module):
        specs = param_shardings(tree, mesh, ctx, inference=inference)
        return PlacedModel(tree.cfg, {n: shard(p, specs[n], mesh)
                                      for n, p in tree.named_parameters()})
    if dataclasses.is_dataclass(tree) and hasattr(tree, "params") and hasattr(tree, "opt"):
        params = place(tree.params, mesh, ctx, inference=inference)
        opt = {k: {n: shard(t, params.leaves[n].spec, mesh) for n, t in tree.opt[k].items()}
               for k in ("m", "v")}
        opt["step"] = shard(tree.opt["step"], (), mesh)
        return dataclasses.replace(tree, params=params, opt=opt)
    specs = param_shardings(tree, mesh, ctx, inference=inference)
    return {n: shard(t, specs[n], mesh) for n, t in tree.items()}


def sharded_leaves(tree) -> list[Sharded]:
    """Every :class:`Sharded` value in a placed model, a placed training
    state, or dicts and lists of them."""
    if isinstance(tree, Sharded):
        return [tree]
    if isinstance(tree, PlacedModel):
        return list(tree.leaves.values())
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in sharded_leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in sharded_leaves(sub)]
    return []


def position_bytes(tree) -> list[int]:
    """Bytes each position of the mesh holds of ``tree``'s sharded values."""
    leaves = sharded_leaves(tree)
    return [sum(x.shards[p].numel() * x.shards[p].element_size() for x in leaves)
            for p in range(leaves[0].mesh.size)] if leaves else []


def executor_ctx(mesh: MeshShape) -> ShardCtx:
    """The current ctx, which must be over ``mesh`` (a placed value runs under
    ``use_ctx(make_ctx(mesh))`` or ``make_decode_2d_ctx(mesh)``)."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh != mesh:
        raise ValueError("a value placed on a DeviceMesh runs under use_ctx(ctx) with a ctx over "
                         "that mesh")
    return ctx
