"""Sharding rules: logical axes -> mesh axes, parameter rules, activation
constraints.

The JAX package's ``distributed/sharding.py``, with its rules kept as data.
Model code there asks for logical axes ("dp", "tp", "fsdp", "seq") through
a context, and GSPMD applies the resulting specs.  The port has no GSPMD
and runs on one card, so here the rules feed accounting: the dry-run
(``launch/dryrun.py``) reads per-device shapes off them on the production
meshes, with tensors on ``meta``.  The port's models call no constraint;
``constrain`` and ``constrain_params`` are the identity outside a context
and under a one-device mesh, and raise under a larger one, where the model
would have to be sharded over several cards (ROADMAP.md queue 1, item 5).

Two types stand in for JAX's:
  * a mesh is a :class:`MeshShape`: axis names and sizes, no devices
    (what the reference reads through ``mesh.shape[...]`` and
    ``mesh.axis_names``);
  * a spec is a plain tuple with one entry per dim: ``None``, an axis name
    or a tuple of names (the reference's ``PartitionSpec``).

Default production mapping (DESIGN.md §6):
  dp    = ("pod", "data")   batch parallel (pods are pure DP)
  fsdp  = "data"            parameter/optimizer sharding (intra-pod)
  tp    = "model"           tensor parallel (heads / ff columns / vocab / EP)
  seq   = "model"           sequence parallelism on the residual stream
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

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


def _multi_device(ctx: ShardCtx) -> None:
    if ctx.mesh.size > 1:
        raise NotImplementedError(
            f"a sharding constraint on a {ctx.mesh.size}-device mesh needs a model sharded over "
            "several cards, which is not ported yet (ROADMAP.md queue 1, item 5)"
        )


def constrain(x, *logical: str | None):
    """The identity outside a ctx and under a one-device mesh; raises under a
    larger mesh (the reference's ``with_sharding_constraint`` has no
    counterpart without GSPMD)."""
    ctx = current_ctx()
    if ctx is not None:
        _multi_device(ctx)
    return x


def tp_worthwhile(x_shape: tuple[int, ...], w_elems: int) -> bool:
    """Should a layer force Megatron TP sharding on its activations?

    The reference's napkin rule: constrain iff the layer's weight elements
    exceed 2x the per-device activation elements.  False outside a ctx.
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


def constrain_params(tree):
    """The identity outside a ctx and under a one-device mesh; raises under a
    larger mesh, as :func:`constrain`."""
    ctx = current_ctx()
    if ctx is not None:
        _multi_device(ctx)
    return tree


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
    out = {}
    for name, t in leaves.items():
        logical = param_spec(tuple(name.split(".")), t.ndim, inference=inference)
        resolved = tuple(ctx.resolve(a) if isinstance(a, str) else a for a in logical)
        out[name] = sanitize_spec(resolved, tuple(t.shape), mesh)
    return out
