"""The port's ``distributed/sharding.py`` against the JAX package's, on the
CPU.

The JAX side runs on ``jax.sharding.AbstractMesh`` es (names and sizes, no
devices), so the test process keeps its one JAX device.  For all ten archs,
with ``inference`` off and on, on the 16 x 16 pod, the 2 x 16 x 16
multi-pod and the flat 2D decode ctx, every parameter's spec equals the
reference's (the reference stacks a period's repeats on a leading axis
that is never sharded: that axis is dropped before comparing) and the
per-device parameter bytes are equal.  ``make_ctx``, ``resolve``,
``spec``, ``sanitize_spec`` and ``tp_worthwhile`` agree on a grid;
``constrain`` returns its input under any ctx and raises only on an
unknown logical axis, and ``constrain_params`` is the identity outside a
ctx and under a ``MeshShape`` (the model's sharding over a ``DeviceMesh``
is ``tests/test_torch_model_sharding.py``'s).
"""

import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_debug_mesh,
    make_device_mesh,
    make_production_mesh,
)
from repro_torch.models import lm  # noqa: E402

MESHES = {
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
}
LAYOUTS = [(m, c) for m in MESHES for c in ("ctx", "decode_2d")]


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), sh.MeshShape(sizes, names)


def _ctxs(layout, jmesh, mesh):
    if layout == "decode_2d":
        return jsh.make_decode_2d_ctx(jmesh), sh.make_decode_2d_ctx(mesh)
    return jsh.make_ctx(jmesh), sh.make_ctx(mesh)


def _norm(entries) -> tuple:
    """A spec's entries with each as a tuple of axis names (None stays)."""
    out = []
    for e in entries:
        if e is None or e == ():
            out.append(None)
        else:
            out.append((e,) if isinstance(e, str) else tuple(e))
    return tuple(out)


@functools.cache
def _jax_params(arch):
    cfg = jax_config(arch)
    return jax.eval_shape(lambda: jlm.init_params(jax.random.key(0), cfg))


def _reference_specs(arch, jmesh, jctx, inference):
    """{port parameter name: (reference spec without the stacked axis,
    shape of one layer, per-device bytes of one layer)}."""
    cfg = jax_config(arch)
    struct = _jax_params(arch)
    shard = jsh.param_shardings(struct, jmesh, jctx, inference=inference)
    per = len(cfg.layer_pattern)
    out = {}
    for (path, leaf), (_, s) in zip(jax.tree_util.tree_flatten_with_path(struct)[0],
                                    jax.tree_util.tree_flatten_with_path(shard)[0]):
        keys = [getattr(k, "key", None) if hasattr(k, "key") else str(k.idx) for k in path]
        spec, shape = tuple(s.spec), tuple(leaf.shape)
        spec = spec + (None,) * (len(shape) - len(spec))
        per_dev = math.prod(s.shard_shape(shape)) * leaf.dtype.itemsize
        if keys[0] == "period":
            pos, rest = int(keys[1]), ".".join(keys[2:])
            assert spec[0] is None  # the stacking axis is never sharded
            for rep in range(cfg.repeats):
                out[f"blocks.{rep * per + pos}.{rest}"] = (
                    _norm(spec[1:]), shape[1:], per_dev // cfg.repeats)
        elif keys[0] == "tail":
            out[f"blocks.{cfg.repeats * per + int(keys[1])}.{'.'.join(keys[2:])}"] = (
                _norm(spec), shape, per_dev)
        else:
            out[".".join(keys)] = (_norm(spec), shape, per_dev)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_name,layout", LAYOUTS)
def test_param_specs_and_bytes_equal_the_reference(arch, mesh_name, layout):
    jmesh, mesh = _meshes(mesh_name)
    jctx, ctx = _ctxs(layout, jmesh, mesh)
    model = lm.CausalLM(get_config(arch), device="meta")
    params = dict(model.named_parameters())
    for inference in (False, True):
        want = _reference_specs(arch, jmesh, jctx, inference)
        got = sh.param_shardings(model, mesh, ctx, inference=inference)
        assert got.keys() == want.keys() == params.keys()
        total = 0
        for name, spec in got.items():
            ref_spec, shape, ref_bytes = want[name]
            assert tuple(params[name].shape) == shape, name
            assert _norm(spec) == ref_spec, (name, inference, spec, ref_spec)
            local = sh.shard_shape(shape, spec, mesh)
            assert math.prod(local) * params[name].element_size() == ref_bytes, name
            total += ref_bytes
        per_device = sum(math.prod(sh.shard_shape(tuple(p.shape), got[n], mesh))
                         * p.element_size() for n, p in params.items())
        assert per_device == total


def test_param_spec_rules_and_the_stacked_branch():
    assert [k for k, _ in sh._RULES] == [k for k, _ in jsh._RULES]
    assert sh._EXPERT_LEAVES == jsh._EXPERT_LEAVES
    assert sh._EXPERT_INFERENCE == jsh._EXPERT_INFERENCE
    for name, axes in sh._RULES:
        for inference in (False, True):
            for ndim in range(len(axes) - 1, len(axes) + 3):
                got = sh.param_spec(("blocks", "0", name), ndim, inference=inference)
                want = jsh.param_spec(("period", "0", name), ndim, inference=inference)
                assert got == tuple(want) + (None,) * (ndim - len(want)), (name, ndim)
    assert sh.param_spec(("wq",), 3) == (None, "fsdp", "tp")  # stacked: the scan dim free
    assert sh.param_spec(("final_norm",), 1) == (None,)


MESH_GRID = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
             ((4,), ("data",)), ((8,), ("x",)), ((2, 4), ("x", "model"))]
SHAPES = [(49155, 2048), (1, 128), (3584,), (28, 128), (16, 4096, 8, 128), (2, 3, 5), ()]


@pytest.mark.parametrize("sizes,names", MESH_GRID)
def test_ctx_resolve_spec_sanitize_and_tp_rule_agree(sizes, names):
    jmesh, mesh = AbstractMesh(sizes, names), sh.MeshShape(sizes, names)
    for seq_shard in (True, False):
        for jctx, ctx in ((jsh.make_ctx(jmesh, seq_shard=seq_shard),
                           sh.make_ctx(mesh, seq_shard=seq_shard)),
                          (jsh.make_decode_2d_ctx(jmesh), sh.make_decode_2d_ctx(mesh))):
            assert (ctx.dp, ctx.fsdp, ctx.tp, ctx.seq_shard) == (
                jctx.dp, jctx.fsdp, jctx.tp, jctx.seq_shard)
            for lg in (None, "dp", "fsdp", "tp", "seq"):
                assert ctx.resolve(lg) == jctx.resolve(lg)
            with pytest.raises(ValueError):
                ctx.resolve("pipeline")
            logical = ("dp", "seq", None, "tp")
            with jsh.use_ctx(jctx), sh.use_ctx(ctx):
                assert sh.current_ctx() is ctx
                assert _norm(sh.spec(*logical)) == _norm(jsh.spec(*logical))
                for x_shape in ((8, 4096, 2048), (1, 1, 18432), (256, 2048)):
                    for w in (10**6, 67 * 2**20, 3 * 10**9):
                        assert sh.tp_worthwhile(x_shape, w) == jsh.tp_worthwhile(x_shape, w)
            for shape in SHAPES:
                for entries in (("data", "model"), (("pod", "data"), None, "model"),
                                (tuple(names), None), (names[-1],) * 3):
                    entries = tuple(e for e in entries
                                    if e is None or set((e,) if isinstance(e, str) else e)
                                    <= set(names))[: len(shape)]
                    got = sh.sanitize_spec(entries, shape, mesh)
                    want = jsh.sanitize_spec(PartitionSpec(*entries), shape, jmesh)
                    assert _norm(got) == _norm(tuple(want) + (None,) * (len(got) - len(want)))
                    assert len(sh.shard_shape(shape, got, mesh)) == len(shape)
    assert sh.current_ctx() is None
    assert sh.spec("dp", "tp") == () and tuple(jsh.spec("dp", "tp")) == ()
    assert sh.tp_worthwhile((8, 4096, 2048), 10**12) is False


def test_sanitize_drops_exactly_the_reference_axes():
    mesh = sh.MeshShape((16, 16), ("data", "model"))
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    cases = [
        (("model", "data"), (49155, 2048)),  # a vocab of 49,155 rows
        ((None, "model", None), (1, 28, 128)),  # qwen2's 28 heads
        ((("data",), ("data", "model"), None, None), (1, 524288, 8, 128)),  # long_500k batch 1
    ]
    for entries, shape in cases:
        got = sh.sanitize_spec(entries, shape, mesh)
        assert _norm(got) == _norm(tuple(jsh.sanitize_spec(PartitionSpec(*entries), shape, jmesh)))
    assert sh.sanitize_spec(("model", "data"), (49155, 2048), mesh) == (None, "data")
    assert sh.sanitize_spec((None, "model", None), (1, 28, 128), mesh) == (None, None, None)
    assert sh.shard_shape((64, 2048), ("data", "model"), mesh) == (4, 128)
    with pytest.raises(ValueError, match="sanitize"):
        sh.shard_shape((28,), ("model",), mesh)


def test_constrain_is_the_identity_outside_a_ctx_and_on_one_device():
    x = torch.arange(6.0).reshape(2, 3)
    tree = {"a": x, "b": [x]}
    assert sh.constrain(x, "dp", "tp") is x
    assert sh.constrain_params(tree) is tree
    one = sh.MeshShape((1, 1), ("data", "model"))
    with sh.use_ctx(sh.make_ctx(one)):
        assert sh.constrain(x, "dp", None) is x
        assert sh.constrain_params(tree) is tree
    # a constraint changes no value under a mesh of any size, with devices or
    # without; an unknown logical axis still raises
    device_mesh = make_device_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    for mesh in (make_production_mesh(), make_production_mesh(multi_pod=True), make_debug_mesh(2),
                 device_mesh):
        with sh.use_ctx(sh.make_ctx(mesh)):
            assert sh.constrain(x, "dp", "tp") is x
            with pytest.raises(ValueError, match="unknown logical axis"):
                sh.constrain(x, "dp", "experts")
            assert sh.constrain_params(tree) is tree
        assert sh.constrain(x) is x  # the ctx is gone again


def test_production_and_debug_meshes():
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (pod.sizes, pod.axis_names, pod.size) == ((16, 16), ("data", "model"), 256)
    assert (multi.sizes, multi.axis_names, multi.size) == ((2, 16, 16), ("pod", "data", "model"),
                                                           512)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert make_debug_mesh(8).shape == {"data": 2, "model": 4}
    assert make_debug_mesh(6).shape == {"data": 3, "model": 2}
    assert make_debug_mesh(3).shape == {"data": 3, "model": 1}
    assert make_debug_mesh().size >= 1
    with pytest.raises(ValueError):
        sh.MeshShape((16, 16), ("data",))
    np.testing.assert_equal(sh.make_ctx(pod).dp, ("data",))
    assert sh.make_ctx(multi).dp == ("pod", "data")
