"""The port's ``distributed/collectives.py`` against the JAX package's, on
the CPU: the int8 payload, the scale and the round trip bit for bit on
seeded float32 and bfloat16 leaves, ties at .5 included (both round half
to even); with a mesh axis the mean over the axis of a ``DeviceMesh``,
and an axis the mesh lacks raises.  Sequence parallelism's pair:
``reduce_scatter`` and ``split`` pass ``gradcheck`` in f64 (each one's
backward is the other half of the pair), and a reduce-scatter equals the
all-reduce followed by a slice, bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import collectives as jcol  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_device_mesh  # noqa: E402


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _ties(dtype) -> np.ndarray:
    """A leaf whose largest magnitude is 127, so x / scale lands on .5 exactly."""
    x = np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, 0.0], np.float32)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_round_trip_are_bit_exact(dtype, seed):
    rng = np.random.default_rng(seed)
    leaves = [(rng.normal(size=(64, 48)) * 10.0 ** (seed - 1)).astype(dtype),
              rng.standard_t(2, size=(513,)).astype(dtype), _ties(dtype)]
    for x in leaves:
        q, s = col.quantize_int8(_torch(x))
        jq, js = jcol.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        back = col.dequantize_int8(q, s, _torch(x).dtype)
        jback = jcol.dequantize_int8(jq, js, jnp.asarray(x).dtype)
        np.testing.assert_array_equal(_bits(back), _bits(jback))
    tie_q, _ = col.quantize_int8(_torch(_ties(dtype)))
    assert tie_q.tolist()[2:10] == [0, 2, 2, 0, -2, -2, 4, 126]  # half to even


def test_quantized_mean_over_a_tree_matches_and_keeps_dtypes():
    rng = np.random.default_rng(3)
    tree = {"w_in": rng.normal(size=(64, 64)).astype(np.float32),
            "blocks": [{"wq": rng.normal(size=(8, 16)).astype(ml_dtypes.bfloat16)},
                       {"wq": np.zeros((4,), np.float32)}]}
    jgot = jcol.quantized_mean({"w_in": jnp.asarray(tree["w_in"]),
                                "blocks": [{"wq": jnp.asarray(b["wq"])} for b in tree["blocks"]]})
    got = col.quantized_mean({"w_in": _torch(tree["w_in"]),
                              "blocks": [{"wq": _torch(b["wq"])} for b in tree["blocks"]]})
    np.testing.assert_array_equal(_bits(got["w_in"]), _bits(jgot["w_in"]))
    for g, j in zip(got["blocks"], jgot["blocks"]):
        assert g["wq"].dtype == _torch(np.asarray(j["wq"])).dtype
        np.testing.assert_array_equal(_bits(g["wq"]), _bits(j["wq"]))
    # tests/test_train.py's bound on the round trip's error holds here too
    w = torch.from_numpy(tree["w_in"])
    assert float((got["w_in"] - w).norm() / w.norm()) < 0.01


def test_a_mesh_axis_raises_naming_the_roadmap():
    """With ``axis_name`` the mean is taken over that axis of the ctx's
    ``DeviceMesh`` (``tests/test_torch_model_sharding.py`` holds it against
    the reference's ``shard_map``); an axis the mesh lacks raises."""
    mesh = make_device_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    x = sh.shard(torch.tensor([[1.0, -2.0], [4.0, 8.0]]), ("data", "model"), mesh)
    with sh.use_ctx(sh.make_ctx(mesh)):
        got = col.quantized_mean({"w": x}, axis_name="data")["w"]
        with pytest.raises(ValueError, match="no axis 'pod'"):
            col.quantized_mean({"w": x}, axis_name="pod")
    # each position gets the mean of its column's two round trips
    want = [col.quantized_mean(x.shards[p]) for p in range(4)]
    for pos in range(4):
        col_mean = (want[pos % 2] + want[2 + pos % 2]) / 2
        torch.testing.assert_close(got.shards[pos], col_mean, rtol=0, atol=1e-6)


def _group(n: int) -> col.Group:
    return col.Group(tuple(range(n)), (torch.device("cpu"),) * n)


@pytest.mark.parametrize("n,dim", [(2, 1), (4, 1), (3, 0)])
def test_reduce_scatter_and_split_pass_gradcheck(n, dim):
    gen = torch.Generator().manual_seed(n)
    shape = [2, 3]
    shape.insert(dim, 2 * n)
    parts = [torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
             for _ in range(n)]
    grp = _group(n)
    assert torch.autograd.gradcheck(lambda *ps: tuple(col.reduce_scatter(list(ps), grp, dim)),
                                    parts)
    assert torch.autograd.gradcheck(lambda x: tuple(col.split(x, grp, dim)), parts[:1])
    # split then all-gather is the identity; each slice an allocation of its own
    slices = col.split(parts[0], grp, dim)
    assert all(s.untyped_storage().data_ptr() != parts[0].untyped_storage().data_ptr()
               for s in slices)
    assert torch.equal(col.all_gather(slices, grp, dim), parts[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_reduce_scatter_is_the_all_reduce_sliced_bit_for_bit(dtype):
    """fp32 partial products of a row-parallel layer, four positions: each
    position's rows of the reduce-scatter equal the same rows of the
    all-reduce, cast once to ``dtype``; counted once each."""
    gen = torch.Generator().manual_seed(7)
    parts = [torch.randn(2, 16, 8, generator=gen) * 10.0 ** k for k in range(4)]
    grp = _group(4)
    col.counts.clear()
    whole = col.all_reduce(parts, grp, dtype)
    rows = col.reduce_scatter(parts, grp, dim=1, dtype=dtype)
    assert dict(col.counts) == {"all_reduce": 1, "reduce_scatter": 1}
    assert [tuple(r.shape) for r in rows] == [(2, 4, 8)] * 4 and rows[0].dtype == dtype
    for t, r in enumerate(rows):
        assert torch.equal(r, whole[:, 4 * t:4 * t + 4])
    with pytest.raises(ValueError, match="does not split over 3 positions"):
        col.reduce_scatter(parts[:3], _group(3), dim=1)
