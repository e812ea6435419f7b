"""The port's ``distributed/collectives.py`` against the JAX package's, on
the CPU: the int8 payload, the scale and the round trip bit for bit on
seeded float32 and bfloat16 leaves, ties at .5 included (both round half
to even); with a mesh axis the mean over the axis of a ``DeviceMesh``,
and an axis the mesh lacks raises.
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
