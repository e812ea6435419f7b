"""The port's ``core/state.py`` against the JAX package's, function by function.

The same seeded numpy inputs go through both packages; every table, flag
and payload result must match bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import state as jst  # noqa: E402
from repro_torch.core import state as tst  # noqa: E402

CPU = "cpu"


def _pair(n_regions=2, slots=16, n_blocks=24, block_shape=(3, 4), seed=0, placement=None):
    """Equal states in both packages, with random payload and random flags."""
    rng = np.random.default_rng(seed)
    if placement is None:
        placement = rng.integers(0, n_regions, size=n_blocks).astype(np.int32)
    jcfg = jst.PoolConfig(n_regions, slots, block_shape)
    tcfg = tst.PoolConfig(n_regions, slots, block_shape)
    js = jst.init_state(jcfg, n_blocks, placement)
    pool = rng.normal(size=np.asarray(js.pool).shape).astype(np.float32)
    dirty = rng.random(n_blocks) < 0.3
    in_flight = rng.random(n_blocks) < 0.5
    js = jst.LeapState(jnp.asarray(pool), js.table, jnp.asarray(dirty), jnp.asarray(in_flight))
    ts = tst.init_state(tcfg, n_blocks, placement, device=CPU)
    ts = tst.LeapState.from_numpy(pool, ts.table.numpy(), dirty, in_flight, CPU)
    return jcfg, tcfg, js, ts, rng


def _assert_same(js, ts):
    jpool, jtable, jdirty, jflight = (np.asarray(x) for x in (js.pool, js.table, js.dirty, js.in_flight))
    tpool, ttable, tdirty, tflight = ts.to_numpy()
    np.testing.assert_array_equal(tpool, jpool)
    np.testing.assert_array_equal(ttable, jtable)
    np.testing.assert_array_equal(tdirty, jdirty)
    np.testing.assert_array_equal(tflight, jflight)
    assert ttable.dtype == np.int32


@pytest.mark.parametrize(
    "placement",
    [
        np.zeros(24, np.int32),
        np.arange(24, dtype=np.int32) % 3,
        np.random.default_rng(5).integers(0, 3, size=24).astype(np.int32),
    ],
)
def test_init_state_matches_jax(placement):
    jcfg = jst.PoolConfig(3, 24, (2, 8))
    tcfg = tst.PoolConfig(3, 24, (2, 8))
    js = jst.init_state(jcfg, 24, placement)
    ts = tst.init_state(tcfg, 24, placement, device=CPU)
    _assert_same(js, ts)
    assert ts.pool.dtype == torch.float32 and ts.n_blocks == 24
    assert tcfg.block_bytes == jcfg.block_bytes
    assert tcfg.capacity_blocks == jcfg.capacity_blocks
    np.testing.assert_array_equal(
        tst.placement_histogram(ts, 3), jst.placement_histogram(js, 3)
    )


def test_init_state_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device, so the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.init_state(tst.PoolConfig(2, 8, (4,)), 4, np.zeros(4, np.int32))


@pytest.mark.parametrize(
    "kwargs, n_blocks, placement",
    [
        (dict(n_regions=2, slots_per_region=4, block_shape=(2,)), 9, np.zeros(9)),
        (dict(n_regions=2, slots_per_region=4, block_shape=(2,)), 6, np.zeros(6)),
        (dict(n_regions=2, slots_per_region=4, block_shape=(2,)), 3, [0, 1, 2]),
        (dict(n_regions=2, slots_per_region=4, block_shape=(2,)), 3, [0, 1]),
    ],
)
def test_init_state_rejects_what_jax_rejects(kwargs, n_blocks, placement):
    with pytest.raises(ValueError):
        jst.init_state(jst.PoolConfig(**kwargs), n_blocks, placement)
    with pytest.raises(ValueError):
        tst.init_state(tst.PoolConfig(**kwargs), n_blocks, placement, device=CPU)


def test_pool_config_validation_matches_jax():
    for bad in (dict(huge_factor=3), dict(huge_factor=16)):
        with pytest.raises(ValueError):
            jst.PoolConfig(2, 8, (4,), **bad)
        with pytest.raises(ValueError):
            tst.PoolConfig(2, 8, (4,), **bad)
    assert tst.PoolConfig(2, 8, (4,), dtype=torch.bfloat16).block_bytes == 8


def test_read_write_script_matches_jax():
    """leap_write / leap_write_rows / leap_read / block_regions, chained."""
    _, _, js, ts, rng = _pair(seed=1)
    for step in range(6):
        ids = rng.choice(24, size=5, replace=False)
        if step % 2:
            vals = rng.normal(size=(5, 3, 4)).astype(np.float32)
            js = jst.leap_write(js, jnp.asarray(ids), jnp.asarray(vals))
            ts = tst.leap_write(ts, ids, vals)
        else:
            offs = rng.integers(0, 3, size=5)
            rows = rng.normal(size=(5, 4)).astype(np.float32)
            js = jst.leap_write_rows(js, jnp.asarray(ids), jnp.asarray(offs), jnp.asarray(rows))
            ts = tst.leap_write_rows(ts, ids, offs, torch.from_numpy(rows))
        _assert_same(js, ts)
        read = rng.integers(0, 24, size=7)  # duplicates allowed on reads
        np.testing.assert_array_equal(
            tst.leap_read(ts, read).numpy(), np.asarray(jst.leap_read(js, jnp.asarray(read)))
        )
        np.testing.assert_array_equal(
            tst.block_regions(ts, torch.from_numpy(read)).numpy(),
            np.asarray(jst.block_regions(js, jnp.asarray(read))),
        )


def test_group_views_match_jax():
    G = 4
    placement = np.repeat(np.array([0, 1, 1, 0, 1, 0], np.int32), G)
    _, _, js, ts, _ = _pair(slots=16, n_blocks=24, placement=placement, seed=2)
    groups = np.array([0, 2, 5, 1])
    np.testing.assert_array_equal(
        tst.huge_read(ts, groups, G).numpy(), np.asarray(jst.huge_read(js, jnp.asarray(groups), G))
    )
    np.testing.assert_array_equal(
        tst.group_dirty(ts, groups, G).numpy(), np.asarray(jst.group_dirty(js, jnp.asarray(groups), G))
    )
    np.testing.assert_array_equal(
        tst.group_in_flight(ts, groups, G).numpy(),
        np.asarray(jst.group_in_flight(js, jnp.asarray(groups), G)),
    )


@pytest.mark.parametrize("block_shape", [(4,), (3, 4), (2, 3, 4), ()])
def test_flat_pool_view_matches_jax_and_aliases_the_pool(block_shape):
    pool = np.arange(2 * 5 * int(np.prod(block_shape)), dtype=np.float32).reshape(
        (2, 5) + block_shape
    )
    tflat = tst.flat_pool_view(torch.from_numpy(pool.copy()))
    jflat = jst.flat_pool_view(jnp.asarray(pool))
    assert tuple(tflat.shape) == tuple(jflat.shape)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    base = torch.from_numpy(pool.copy())
    tst.flat_pool_view(base)[7] = -1.0  # in place: lands at region 1, slot 2
    assert (base[1, 2] == -1.0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_from_numpy_round_trips_jax_state(dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}[dtype]
    cfg = jst.PoolConfig(2, 8, (2, 4), dtype=jdt)
    js = jst.init_state(cfg, 10, np.arange(10) % 2)
    vals = np.random.default_rng(3).normal(size=(10, 2, 4)) * 50
    js = jst.leap_write(js, jnp.arange(10), jnp.asarray(vals, jdt))
    leaves = [np.asarray(x) for x in (js.pool, js.table, js.dirty, js.in_flight)]
    ts = tst.LeapState.from_numpy(*leaves, device=CPU)
    assert ts.pool.dtype == getattr(torch, dtype)
    pool, table, dirty, in_flight = ts.to_numpy()
    np.testing.assert_array_equal(pool, leaves[0].astype(pool.dtype))
    np.testing.assert_array_equal(table, leaves[1])
    np.testing.assert_array_equal(dirty, leaves[2])
    np.testing.assert_array_equal(in_flight, leaves[3])
