"""The leap pool as one tensor per region on a region mesh, on the CPU.

A state placed on a :class:`repro_torch.core.RegionMesh`
(``state.to(state_sharding(cfg, mesh))``) holds its pool as one shard per
region, each in its own allocation on that region's device, even where the
regions share a device; the table and flags stay on the home device.  Here:

* (a) the JAX package's ``tests/test_multidevice.py`` scenario (a
  ``copy_chunk_ppermute`` from region 0 to region 5 of an 8-device mesh),
  grown by a batched ``fused_copy_ppermute`` epoch dirtied by a write, a
  ``force_areas`` and a ``zero_fill``: the JAX package on 8 host devices in
  a subprocess (``tests/conftest.py`` holds this process to one JAX
  device) against the port on 8 CPU shards; pool, table, flags, verdicts
  and reads bit for bit;
* (b) placement: one tensor a region with its own storage on the mesh's
  device, the same ``to_numpy()`` as the one-tensor state, a ``cpu`` +
  ``meta`` mesh, and the driver placing its state;
* (c) a Hypothesis property test of the application I/O programs on shards
  against the one-tensor pool (duplicate ids in a write, open epochs
  trapping writes), with equal variant counts;
* (d) ``force_areas``, ``force_migrate`` and ``zero_fill`` on shards against
  the one-tensor pool.

The xla backend's programs over shards: ``tests/test_torch_xla_shards.py``.
"""

import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from test_torch_driver import REPO  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.core import migrator  # noqa: E402
from repro_torch.core import state as tst  # noqa: E402

BLK = (2, 4)


def _placed(pc, state, devices=None):
    """``state`` on a region mesh of ``pc.n_regions`` regions (CPU shards by
    default)."""
    mesh = T.make_region_mesh(pc.n_regions, devices or ["cpu"] * pc.n_regions)
    return state.to(T.state_sharding(pc, mesh))


def _copy(state):
    """An independent one-tensor copy of ``state`` (``LeapState.to`` keeps
    the tensors already in place, so two placements would share a table)."""
    return T.LeapState.from_numpy(*state.to_numpy(), "cpu")


def _assert_same(a, b):
    for name, x, y in zip(("pool", "table", "dirty", "in_flight"), a.to_numpy(), b.to_numpy()):
        np.testing.assert_array_equal(x, y, err_msg=name)


# ---------------------------------------------------------------------------
# (a) the JAX package's 8-device ppermute scenario
# ---------------------------------------------------------------------------

R8, S8, N8 = 8, 4, 16
BLK8 = (2, 16)

# Runs in a fresh process with 8 host devices; writes every step's results.
JAX_SCENARIO = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
from repro.core import PoolConfig, init_state, leap_read, leap_write, migrator, state_sharding

data = np.load(sys.argv[1])
mesh = jax.make_mesh((8,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
cfg = PoolConfig(8, 4, (2, 16), region_axis="data")
state = jax.tree.map(jax.device_put, init_state(cfg, 16, np.repeat(np.arange(8), 2)),
                     state_sharding(cfg, mesh))
state = leap_write(state, jnp.arange(16), jnp.asarray(data["data"]))
out = {}
# the reference's scenario: blocks 0, 1 (region 0) to region 5, slots 2, 3
ids, slots = jnp.asarray([0, 1]), jnp.asarray([2, 3])
state = migrator.begin_area(state, ids)
state = migrator.copy_chunk_ppermute(state, ids, slots, 0, 5, "data", mesh)
state, out["verdict_chunk"] = migrator.commit_area(state, ids, slots, dst_region=5)
out["read_chunk"] = leap_read(state, ids)
# batched: blocks 2, 3 (region 1) to region 6, a write to block 3 in flight
ids = jnp.asarray([2, 3])
state = migrator.begin_areas(state, ids)
state = migrator.fused_copy_ppermute(state, jnp.asarray([0, 1]), jnp.asarray([2, 3]), 1, 6,
                                     "data", mesh)
state = leap_write(state, jnp.asarray([3]), jnp.asarray(data["write"]))
state, out["verdict_fused"] = migrator.commit_areas(state, ids, jnp.asarray([6, 6]),
                                                    jnp.asarray([2, 3]))
# forced: blocks 4 (region 2) and 9 (region 4) to regions 7 and 3, slot 3
state = migrator.force_areas(state, jnp.asarray([4, 9]), jnp.asarray([7, 3]),
                             jnp.asarray([3, 3]))
state = migrator.zero_fill(state, jnp.asarray([2]), 7)
for name in ("pool", "table", "dirty", "in_flight"):
    out[name] = getattr(state, name)
out["read_all"] = leap_read(state, jnp.arange(16))
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _port_scenario(data: dict) -> dict:
    pc = T.PoolConfig(R8, S8, BLK8, region_axis="data")
    mesh = T.make_region_mesh(R8, ["cpu"] * R8)
    state = T.init_state(pc, N8, np.repeat(np.arange(R8), 2), device="cpu").to(
        T.state_sharding(pc, mesh))
    assert state.sharded and len(state.pool) == R8
    T.leap_write(state, np.arange(N8), data["data"])
    out = {}
    ids, slots = torch.tensor([0, 1]), torch.tensor([2, 3])
    migrator.begin_area(state, ids)
    migrator.copy_chunk_ppermute(state, ids, slots, 0, 5, mesh)
    _, out["verdict_chunk"] = migrator.commit_area(state, ids, slots, 5)
    out["read_chunk"] = T.leap_read(state, ids)
    ids = torch.tensor([2, 3])
    migrator.begin_areas(state, ids)
    migrator.fused_copy_ppermute(state, torch.tensor([0, 1]), torch.tensor([2, 3]), 1, 6, mesh)
    T.leap_write(state, np.array([3]), data["write"])
    _, out["verdict_fused"] = migrator.commit_areas(state, ids, torch.tensor([6, 6]),
                                                    torch.tensor([2, 3]))
    migrator.force_areas(state, torch.tensor([4, 9]), torch.tensor([7, 3]), torch.tensor([3, 3]))
    migrator.zero_fill(state, torch.tensor([2]), 7)
    out.update(zip(("pool", "table", "dirty", "in_flight"), state.to_numpy()))
    out["read_all"] = T.leap_read(state, np.arange(N8))
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


def test_eight_region_ppermute_scenario_matches_jax_on_eight_devices(tmp_path):
    rng = np.random.default_rng(0)
    data = dict(data=rng.standard_normal((N8,) + BLK8, dtype=np.float32),
                write=rng.standard_normal((1,) + BLK8, dtype=np.float32))
    np.savez(tmp_path / "data.npz", **data)
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_SCENARIO), str(tmp_path / "data.npz"),
         str(tmp_path / "jax.npz")],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    want = dict(np.load(tmp_path / "jax.npz"))
    got = _port_scenario(data)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the reference's own checks, and the epoch the write dirtied
    assert not want["verdict_chunk"].any() and want["verdict_fused"].tolist() == [False, True]
    assert want["table"][:4].tolist() == [[5, 2], [5, 3], [6, 2], [1, 1]]
    np.testing.assert_array_equal(want["read_chunk"], data["data"][:2])


# ---------------------------------------------------------------------------
# (b) placement
# ---------------------------------------------------------------------------


def _state(pc, n, seed=0):
    rng = np.random.default_rng(seed)
    state = T.init_state(pc, n, rng.permutation(np.arange(n) % pc.n_regions), device="cpu")
    T.leap_write(state, np.arange(n), rng.normal(size=(n,) + pc.block_shape).astype(np.float32))
    return state


def test_placement_gives_one_tensor_a_region_in_its_own_storage():
    pc = T.PoolConfig(4, 8, BLK, region_axis="data")
    one = _state(pc, 20)
    mesh = T.make_region_mesh(4, ["cpu"] * 4)
    placed = _copy(one).to(T.state_sharding(pc, mesh))
    assert placed.sharded and not one.sharded
    assert len(placed.pool) == 4 and placed.pool_shape == one.pool_shape == (4, 8) + BLK
    storages = set()
    for r, shard in enumerate(placed.pool):
        assert shard.device == mesh.device(r)
        assert tuple(shard.shape) == (8 + 1,) + BLK  # the sink row
        assert shard.untyped_storage().nbytes() == shard.numel() * shard.element_size()
        storages.add(shard.untyped_storage().data_ptr())
    assert len(storages) == 4
    assert placed.device == placed.table.device == mesh.device(0)
    for a, b in zip(placed.to_numpy(), one.to_numpy()):
        np.testing.assert_array_equal(a, b)
    assert placed.to(T.state_sharding(pc, mesh)) is placed  # already placed: a no-op
    back = placed.to(T.LeapState(pool="cpu", table="cpu", dirty="cpu", in_flight="cpu"))
    assert not back.sharded
    for a, b in zip(back.to_numpy(), one.to_numpy()):
        np.testing.assert_array_equal(a, b)
    assert tst.state_key(placed) != tst.state_key(one)
    assert tst.state_tensors(placed)[:4] == list(placed.pool)


def test_a_cpu_and_meta_mesh_places_region_one_on_meta():
    pc = T.PoolConfig(2, 6, BLK, region_axis="data")
    state = _state(pc, 5).to(T.state_sharding(pc, T.make_region_mesh(2, ["cpu", "meta"])))
    assert [t.device.type for t in state.pool] == ["cpu", "meta"]
    assert tuple(state.pool[1].shape) == (7,) + BLK and state.pool[1].dtype == torch.float32
    assert state.devices == [torch.device("cpu"), torch.device("meta")]
    assert state.table.device.type == state.dirty.device.type == "cpu"
    with pytest.raises(ValueError, match="meta"):  # a driver needs data
        T.MigrationDriver(state, pc, T.LeapConfig(backend="ppermute", axis_name="data"),
                          mesh=T.make_region_mesh(2, ["cpu", "meta"]))


def test_the_driver_places_its_state_on_the_mesh():
    pc = T.PoolConfig(4, 8, BLK, region_axis="data")
    one = _state(pc, 20)
    want = one.to_numpy()
    drv = T.MigrationDriver(one, pc, T.LeapConfig(backend="ppermute", axis_name="data"),
                            mesh=T.make_region_mesh(4, ["cpu"] * 4))
    assert drv.state.sharded and not one.sharded
    for a, b in zip(drv.state.to_numpy(), want):
        np.testing.assert_array_equal(a, b)
    placed = drv.state
    again = T.MigrationDriver(placed, pc, T.LeapConfig(backend="ppermute", axis_name="data"),
                              mesh=T.make_region_mesh(4, ["cpu"] * 4))
    assert again.state is placed


# ---------------------------------------------------------------------------
# (c) the application I/O programs: shards against the one-tensor pool
# ---------------------------------------------------------------------------

G = 2  # huge factor of the group programs


def _two_tier_state(regions: int, runs: int, seed: int) -> T.LeapState:
    """Every group of ``G`` blocks on a ``G``-aligned run of one region, the
    runs shuffled over the regions; random payload and flags."""
    rng = np.random.default_rng(seed)
    slots = runs * G
    n = (regions * runs - 1) * G  # one run left free
    starts = rng.permutation(regions * runs)[: n // G]
    table = np.stack([np.repeat(starts // runs, G),
                      (np.repeat(starts % runs, G) * G + np.tile(np.arange(G), n // G))], 1)
    pool = rng.normal(size=(regions, slots) + BLK).astype(np.float32)
    return T.LeapState.from_numpy(pool, table.astype(np.int32), rng.random(n) < 0.3,
                                  rng.random(n) < 0.5, "cpu")


def _io_calls(state, calls):
    """Run ``calls`` on ``state``; return every result."""
    out = []
    for name, args in calls:
        fn = getattr(tst, name)
        res = fn(state, *args)
        out.append(None if res is state else res.clone())
    return out


def _io_sizes():
    return {name: len(prog) for name, prog in tst.IO_PROGRAMS.items()}


@st.composite
def _io_case(draw):
    regions = draw(st.integers(2, 4))
    runs = draw(st.integers(2, 4))
    seed = draw(st.integers(0, 2**16))
    n = (regions * runs - 1) * G
    ids = st.lists(st.integers(0, n - 1), min_size=1, max_size=6)
    groups = st.lists(st.integers(0, n // G - 1), min_size=1, max_size=3)
    calls = []
    for _ in range(draw(st.integers(1, 8))):
        kind = draw(st.sampled_from(["leap_read", "leap_write", "leap_write_rows",
                                     "block_regions", "huge_read", "group_dirty",
                                     "group_in_flight"]))
        if kind in ("huge_read", "group_dirty", "group_in_flight"):
            calls.append((kind, (np.array(draw(groups)), G)))
            continue
        k = np.array(draw(ids))  # duplicates allowed: the last one wins
        vals = np.random.default_rng(draw(st.integers(0, 2**16)))
        if kind == "leap_write":
            calls.append((kind, (k, vals.normal(size=(len(k),) + BLK).astype(np.float32))))
        elif kind == "leap_write_rows":
            calls.append((kind, (k, vals.integers(0, BLK[0], len(k)),
                                 vals.normal(size=(len(k), BLK[1])).astype(np.float32))))
        else:
            calls.append((kind, (k,)))
    return regions, runs, seed, calls


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_io_case())
def test_io_programs_on_shards_match_the_one_tensor_pool(case):
    regions, runs, seed, calls = case
    one = _two_tier_state(regions, runs, seed)
    pc = T.PoolConfig(regions, runs * G, BLK, region_axis="data", huge_factor=G)
    for prog in tst.IO_PROGRAMS.values():
        prog.clear()
    want = _io_calls(one, calls)
    sizes = _io_sizes()
    for prog in tst.IO_PROGRAMS.values():
        prog.clear()
    placed = _placed(pc, _two_tier_state(regions, runs, seed))
    got = _io_calls(placed, calls)
    assert _io_sizes() == sizes  # the same variants, keyed on the sharded state
    for (name, _), a, b in zip(calls, got, want):
        if a is not None:
            assert torch.equal(a, b), name
    _assert_same(placed, one)
    assert placed.sharded


# ---------------------------------------------------------------------------
# (d) the force and the zero-fill: shards against the one-tensor pool
# ---------------------------------------------------------------------------


def _fresh_plan(state, rng, k):
    """``k`` blocks forced to distinct free slots (K1's contract), then a pad
    lane that repeats lane 0."""
    regions, slots = state.pool_shape[:2]
    table = state.table.numpy()
    used = set(map(tuple, table.tolist()))
    free = [(r, s) for r in range(regions) for s in range(slots) if (r, s) not in used]
    pick = rng.choice(len(free), size=k, replace=False)
    ids = rng.choice(len(table), size=k, replace=False)
    dst = np.array([free[i] for i in pick])
    pad = lambda a: np.concatenate([a, a[:1]])  # noqa: E731
    return [torch.from_numpy(pad(np.asarray(a, np.int64))) for a in (ids, dst[:, 0], dst[:, 1])]


@pytest.mark.parametrize("regions", [2, 4])
def test_force_and_zero_fill_on_shards_match_the_one_tensor_pool(regions):
    rng = np.random.default_rng(regions)
    pc = T.PoolConfig(regions, 12, BLK, region_axis="data")
    one = _state(pc, 6 * regions, seed=regions)
    placed = _placed(pc, _copy(one))
    migrator.clear_program_caches()
    for _ in range(3):
        ids, dst_r, dst_s = _fresh_plan(one, rng, 5)
        for s in (one, placed):
            migrator.force_areas(s, ids, dst_r, dst_s)
        _assert_same(placed, one)
    ids, dst_r, dst_s = _fresh_plan(one, rng, 3)
    for s in (one, placed):  # the legacy per-area force: one destination region
        migrator.force_migrate(s, ids, dst_s, 1)
        migrator.zero_fill(s, torch.tensor([0, 5, 0]), regions - 1)  # a pad lane
    _assert_same(placed, one)
    sizes = migrator.program_cache_sizes()
    assert sizes["force_areas"] == 2 and sizes["force_migrate"] == sizes["zero_fill"] == 2
    assert placed.sharded
