"""The batched dispatch generation and the ppermute copy backend of the port
against the JAX package.

* K6a/K6b's plain versions (``gather_blocks_ref``/``scatter_blocks_ref``)
  against ``gather_blocks_pallas``/``scatter_blocks_pallas`` in interpret
  mode, over the JAX sweep's shapes and dtypes: exact, duplicate ids
  included (the last lane wins).
* Batched drains through the ``Pair`` harness of ``test_torch_driver``
  (blocking harvest): states, tables, stats and progress bit for bit, heat
  within rtol = atol = 1e-6.
* The port's batched drain against its own megastep drain: pools and tables
  bit for bit.
* A 4-region ppermute drain: the JAX package on a mesh of 4 host devices,
  in a subprocess (``tests/conftest.py`` holds the main process to one JAX
  device), against the port on ``make_region_mesh(4, ["cpu"] * 4)`` (its
  state one pool tensor a region), batched and legacy, with the same
  seeded schedule: states, tables, stats (``jit_cache_misses``
  too, the port's caches emptied first) and progress bit for bit, heat
  within 1e-6.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_driver import HEAT_TOL, REPO, Pair  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro.kernels.leap_copy import gather_blocks_pallas, scatter_blocks_pallas  # noqa: E402
from repro_torch.kernels import leap_copy, ops, ref  # noqa: E402

# the JAX sweep (tests/test_kernels_leap_copy.py): (slots, rows, cols); then
# a 12-byte slot and a pool with more than 257 slots
SHAPES = [(8, 8, 128), (16, 16, 256), (5, 4, 64), (32, 1, 512), (3, 1, 3), (300, 1, 4)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int32": (jnp.int32, torch.int32)}


def _pool(shape, dtype: str, seed=0):
    """The same values as a JAX array and a torch tensor."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    if dtype == "int32":
        x = rng.integers(-100, 100, size=shape).astype(np.int32)
        return jnp.asarray(x), torch.from_numpy(x)
    x = rng.normal(size=shape).astype(np.float32)  # both round to bf16 to nearest even
    return jnp.asarray(x, dtype=jd), torch.from_numpy(x).to(td)


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t)


# ---------------------------------------------------------------------------
# K6a/K6b plain versions against the Pallas kernels (interpret mode): exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_blocks_ref_matches_pallas(shape, dtype):
    jpool, tpool = _pool(shape, dtype)
    rng = np.random.default_rng(1)
    for k in (1, 3, shape[0]) + ((257,) if shape[0] >= 257 else ()):
        idx = rng.integers(0, shape[0], size=k)  # duplicates allowed
        want = gather_blocks_pallas(jpool, jnp.asarray(idx, jnp.int32), interpret=True)
        got = ref.gather_blocks_ref(tpool, torch.from_numpy(idx))
        np.testing.assert_array_equal(_host(got), _host(want))
        got = leap_copy.gather_blocks(tpool, torch.from_numpy(idx))  # CPU: the plain version
        np.testing.assert_array_equal(_host(got), _host(want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_blocks_ref_matches_pallas(shape, dtype):
    jpool, tpool = _pool(shape, dtype)
    rng = np.random.default_rng(2)
    k = min(4, shape[0])
    for idx in (rng.choice(shape[0], size=k, replace=False),  # the JAX sweep's ids
                rng.integers(0, min(3, shape[0]), size=2 * k)):  # and duplicate-heavy ids
        jblocks, tblocks = _pool((len(idx),) + shape[1:], dtype, seed=3)
        want = scatter_blocks_pallas(jpool, jnp.asarray(idx, jnp.int32), jblocks, interpret=True)
        got = ref.scatter_blocks_ref(tpool.clone(), torch.from_numpy(idx), tblocks)
        np.testing.assert_array_equal(_host(got), _host(want))


def test_scatter_duplicate_last_wins():
    """The reference's ``test_scatter_duplicate_last_wins``, through every
    CPU entry point of the port."""
    idx = torch.tensor([1, 1])
    blocks = torch.stack([torch.full((2, 8), 1.0), torch.full((2, 8), 2.0)])
    want = np.asarray(scatter_blocks_pallas(jnp.zeros((4, 2, 8)), jnp.asarray([1, 1], jnp.int32),
                                            jnp.asarray(blocks.numpy()), interpret=True))
    for fn in (ref.scatter_blocks_ref, leap_copy.scatter_blocks, ops.scatter_blocks_impl):
        got = fn(torch.zeros(4, 2, 8), idx, blocks)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got[1].numpy(), np.full((2, 8), 2.0))
    got = ops.scatter_blocks(torch.zeros(4, 2, 8), idx.int(), blocks)  # int32 ids
    np.testing.assert_array_equal(got.numpy(), want)


def test_ops_gather_scatter_on_a_region_shard():
    """The ppermute program's operands: one region's shard of the flat pool,
    a view with a storage offset; int32 ids through the public entry points."""
    pool = torch.arange(3 * 8 * 2 * 4, dtype=torch.float32).view(3, 8, 2, 4)
    shard = T.state.flat_pool_view(pool[1:2])
    assert shard.storage_offset() == 8 * 2 * 4 and shard.is_contiguous()
    idx = torch.tensor([7, 0, 3], dtype=torch.int32)
    buf = ops.gather_blocks(shard, idx)
    np.testing.assert_array_equal(buf.numpy(), pool[1, [7, 0, 3]].numpy())
    ops.scatter_blocks(T.state.flat_pool_view(pool[2:3]), idx, buf)
    np.testing.assert_array_equal(pool[2, [7, 0, 3]].numpy(), pool[1, [7, 0, 3]].numpy())
    with pytest.raises(ValueError, match="CUDA"):
        ops.gather_blocks(shard, idx, impl="cuda")


# ---------------------------------------------------------------------------
# The batched generation against the JAX package's (Pair harness)
# ---------------------------------------------------------------------------

BATCHED = dict(fused_dispatch="batched")


@pytest.mark.parametrize("scheduler", ["leap", "sync", "sampling"])
def test_batched_interleaved_writes_with_force_escalation(scheduler):
    """Eight writes a tick and escalation after two rejections; the sync and
    sampling policies add fresh-destination zero fills."""
    n = 32
    p = Pair(n, 2 * n, dict(BATCHED, initial_area_blocks=8, budget_blocks_per_tick=8,
                            max_attempts_before_force=2), scheduler=scheduler, seed=3)
    rng = np.random.default_rng(3)
    p.leap(np.arange(n), 1)
    for _ in range(200):
        if all(s.done for s in p.sessions):
            break
        p.tick()
        ids = rng.choice(n, size=8, replace=False)
        p.write(ids, rng.normal(size=(8, 4)).astype(np.float32))
        p.assert_equal()
    p.drain()
    p.assert_equal()
    assert (p.t.host_placement() == 1).all()
    s = p.t.stats
    if scheduler == "leap":
        assert s.dirty_rejections > 0 and s.blocks_forced > 0
    assert s.blocks_migrated + s.blocks_forced + s.blocks_cancelled == s.blocks_requested
    assert s.dispatches_per_tick > 1.0  # one program per phase


def test_batched_huge_tier_drain_under_writes():
    """Two-tier pool: ``commit_groups`` and ``fused_copy_runs``, rejected runs
    retried whole and then demoted to small blocks."""
    G, n = 4, 32
    p = Pair(n, 48, dict(BATCHED, initial_area_blocks=8, budget_blocks_per_tick=8),
             huge_factor=G, seed=5)
    for d in (p.j, p.t):
        assert d.adopt_huge(np.arange(n // G)) == n // G
    rng = np.random.default_rng(5)
    p.leap(np.arange(n), 1)
    for _ in range(200):
        if all(s.done for s in p.sessions):
            break
        p.tick()
        ids = rng.choice(n, size=3, replace=False)
        p.write(ids, rng.normal(size=(3, 4)).astype(np.float32))
        p.assert_equal()
    p.drain()
    p.assert_equal()
    s = p.t.stats
    assert s.huge_areas_committed > 0 and s.dirty_rejections > 0 and s.bytes_copied_huge > 0
    assert (p.t.host_placement() == 1).all()


def test_batched_tiering_drain_with_reads_and_promotion():
    """``heat_update`` after every tick, a cxl topology with link budgets,
    and promotions of cold aligned groups (``force_areas``)."""
    G, n = 4, 24
    p = Pair(n, 32, dict(BATCHED, budget_blocks_per_tick=8, tiering=True, tier_heat_decay=0.8,
                         tier_write_weight=2.0, promote_per_tick=1), n_regions=3,
             huge_factor=G, topology=True, placement=np.full(n, 2, np.int32), seed=11)
    rng = np.random.default_rng(11)
    p.leap(np.arange(n // 2), 0)
    p.leap(np.arange(n // 2, n), 1)
    for step in range(200):
        if all(s.done for s in p.sessions) and step > 6:
            break
        p.read(rng.choice(n, size=4, replace=False))
        if step % 3 == 0:
            ids = rng.choice(n, size=2, replace=False)
            p.write(ids, rng.normal(size=(2, 4)).astype(np.float32))
        p.tick()
        p.assert_equal()
    p.drain()
    p.assert_equal()
    assert (p.t.heat_snapshot() > 0).any()
    assert p.t.stats.promotions > 0 and p.t.stats.deferred_congested > 0


def _port_interleaved(mode, seed=3, n=32, **cfg):
    """``tests/test_megastep.py``'s ``_run_interleaved`` on the port; ``cfg``
    overrides ``LeapConfig`` fields."""
    rng = np.random.default_rng(seed)
    pc = T.PoolConfig(2, 2 * n, (4,))
    data = rng.normal(size=(n, 4)).astype(np.float32)
    state = T.leap_write(T.init_state(pc, n, np.zeros(n, np.int32), device="cpu"),
                         np.arange(n), torch.from_numpy(data))
    drv = T.MigrationDriver(state, pc, T.LeapConfig(**{
        **dict(initial_area_blocks=8, budget_blocks_per_tick=8, max_attempts_before_force=3,
               fused_dispatch=mode, tiering=True), **cfg}))
    s = drv.default_session()
    h = s.leap(np.arange(n), 1)
    for _ in range(1000):
        if drv.done:
            break
        s.tick()
        s.poll(block=True)
        ids = rng.choice(n, size=4, replace=False)
        vals = rng.normal(size=(4, 4)).astype(np.float32)
        drv.write(ids, torch.from_numpy(vals))
        data[ids] = vals
    assert s.drain()
    return drv, data, h


def test_port_batched_matches_its_megastep_bit_for_bit():
    (m, exp_m, hm), (b, exp_b, hb) = _port_interleaved("megastep"), _port_interleaved("batched")
    np.testing.assert_array_equal(exp_m, exp_b)
    for drv, expected in ((m, exp_m), (b, exp_b)):
        assert drv.verify_mirror() and (drv.host_placement() == 1).all()
        np.testing.assert_array_equal(drv.read(np.arange(32), note=False).numpy(), expected)
    for got, want in zip(b.state.to_numpy(), m.state.to_numpy()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(b.host_table(), m.host_table())
    np.testing.assert_allclose(b.heat_snapshot(), m.heat_snapshot(), **HEAT_TOL)
    assert hb.progress() == hm.progress()
    assert m.stats.dirty_rejections == b.stats.dirty_rejections > 0
    assert m.stats.dispatches < b.stats.dispatches


# ---------------------------------------------------------------------------
# The ppermute backend on a 4-region mesh against the JAX package
# ---------------------------------------------------------------------------

R, N, S, BLOCK, MAX_TICKS = 4, 64, 40, (2, 8), 300

# Runs in a fresh process with 4 host devices; writes the final state.
JAX_DRAIN = """
import ast, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import repro.core as J

sched, params = np.load(sys.argv[1]), json.loads(sys.argv[2])
R, N, S = params["R"], params["N"], params["S"]
mesh = jax.make_mesh((R,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
pc = J.PoolConfig(R, S, tuple(params["block"]), region_axis="data")
place = sched["place"]
state = jax.tree.map(jax.device_put, J.init_state(pc, N, place), J.state_sharding(pc, mesh))
state = J.leap_write(state, jnp.arange(N), jnp.asarray(sched["data"]))
drv = J.MigrationDriver(state, pc, J.LeapConfig(**params["cfg"]), mesh=mesh,
                        scheduler=params["scheduler"])
s = drv.default_session()
handles = [s.leap(np.nonzero(place == r)[0], (r + 1) % R) for r in range(R)]
for t in range(len(sched["wids"])):
    if s.done:
        break
    s.tick()
    s.poll(block=True)
    drv.write(jnp.asarray(sched["wids"][t]), jnp.asarray(sched["wvals"][t]))
    drv.read(jnp.asarray(sched["rids"][t]))
assert s.drain()
stats = dataclasses.asdict(drv.stats)
np.savez(
    sys.argv[3], pool=np.asarray(drv.state.pool), table=np.asarray(drv.state.table),
    dirty=np.asarray(drv.state.dirty), in_flight=np.asarray(drv.state.in_flight),
    host_table=drv.host_table(), heat=drv.heat_snapshot(), ticks=t,
    read=np.asarray(drv.read(jnp.arange(N), note=False)),
    stats=repr(stats), progress=repr([dataclasses.asdict(h.progress()) for h in handles]),
    status=repr([h.status.value for h in handles]), verified=drv.verify_mirror(),
)
"""


def _schedule(seed: int, writes: int):
    rng = np.random.default_rng(seed)
    return dict(
        place=np.repeat(np.arange(R), N // R).astype(np.int32),
        data=rng.normal(size=(N,) + BLOCK).astype(np.float32),
        wids=np.stack([rng.choice(N, size=writes, replace=False) for _ in range(MAX_TICKS)]),
        wvals=rng.normal(size=(MAX_TICKS, writes) + BLOCK).astype(np.float32),
        rids=np.stack([rng.choice(N, size=4, replace=False) for _ in range(MAX_TICKS)]),
    )


def _port_ppermute_drain(sched, cfg_kw, scheduler):
    T.migrator.clear_program_caches()  # the reference's side runs in a fresh process
    mesh = T.make_region_mesh(R, ["cpu"] * R)
    pc = T.PoolConfig(R, S, BLOCK, region_axis="data")
    place = sched["place"]
    state = T.init_state(pc, N, place, device="cpu").to(T.state_sharding(pc, mesh))
    T.leap_write(state, np.arange(N), torch.from_numpy(sched["data"]))
    drv = T.MigrationDriver(state, pc, T.LeapConfig(**cfg_kw), mesh=mesh, scheduler=scheduler)
    s = drv.default_session()
    handles = [s.leap(np.nonzero(place == r)[0], (r + 1) % R) for r in range(R)]
    for t in range(MAX_TICKS):
        if s.done:
            break
        s.tick()
        s.poll(block=True)
        drv.write(sched["wids"][t], torch.from_numpy(sched["wvals"][t]))
        drv.read(sched["rids"][t])
    assert s.drain()
    return drv, handles, t


@pytest.mark.parametrize("scheduler,writes,mode", [("leap", 12, "batched"), ("sync", 6, "batched"),
                                                   ("leap", 12, "legacy")],
                         ids=["leap-12", "sync-6", "leap-12-legacy"])
def test_ppermute_drain_matches_jax_on_four_devices(tmp_path, scheduler, writes, mode):
    """Every region's blocks leap to the next region at once (4 region pairs
    a tick) under writes that dirty copies and force escalations; the sync
    policy forces every move into zero-filled slots (one ``zero_fill`` per
    destination region).  The port's state is one pool tensor a region.
    The legacy case moves a chunk a ``copy_chunk_ppermute``."""
    cfg_kw = dict(backend="ppermute", axis_name="data", initial_area_blocks=4,
                  budget_blocks_per_tick=12, max_attempts_before_force=2, tiering=True)
    if mode == "legacy":
        cfg_kw.update(fused_dispatch="legacy", chunk_blocks=2)
    sched = _schedule(7, writes)
    np.savez(tmp_path / "sched.npz", **sched)
    params = dict(R=R, N=N, S=S, block=list(BLOCK), cfg=cfg_kw, scheduler=scheduler)
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_DRAIN), str(tmp_path / "sched.npz"),
         json.dumps(params), str(tmp_path / "jax.npz")],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.load(tmp_path / "jax.npz")

    before = leap_copy.gather_blocks.launches
    drv, handles, ticks = _port_ppermute_drain(sched, cfg_kw, scheduler)
    assert leap_copy.gather_blocks.launches == before  # CPU: the plain versions
    assert drv.state.sharded and [t.device for t in drv.state.pool] == [torch.device("cpu")] * R
    assert len({t.untyped_storage().data_ptr() for t in drv.state.pool}) == R
    assert ticks == int(want["ticks"])
    for name, got in zip(("pool", "table", "dirty", "in_flight"), drv.state.to_numpy()):
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    np.testing.assert_array_equal(drv.host_table(), want["host_table"])
    np.testing.assert_array_equal(drv.read(np.arange(N), note=False).numpy(), want["read"])
    np.testing.assert_allclose(drv.heat_snapshot(), want["heat"], **HEAT_TOL)
    stats = dataclasses.asdict(drv.stats)
    assert stats == ast.literal_eval(str(want["stats"]))
    assert [dataclasses.asdict(h.progress()) for h in handles] == ast.literal_eval(
        str(want["progress"]))
    assert [h.status.value for h in handles] == ast.literal_eval(str(want["status"]))
    assert bool(want["verified"]) and drv.verify_mirror()
    assert (drv.host_placement() == (sched["place"] + 1) % R).all()
    s = drv.stats
    assert s.dispatches > s.ticks
    assert s.blocks_migrated + s.blocks_forced + s.blocks_cancelled == s.blocks_requested
    if scheduler == "leap":
        assert s.dirty_rejections > 0 and s.blocks_forced > 0 and s.blocks_migrated > 0
    else:
        assert s.blocks_forced == s.blocks_requested
    assert sorted(s.bytes_per_link) == [(r, (r + 1) % R) for r in range(R)]


def _ppermute_driver(pc=None, mesh="default", **cfg):
    pc = pc or T.PoolConfig(R, S, BLOCK, region_axis="data")
    mesh = T.make_region_mesh(R, ["cpu"] * R) if mesh == "default" else mesh
    state = T.init_state(pc, N, np.repeat(np.arange(R), N // R), device="cpu")
    kw = dict(backend="ppermute", axis_name="data")
    kw.update(cfg)
    return T.MigrationDriver(state, pc, T.LeapConfig(**kw), mesh=mesh)


def test_ppermute_refusals():
    # no mesh, or no axis: the first copy raises, as in the JAX package
    for drv in (_ppermute_driver(mesh=None), _ppermute_driver(axis_name=None)):
        s = drv.default_session()
        s.leap(np.arange(4), 1)
        with pytest.raises(ValueError, match="mesh and axis_name"):
            for _ in range(3):
                s.tick()
    # a pool whose region axis is not the mesh's, or that has other regions
    mesh = T.make_region_mesh(R, ["cpu"] * R)
    with pytest.raises(ValueError, match="region_axis"):
        T.state_sharding(T.PoolConfig(R, S, BLOCK, region_axis="model"), mesh)
    with pytest.raises(ValueError, match="entries"):
        T.state_sharding(T.PoolConfig(2, S, BLOCK, region_axis="data"), mesh)
    # the two-tier pool needs the xla backend
    with pytest.raises(ValueError, match="two-tier"):
        _ppermute_driver(pc=T.PoolConfig(R, S, BLOCK, region_axis="data", huge_factor=4))
    # a mesh on meta, which holds no data (the driver places its state on the mesh)
    with pytest.raises(ValueError, match="mesh"):
        _ppermute_driver(mesh=T.RegionMesh((torch.device("meta"),) * R))
    with pytest.raises(ValueError, match="devices for"):
        T.make_region_mesh(R, ["cpu"] * 2)
