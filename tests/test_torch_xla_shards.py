"""The xla backend over region shards, on the CPU.

A driver given a region mesh places its state there, one pool tensor a
region; the xla backend's copies (``fused_copy``, ``fused_copy_runs``,
``copy_chunk``, the force and the megastep's zero, copy and run phases) go
through the copy kernels' shard-table instance, whose plain version runs
here.  Both sides harvest verdicts blocking after every tick.

* (a) against the JAX package on 4 host devices (one subprocess, as
  ``tests/conftest.py`` holds this process to one JAX device): megastep,
  batched and legacy drains on a small and on a two-tier pool, tiering on
  (and a megastep drain with ``warm_dispatch``), writes dirtying copies in
  flight, then ``drain_region(drv, 3)``; pool,
  table, flags, reads, verdicts (request progress), ``MigrationStats`` and
  ``jit_cache_misses`` bit for bit, heat within 1e-6 (fp32 decay and sum
  order);
* (b) a Hypothesis property: ``fused_copy``, ``fused_copy_runs``,
  ``copy_chunk``, ``force_areas`` and the megastep on shards against the
  one-tensor pool, bit for bit, with equal variant counts;
* (c) dispatch: ``impl="cuda"`` refuses CPU shards, the plain version
  against a gather-then-scatter oracle, and a ``cpu`` + ``meta`` mesh
  refused by an xla driver;
* (d) the dry-run's leap cells: accounted on the pod, and at a small
  payload on the CPU equal to the reference's ``copy_chunk`` and
  ``copy_chunk_ppermute`` on a sharded state.
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

import numpy as np  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from test_torch_driver import HEAT_TOL, REPO  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.core import migrator  # noqa: E402
from repro_torch.distributed.fault import drain_region  # noqa: E402
from repro_torch.kernels import leap_copy, ops, ref  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402

R, S, N, G, BLOCK, MAX_TICKS = 4, 16, 32, 4, (2, 8), 200
# (dispatch generation, huge factor, warm_dispatch)
CASES = [(mode, huge, False) for mode in ("megastep", "batched", "legacy") for huge in (1, G)]
CASES.append(("megastep", 1, True))
CFG = dict(initial_area_blocks=4, budget_blocks_per_tick=8, max_attempts_before_force=2,
           tiering=True)
LEGACY = dict(chunk_blocks=2)
# the leap cell at a small payload: 4 regions of 8 slots, areas of 4 blocks
CELL = dict(slots=8, payload=(2, 2, 4, 2, 8), area=4)

# Runs in a fresh process with 4 host devices; writes every case's results.
JAX_SCENARIOS = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import repro.core as J
from repro.core import migrator
from repro.distributed.fault import drain_region

d, p = np.load(sys.argv[1]), json.loads(sys.argv[2])
R, N, S = p["R"], p["N"], p["S"]
mesh = jax.make_mesh((R,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
out = {}
for i, (mode, huge, warm) in enumerate(p["cases"]):
    pc = J.PoolConfig(R, S, tuple(p["block"]), region_axis="data", huge_factor=huge)
    place = d["place"]
    state = jax.tree.map(jax.device_put, J.init_state(pc, N, place), J.state_sharding(pc, mesh))
    state = J.leap_write(state, jnp.arange(N), jnp.asarray(d["data"]))
    cfg = dict(p["cfg"], fused_dispatch=mode, warm_dispatch=warm,
               **(p["legacy"] if mode == "legacy" else {}))
    drv = J.MigrationDriver(state, pc, J.LeapConfig(**cfg), mesh=mesh)
    if huge > 1:
        drv.adopt_huge(np.arange(N // huge))
    s = drv.default_session()
    handles = [s.leap(np.nonzero(place == r)[0], (r + 1) % R) for r in range(R)]
    t = 0

    def run(t):
        while not s.done and t < p["max_ticks"]:
            s.tick()
            s.poll(block=True)
            drv.write(jnp.asarray(d["wids"][t]), jnp.asarray(d["wvals"][t]))
            drv.read(jnp.asarray(d["rids"][t]))
            t += 1
        assert s.drain()
        return t

    t = run(0)
    drained = drain_region(drv, 3)
    t = run(t)
    spec = drv.state.pool.sharding.spec
    res = dict(
        pool=np.asarray(drv.state.pool), table=np.asarray(drv.state.table),
        dirty=np.asarray(drv.state.dirty), in_flight=np.asarray(drv.state.in_flight),
        host_table=drv.host_table(), heat=drv.heat_snapshot(), ticks=t, drained=drained,
        read=np.asarray(drv.read(jnp.arange(N), note=False)),
        stats=repr(dataclasses.asdict(drv.stats)),
        progress=repr([dataclasses.asdict(h.progress()) for h in handles]),
        verified=drv.verify_mirror(), spec=repr(tuple(spec)))
    out.update({f"{i}_{k}": v for k, v in res.items()})
# the leap cell at a small payload: copy_chunk and copy_chunk_ppermute
c = p["cell"]
pc = J.PoolConfig(R, c["slots"], tuple(c["payload"]), jnp.bfloat16, region_axis="data")
ids = jnp.arange(c["area"])
dst = ids + c["slots"] // 2
for backend in ("xla", "ppermute"):
    state = J.LeapState(pool=jnp.asarray(d["cell_pool"].astype(ml_dtypes.bfloat16)),
                        table=jnp.asarray(d["cell_table"]),
                        dirty=jnp.zeros(len(d["cell_table"]), bool),
                        in_flight=jnp.zeros(len(d["cell_table"]), bool))
    state = jax.tree.map(jax.device_put, state, J.state_sharding(pc, mesh))
    if backend == "xla":
        state = migrator.copy_chunk(state, ids, dst, 1)
    else:
        state = migrator.copy_chunk_ppermute(state, ids, dst, 0, 1, "data", mesh)
    out[f"cell_{backend}"] = np.asarray(state.pool.astype(jnp.float32))
np.savez(sys.argv[3], **out)
"""


def _schedule(seed: int = 5, writes: int = 4):
    rng = np.random.default_rng(seed)
    return dict(
        place=np.repeat(np.arange(R), N // R).astype(np.int32),
        data=rng.normal(size=(N,) + BLOCK).astype(np.float32),
        wids=np.stack([rng.choice(N, size=writes, replace=False) for _ in range(MAX_TICKS)]),
        wvals=rng.normal(size=(MAX_TICKS, writes) + BLOCK).astype(np.float32),
        rids=np.stack([rng.choice(N, size=4, replace=False) for _ in range(MAX_TICKS)]),
    )


def _port_case(sched, mode: str, huge: int, warm: bool):
    """The JAX scenario's case on the port, over CPU region shards."""
    mesh = T.make_region_mesh(R, ["cpu"] * R)
    pc = T.PoolConfig(R, S, BLOCK, region_axis="data", huge_factor=huge)
    place = sched["place"]
    state = T.init_state(pc, N, place, device="cpu")
    T.leap_write(state, np.arange(N), torch.from_numpy(sched["data"]))
    cfg = dict(CFG, fused_dispatch=mode, warm_dispatch=warm,
               **(LEGACY if mode == "legacy" else {}))
    drv = T.MigrationDriver(state, pc, T.LeapConfig(**cfg), mesh=mesh)
    assert drv.state.sharded and drv.cfg.backend == "xla"
    if huge > 1:
        drv.adopt_huge(np.arange(N // huge))
    s = drv.default_session()
    handles = [s.leap(np.nonzero(place == r)[0], (r + 1) % R) for r in range(R)]

    def run(t):
        while not s.done and t < MAX_TICKS:
            s.tick()
            s.poll(block=True)
            drv.write(sched["wids"][t], torch.from_numpy(sched["wvals"][t]))
            drv.read(sched["rids"][t])
            t += 1
        assert s.drain()
        return t

    t = run(0)
    drained = drain_region(drv, 3)
    return drv, handles, run(t), drained


def _cell_inputs():
    """The small leap cell's state on 4 CPU regions, and its host arrays."""
    state, pc, mesh = D.leap_cell_state(R, "cpu", 0, CELL["slots"], CELL["payload"])
    pool, table, _, _ = state.to_numpy()
    return state, mesh, pool, table


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Every case on both packages: the JAX package's in one 4-device
    subprocess, the port's in this process, each from empty caches and in
    the same order, so that ``jit_cache_misses`` compare."""
    tmp = tmp_path_factory.mktemp("xla_shards")
    sched = _schedule()
    _, _, cell_pool, cell_table = _cell_inputs()
    np.savez(tmp / "in.npz", cell_pool=cell_pool, cell_table=cell_table, **sched)
    params = dict(R=R, N=N, S=S, block=list(BLOCK), cfg=CFG, legacy=LEGACY, cases=CASES,
                  max_ticks=MAX_TICKS, cell=dict(CELL, payload=list(CELL["payload"])))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCENARIOS), str(tmp / "in.npz"),
         json.dumps(params), str(tmp / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"},
    )
    migrator.clear_program_caches()  # the reference's side runs in a fresh process
    port = [_port_case(sched, *case) for case in CASES]
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return sched, port, dict(np.load(tmp / "jax.npz"))


# ---------------------------------------------------------------------------
# (a) the JAX package on 4 host devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{m}-huge{h}{'-warm' if w else ''}" for m, h, w in CASES])
def test_xla_drain_over_shards_matches_jax_on_four_devices(both, case):
    sched, port, jax_out = both
    want = {k.split("_", 1)[1]: v for k, v in jax_out.items() if k.startswith(f"{case}_")}
    drv, handles, ticks, drained = port[case]
    mode, huge, _ = CASES[case]
    assert ast.literal_eval(str(want["spec"]))[0] == "data"  # the reference's pool stays sharded
    assert drv.state.sharded and len({t.untyped_storage().data_ptr() for t in drv.state.pool}) == R
    assert ticks == int(want["ticks"]) and drained == int(want["drained"]) > 0
    for name, got in zip(("pool", "table", "dirty", "in_flight"), drv.state.to_numpy()):
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    np.testing.assert_array_equal(drv.host_table(), want["host_table"])
    np.testing.assert_array_equal(drv.read(np.arange(N), note=False).numpy(), want["read"])
    np.testing.assert_allclose(drv.heat_snapshot(), want["heat"], **HEAT_TOL)
    stats = dataclasses.asdict(drv.stats)
    assert stats == ast.literal_eval(str(want["stats"]))  # jit_cache_misses among them
    assert [dataclasses.asdict(h.progress()) for h in handles] == ast.literal_eval(
        str(want["progress"]))
    assert bool(want["verified"]) and drv.verify_mirror() and drv.verify_tiers()
    s = drv.stats
    assert not (drv.host_placement() == 3).any()  # the failed region is empty
    assert s.dirty_rejections > 0 and s.blocks_migrated > 0
    assert s.blocks_migrated + s.blocks_forced + s.blocks_cancelled == s.blocks_requested
    if huge > 1:
        assert s.huge_areas_committed > 0 and s.bytes_copied_huge > 0
    if mode == "megastep":
        assert 0 < s.dispatches_per_tick <= 1.0


def test_the_cpu_drains_launched_no_kernel_and_kept_their_shards(both):
    _, port, _ = both
    assert leap_copy.copy_blocks_shards.launches == 0  # CPU shards: the plain versions
    assert leap_copy.copy_runs_shards.launches == leap_copy.zero_blocks_shards.launches == 0
    for drv, *_ in port:
        assert [t.device for t in drv.state.pool] == [torch.device("cpu")] * R
        assert all(tuple(t.shape) == (S + 1,) + BLOCK for t in drv.state.pool)


# ---------------------------------------------------------------------------
# (b) the xla programs on shards against the one-tensor pool
# ---------------------------------------------------------------------------

GB = 2  # huge factor of the property's run copies
BLK = (2, 4)


def _half_full(regions: int, runs: int, seed: int) -> T.LeapState:
    """Half of the ``GB``-aligned runs hold a group each, shuffled over the
    regions; random payload (free slots too) and flags."""
    rng = np.random.default_rng(seed)
    n = regions * runs // 2 * GB
    starts = rng.permutation(regions * runs)[: n // GB]
    table = np.stack([np.repeat(starts // runs, GB),
                      np.repeat(starts % runs, GB) * GB + np.tile(np.arange(GB), n // GB)], 1)
    pool = rng.normal(size=(regions, runs * GB) + BLK).astype(np.float32)
    return T.LeapState.from_numpy(pool, table.astype(np.int32), rng.random(n) < 0.3,
                                  rng.random(n) < 0.5, "cpu")


def _free(state, run: int = 1) -> np.ndarray:
    """Flat starts of the ``run``-aligned runs no table entry touches."""
    regions, slots = state.pool_shape[:2]
    used = np.zeros(regions * slots, bool)
    t = state.table.numpy()
    used[t[:, 0] * slots + t[:, 1]] = True
    return np.nonzero(~used.reshape(-1, run).any(1))[0] * run


def _ids(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64))


def _pad(a: np.ndarray) -> np.ndarray:
    return np.concatenate([a, a[:1]])  # a pad lane repeats lane 0


def _k(rng, m: int, cap: int = 6) -> int:
    """Lanes of a call with ``m`` destinations to choose from: 1 to
    ``min(cap, m)``, or none."""
    return int(rng.integers(1, min(cap, m) + 1)) if m else 0


def _runs(state, rng):
    """``(src, dst)`` starts of whole ``GB``-slot runs: destinations free,
    sources any other aligned run (a free run copies as well as a held one)."""
    regions, slots = state.pool_shape[:2]
    free_runs = _free(state, GB)
    dst = rng.choice(free_runs, _k(rng, len(free_runs)), replace=False)
    others = np.setdiff1d(np.arange(regions * slots // GB) * GB, dst)
    return rng.choice(others, len(dst), replace=False), dst


def _plan(state, rng, kind: str):
    """One call of ``kind`` on ``state``, drawn from its table: sources are
    held blocks, destinations free slots (the copy kernel's contract)."""
    regions, slots = state.pool_shape[:2]
    t = state.table.numpy().astype(np.int64)
    n = len(t)
    flat = t[:, 0] * slots + t[:, 1]
    free = _free(state)
    k = _k(rng, len(free))
    if kind == "fused_copy":
        return (_ids(_pad(flat[rng.choice(n, k, replace=False)])),
                _ids(_pad(rng.choice(free, k, replace=False))))
    if kind == "fused_copy_runs":
        src, dst = _runs(state, rng)
        return _ids(_pad(src)), _ids(_pad(dst)), GB
    if kind == "copy_chunk":
        region = int(rng.integers(regions))
        mine = free[free // slots == region] % slots
        k = _k(rng, len(mine))
        return (_ids(rng.choice(n, k, replace=False)), _ids(rng.choice(mine, k, replace=False)),
                region)
    # force_areas: blocks to distinct free slots
    dst = rng.choice(free, k, replace=False)
    return (_ids(_pad(rng.choice(n, k, replace=False))), _ids(_pad(dst // slots)),
            _ids(_pad(dst % slots)))


def _megastep_plan(state, rng):
    """A megastep with zero, force, copy and run phases (commits and begins
    touch the table alone, in either layout), each destination set fresh."""
    regions, slots = state.pool_shape[:2]
    t = state.table.numpy().astype(np.int64)
    n = len(t)
    flat = t[:, 0] * slots + t[:, 1]
    run_src, runs_dst = _runs(state, rng)
    small = np.setdiff1d(_free(state), (runs_dst[:, None] + np.arange(GB)).ravel())
    k = min(3, len(small) // 3)
    force_dst, copy_dst, zero = np.split(rng.choice(small, 3 * k, replace=False), 3)
    forced = rng.choice(n, k, replace=False)
    copied = rng.choice(np.setdiff1d(np.arange(n), forced), k, replace=False)
    empty = np.zeros(0, np.int64)
    ops_ = [empty] * 7 + [zero, forced, force_dst // slots, force_dst % slots, flat[copied],
                          copy_dst, run_src, runs_dst, empty]
    return [_ids(_pad(a) if len(a) else a) for a in ops_] + [torch.zeros(0)]


def _apply(state, calls):
    for kind, args in calls:
        if kind == "megastep":
            migrator.megastep(state, *args[:15], torch.zeros(0), args[15], args[16], group=GB)
        else:
            getattr(migrator, kind)(state, *args)


@st.composite
def _program_case(draw):
    regions = draw(st.integers(2, 4))
    runs = draw(st.integers(2, 4)) * 2
    seed = draw(st.integers(0, 2**16))
    kinds = draw(st.lists(st.sampled_from(["fused_copy", "fused_copy_runs", "copy_chunk",
                                           "force_areas", "megastep"]), min_size=1, max_size=6))
    return regions, runs, seed, kinds


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_program_case())
def test_xla_programs_on_shards_match_the_one_tensor_pool(case):
    regions, runs, seed, kinds = case
    one = _half_full(regions, runs, seed)
    pc = T.PoolConfig(regions, runs * GB, BLK, region_axis="data", huge_factor=GB)
    placed = _half_full(regions, runs, seed).to(
        T.state_sharding(pc, T.make_region_mesh(regions, ["cpu"] * regions)))
    rng = np.random.default_rng(seed)
    calls = []
    for kind in kinds:  # plans drawn against the table as the calls leave it
        args = _megastep_plan(one, rng) if kind == "megastep" else _plan(one, rng, kind)
        calls.append((kind, args))
        _apply(one, calls[-1:])
    migrator.clear_program_caches()
    _apply(_half_full(regions, runs, seed), calls)
    sizes = migrator.program_cache_sizes()
    migrator.clear_program_caches()
    _apply(placed, calls)
    assert migrator.program_cache_sizes() == sizes  # the same variants, keyed on the shards
    assert placed.sharded
    for name, a, b in zip(("pool", "table", "dirty", "in_flight"), placed.to_numpy(),
                          one.to_numpy()):
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# (c) dispatch and the plain version
# ---------------------------------------------------------------------------


def _shards(regions=3, slots=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((slots + 1, 2, 4), generator=g) for _ in range(regions)]


def test_impl_cuda_refuses_cpu_shards():
    shards, two = _shards(), torch.tensor([0, 9])
    calls = (
        lambda: ops.copy_blocks_shards_impl(shards, two, two + 4, slots_per_region=8,
                                            impl="cuda"),
        lambda: ops.copy_runs_shards_impl(shards, two * 0, two * 0 + 8, slots_per_region=8,
                                          run=4, impl="cuda"),
        lambda: ops.zero_blocks_shards_impl(shards, two, slots_per_region=8, impl="cuda"),
    )
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="impl"):
        ops.zero_blocks_shards_impl(shards, two, slots_per_region=8, impl="triton")


@pytest.mark.parametrize("run", [1, 2, 4])
def test_plain_version_equals_a_gather_then_scatter_over_the_flat_pool(run):
    """The plain version against the one-tensor ``copy_runs_ref`` over the
    shards stacked flat (sinks left out), with lanes from and to every
    region; zero-fill too.  Sink rows are the only other rows it touches."""
    regions, slots = 3, 8
    shards = _shards(regions, slots, seed=run)
    rng = np.random.default_rng(run)
    starts = rng.permutation(regions * slots // run) * run
    k = len(starts) // 2
    src, dst = _ids(np.concatenate([starts[:k], starts[:1]])), _ids(
        np.concatenate([starts[k : 2 * k], starts[k : k + 1]]))
    flat = torch.cat([t[:slots] for t in shards]).clone()
    ref.copy_runs_ref(flat, src, dst, run)
    for o in (ops.copy_runs_shards_impl, ops.copy_blocks_shards_impl):
        got = [t.clone() for t in shards]
        if o is ops.copy_runs_shards_impl:
            o(got, src, dst, slots_per_region=slots, run=run)
        elif run == 1:
            o(got, src, dst, slots_per_region=slots)
        else:
            continue
        assert torch.equal(torch.cat([t[:slots] for t in got]), flat)
    zero = dst[:2]
    ops.zero_blocks_shards_impl(shards, zero, slots_per_region=slots)
    stacked = torch.cat([t[:slots] for t in shards])
    assert not stacked[zero].any()
    with pytest.raises(ValueError, match="sink"):  # a shard without a sink row
        ref.copy_shards_ref([t[:slots] for t in shards], src, dst, slots, run)


def test_an_xla_driver_refuses_a_meta_mesh():
    pc = T.PoolConfig(2, 6, BLOCK, region_axis="data")
    state = T.init_state(pc, 4, np.array([0, 0, 1, 1]), device="cpu")
    with pytest.raises(ValueError, match="meta"):  # as for ppermute
        T.MigrationDriver(state, pc, T.LeapConfig(), mesh=T.make_region_mesh(2, ["cpu", "meta"]))


# ---------------------------------------------------------------------------
# (d) the dry-run's leap cells
# ---------------------------------------------------------------------------


@pytest.fixture
def art_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "ART_DIR", str(tmp_path))
    return tmp_path


def test_the_leap_cells_are_accounted_on_the_pod(art_dir):
    assert D.main(["--leap", "--mesh", "pod"]) == 0
    shard = 64 * 46 * 2 * 64 * 16 * 128 * 2  # a region's 64 slots of bf16 KV pages
    blocks = 16 * 64 // 2
    for backend in D.LEAP_BACKENDS:
        art = json.loads((art_dir / "pod" / f"leap_migration__{backend}.json").read_text())
        assert art["status"] == D.ACCOUNTED and art["n_chips"] == 256
        m = art["memory"]
        assert m["pool_shard_bytes"] == shard == 1_543_503_872 and m["regions"] == 16
        assert m["replicated_bytes"] == blocks * 8 + 2 * blocks + 2 * 16 * 4
        assert m["argument_bytes"] == shard + m["replicated_bytes"]


def test_a_small_leap_cell_equals_the_references_copies_on_a_sharded_state(both, art_dir,
                                                                          monkeypatch):
    _, _, jax_out = both
    for backend in D.LEAP_BACKENDS:
        state, mesh, before, _ = _cell_inputs()
        assert state.sharded and state.dtype == torch.bfloat16
        D.leap_step(state, mesh, backend, CELL["area"])()
        np.testing.assert_array_equal(state.to_numpy()[0], jax_out[f"cell_{backend}"],
                                      err_msg=backend)
        moved = state.to_numpy()[0]
        half = CELL["slots"] // 2
        np.testing.assert_array_equal(moved[1, half : half + CELL["area"]],
                                      before[0, : CELL["area"]])
    # the cell through the runner on the CPU: OK, its device figures not measured
    monkeypatch.setattr(D, "LEAP_CELL", CELL)
    monkeypatch.setattr(D, "LEAP_REGIONS", R)
    art = D.run_cell("leap_migration", "xla", "h100", device="cpu")
    assert art["status"] == D.OK and art["regions"] == R
    assert art["area_bytes"] == CELL["area"] * 2 * 2 * 4 * 2 * 8 * 2
    assert art["bound_ms"] == pytest.approx(2 * art["area_bytes"] / 3.35e12 * 1e3)
    m = art["measured"]
    assert m["device_ms"] is None and m["busy"] is None and m["kernels_by_name"] == {}
    assert len(m["steps_ms"]) == D.LEAP_STEPS
