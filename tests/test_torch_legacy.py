"""The legacy per-area dispatch generation of the port against the JAX package.

* Each per-area program (``begin_area``, ``copy_chunk``, ``commit_area``,
  ``force_migrate``, ``zero_fill``) against the reference's jitted program
  on the same state: bit for bit, verdicts included.
* Legacy, batched and megastep drains through the ``Pair`` harness of
  ``test_torch_driver`` (blocking harvest) for 3 seeds, on small and on
  two-tier pools: states, tables, stats and progress bit for bit, heat
  within rtol = atol = 1e-6.
* The port's own three-way oracle (``tests/test_megastep.py``): the three
  generations reach the same logical outcome from one write schedule.
* ``copy_chunk_ppermute``: a legacy drain on a 4-region mesh against the
  JAX package run on 4 host devices in a subprocess.
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
from test_torch_driver import HEAT_TOL, REPO, Pair, clear_program_caches  # noqa: E402
from test_torch_ppermute import (  # noqa: E402
    JAX_DRAIN,
    MAX_TICKS,
    N,
    R,
    S,
    BLOCK,
    _port_interleaved,
    _port_ppermute_drain,
    _schedule,
)

import repro_torch.core as T  # noqa: E402
from repro.core import migrator as jmig  # noqa: E402
from repro.core import state as jst  # noqa: E402
from repro_torch.core import migrator as tmig  # noqa: E402
from repro_torch.kernels import leap_copy  # noqa: E402

PROGRAMS = ("begin_area", "copy_chunk", "commit_area", "force_migrate", "zero_fill")


def _area_state(seed):
    """A 2-region pool, blocks dense in region 0, random dirty and in-flight
    bits, and one area's operands: 6 blocks into 6 free slots of region 1."""
    rng = np.random.default_rng(seed)
    n, s = 24, 32
    pool = rng.normal(size=(2, s, 2, 8)).astype(np.float32)
    table = np.stack([np.zeros(n), np.arange(n)], 1).astype(np.int32)
    dirty, in_flight = rng.random(n) < 0.5, rng.random(n) < 0.5
    ids = rng.choice(n, size=6, replace=False)
    slots = rng.choice(s, size=6, replace=False)
    return (pool, table, dirty, in_flight), ids, slots


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("program", PROGRAMS)
def test_per_area_program_matches_jax(program, seed):
    clear_program_caches()
    leaves, ids, slots = _area_state(seed)
    js = jst.LeapState(*(jnp.asarray(x) for x in leaves))
    ts = before = T.LeapState.from_numpy(*leaves, "cpu")
    jids, jslots = jnp.asarray(ids, jnp.int32), jnp.asarray(slots, jnp.int32)
    tids, tslots = torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(slots.astype(np.int64))
    jv = tv = None
    if program == "begin_area":
        js, ts = jmig.begin_area(js, jids), tmig.begin_area(ts, tids)
    elif program == "copy_chunk":
        js, ts = jmig.copy_chunk(js, jids, jslots, 1), tmig.copy_chunk(ts, tids, tslots, 1)
    elif program == "commit_area":
        js, jv = jmig.commit_area(js, jids, jslots, 1)
        ts, tv = tmig.commit_area(ts, tids, tslots, 1)
    elif program == "force_migrate":
        js, ts = jmig.force_migrate(js, jids, jslots, 1), tmig.force_migrate(ts, tids, tslots, 1)
    else:
        js, ts = jmig.zero_fill(js, jslots, 1), tmig.zero_fill(ts, tslots, 1)
    assert ts is before  # updated in place
    for got, want in zip(ts.to_numpy(), (js.pool, js.table, js.dirty, js.in_flight)):
        np.testing.assert_array_equal(got, np.asarray(want))
    if jv is not None:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # one variant each side: the port keys its programs as the reference does
    assert tmig.program_cache_sizes()[program] == jmig.program_cache_sizes()[program] == 1


def test_force_migrate_gathers_before_it_scatters():
    """A force whose destination slots are other blocks' sources: every moved
    block carries the payload it had before the program ran."""
    leaves, _, _ = _area_state(5)
    pool, table, dirty, in_flight = leaves
    table[:4] = [[1, 0], [1, 1], [1, 2], [1, 3]]  # blocks 0..3 in region 1 slots 0..3
    ts = T.LeapState.from_numpy(pool, table, dirty, in_flight, "cpu")
    before = ts.pool[1, :4].clone()
    ids, slots = torch.tensor([0, 1, 2, 3]), torch.tensor([1, 2, 3, 0])  # a rotation
    tmig.force_migrate(ts, ids, slots, 1)
    torch.testing.assert_close(ts.pool[1, [1, 2, 3, 0]], before, rtol=0, atol=0)


def _drain(p, n, rng, io=3):
    p.leap(np.arange(n), 1)
    for _ in range(300):
        if all(s.done for s in p.sessions):
            break
        p.read(rng.choice(n, size=io, replace=False))
        p.tick()
        ids = rng.choice(n, size=io, replace=False)
        p.write(ids, rng.normal(size=(io, 4)).astype(np.float32))
        p.assert_equal()
    p.drain()
    p.assert_equal()


@pytest.mark.parametrize("huge", [1, 4], ids=["small", "huge"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["legacy", "batched", "megastep"])
def test_drain_matches_jax(mode, seed, huge):
    """Writes and reads every tick, escalation after two rejections, chunks
    of 4 blocks (legacy copies one ``copy_chunk`` a chunk) and tiering on."""
    n = 32
    cfg = dict(initial_area_blocks=8, chunk_blocks=4, budget_blocks_per_tick=8,
               max_attempts_before_force=2, fused_dispatch=mode, tiering=True)
    p = Pair(n, 48 if huge > 1 else 2 * n, cfg, huge_factor=huge, seed=seed)
    if huge > 1:
        for d in (p.j, p.t):
            assert d.adopt_huge(np.arange(n // huge)) == n // huge
    _drain(p, n, np.random.default_rng(seed))
    s = p.t.stats
    assert (p.t.host_placement() == 1).all()
    assert s.blocks_migrated + s.blocks_forced + s.blocks_cancelled == s.blocks_requested
    if huge > 1:
        assert s.huge_areas_committed > 0
    if mode == "legacy":
        assert s.dispatches > s.ticks  # one program a chunk and an area


@pytest.mark.parametrize("scheduler", ["sync", "sampling"])
def test_legacy_contender_policies_match_jax(scheduler):
    """Under legacy the sync and sampling policies force each area as it
    opens, into zero-filled slots (``zero_fill`` then ``force_migrate``),
    and free its sources at once."""
    n = 32
    p = Pair(n, 2 * n, dict(initial_area_blocks=8, budget_blocks_per_tick=8,
                            fused_dispatch="legacy"), scheduler=scheduler, seed=4)
    _drain(p, n, np.random.default_rng(4))
    s = p.t.stats
    assert s.blocks_forced == s.blocks_requested > 0


def test_port_three_generations_reach_the_same_outcome():
    """The reference's differential oracle on the port: one write schedule
    under megastep, batched and legacy; megastep and batched also make the
    same slot decisions, so their pools match bit for bit."""
    runs = {mode: _port_interleaved(mode, chunk_blocks=4)
            for mode in ("megastep", "batched", "legacy")}
    for drv, expected, _ in runs.values():
        assert (drv.host_placement() == 1).all() and drv.verify_mirror()
        np.testing.assert_array_equal(drv.read(np.arange(32), note=False).numpy(), expected)
        np.testing.assert_array_equal(expected, runs["megastep"][1])
        for req in drv.requests.values():
            assert req.done and req.committed + req.forced + req.cancelled == req.requested
    (m, _, _), (b, _, _), (legacy, _, _) = runs.values()
    for x, y in zip(m.state.to_numpy(), b.state.to_numpy()):
        np.testing.assert_array_equal(x, y)
    assert m.stats.dispatches <= b.stats.dispatches < legacy.stats.dispatches


def test_legacy_ppermute_drain_matches_jax_on_four_devices(tmp_path):
    """Every region's blocks leap to the next region under writes: one
    ``copy_chunk_ppermute`` a chunk, with static (src, dst) regions, on a
    4-region mesh; the JAX package's side runs on 4 host devices."""
    cfg_kw = dict(backend="ppermute", axis_name="data", fused_dispatch="legacy",
                  initial_area_blocks=4, chunk_blocks=2, budget_blocks_per_tick=12,
                  max_attempts_before_force=2, tiering=True)
    sched = _schedule(9, 8)
    np.savez(tmp_path / "sched.npz", **sched)
    params = dict(R=R, N=N, S=S, block=list(BLOCK), cfg=cfg_kw, scheduler="leap")
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_DRAIN), str(tmp_path / "sched.npz"),
         json.dumps(params), str(tmp_path / "jax.npz")],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.load(tmp_path / "jax.npz")

    before = leap_copy.gather_blocks.launches
    drv, handles, ticks = _port_ppermute_drain(sched, cfg_kw, "leap")
    assert leap_copy.gather_blocks.launches == before  # legacy: plain indexing
    assert ticks == int(want["ticks"]) < MAX_TICKS
    for name, got in zip(("pool", "table", "dirty", "in_flight"), drv.state.to_numpy()):
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    np.testing.assert_array_equal(drv.host_table(), want["host_table"])
    np.testing.assert_array_equal(drv.read(np.arange(N), note=False).numpy(), want["read"])
    np.testing.assert_allclose(drv.heat_snapshot(), want["heat"], **HEAT_TOL)
    stats = dataclasses.asdict(drv.stats)
    assert stats == ast.literal_eval(str(want["stats"]))
    assert [dataclasses.asdict(h.progress()) for h in handles] == ast.literal_eval(
        str(want["progress"]))
    s = drv.stats
    assert s.dirty_rejections > 0 and s.dispatches > 4 * s.ticks
    assert (drv.host_placement() == (sched["place"] + 1) % R).all()
