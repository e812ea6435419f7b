"""The port's compile model for every migration program against the JAX
package's, on the CPU.

Every program of the reference's ``_PROGRAMS`` is a ``graphs.Program`` in
the port (``migrator.PROGRAMS``), keyed on what the reference's jit keys
on.  Here:

* each program but the megastep (``tests/test_torch_graphs.py``) and the
  two ppermute copies (below) on one state, at two lengths and again at the
  first: operands padded where the reference's dispatch stage pads them
  (lane 0 repeated; the reference's heat pass pads with an out-of-bounds id
  of weight 0, the port's with lane 0 of weight 0), the state and the
  verdicts bit for bit (heat within 1e-6), and as many variants as the
  reference compiles;
* the force's payload moving through one ``copy_blocks`` (K1) call over
  the flat pool view, with no payload temporary (ROADMAP F2), and forced
  batches with pad lanes, promotions and ``SyncResharder`` moves bit for
  bit against the reference;
* megastep, batched and legacy drains (small and two-tier pools, cold and
  warmed): every program's variant count and ``jit_cache_misses`` equal;
* batched and legacy ppermute drains on a 4-region mesh against the JAX
  package on 4 host devices in a subprocess: state, stats with
  ``jit_cache_misses`` and every program's variant count equal.
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

from repro.core import migrator as jmig  # noqa: E402
from repro.core import state as jst  # noqa: E402
from repro.core.adaptive import bucket_size, pad_to_bucket  # noqa: E402
from repro_torch.core import migrator as tmig  # noqa: E402
from repro_torch.core import state as tst  # noqa: E402

from test_torch_baselines import both, outcome  # noqa: E402
from test_torch_driver import HEAT_TOL, REPO, Pair, clear_program_caches  # noqa: E402
from test_torch_ppermute import BLOCK, MAX_TICKS, N, R, S, _port_ppermute_drain, _schedule  # noqa: E402

G = 4  # run length and group size of the huge-tier programs
NB, SL = 24, 32  # blocks (dense in region 0) and slots a region


def _state(seed):
    rng = np.random.default_rng(seed)
    pool = rng.normal(size=(2, SL, 2, 8)).astype(np.float32)
    table = np.stack([np.zeros(NB), np.arange(NB)], 1).astype(np.int32)
    return pool, table, rng.random(NB) < 0.5, rng.random(NB) < 0.5


def _pair_state(seed):
    leaves = _state(seed)
    return jst.LeapState(*(jnp.asarray(x) for x in leaves)), tst.LeapState.from_numpy(*leaves,
                                                                                   "cpu")


def _bucketed(*arrays):
    return pad_to_bucket(bucket_size(len(arrays[0])), *arrays)


def _operands(program, n, rng, free):
    """``(jax operands, port operands, static)`` of one call at ``n`` real
    lanes: distinct blocks into slots of region 1 taken from ``free`` (so
    never a live block's slot), padded where the reference's dispatch
    pads."""
    ids = rng.choice(NB, size=n, replace=False)
    slots = np.array([free.pop() for _ in range(n)])
    ones = np.ones(n, np.int64)
    if program in ("begin_area",):
        ops = (ids,)
    elif program in ("copy_chunk", "commit_area", "force_migrate"):
        ops = (ids, slots)
    elif program == "zero_fill":
        ops = _bucketed(slots)
    elif program == "begin_areas":
        ops = _bucketed(ids)
    elif program == "fused_copy":
        ops = _bucketed(ids, SL + slots)  # blocks sit at region 0 slot == id
    elif program in ("commit_areas", "force_areas"):
        ops = _bucketed(ids, ones, slots)
    elif program == "fused_copy_runs":
        src = rng.choice(NB // G, size=n, replace=False) * G
        dst = SL + rng.choice(SL // G, size=n, replace=False) * G
        ops = _bucketed(src, dst)
    elif program == "commit_groups":
        groups = rng.choice(NB // G, size=n, replace=False)
        starts = rng.choice(SL // G, size=n, replace=False) * G
        k = bucket_size(n)
        members = (groups[:, None] * G + np.arange(G)).reshape(n, G)
        members = np.concatenate([members, np.repeat(members[:1], k - n, 0)]).reshape(-1)
        ops = (members, *pad_to_bucket(k, ones, starts))
    else:
        raise AssertionError(program)
    static = {"copy_chunk": (1,), "commit_area": (1,), "force_migrate": (1,), "zero_fill": (1,),
              "fused_copy_runs": (G,), "commit_groups": (G,)}.get(program, ())
    jax_ops = tuple(jnp.asarray(np.asarray(x), jnp.int32) for x in ops)
    port_ops = tuple(torch.from_numpy(np.asarray(x, np.int64)) for x in ops)
    return jax_ops, port_ops, static


STATE_PROGRAMS = ("begin_area", "copy_chunk", "commit_area", "force_migrate", "zero_fill",
                  "begin_areas", "fused_copy", "fused_copy_runs", "commit_areas",
                  "commit_groups", "force_areas")


def _same(js, ts):
    for got, want in zip(ts.to_numpy(), (js.pool, js.table, js.dirty, js.in_flight)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("program", STATE_PROGRAMS)
def test_program_matches_jax(program):
    """Three calls (two lengths, then the first again): the state and the
    verdicts bit for bit after each, one variant a length on both sides."""
    clear_program_caches()
    js, ts = _pair_state(1)
    rng = np.random.default_rng(2)
    free = list(rng.permutation(SL))
    jfn, tfn = getattr(jmig, program), getattr(tmig, program)
    for n in (6, 3, 6):  # buckets 16, 4, 16 where padded
        jops, tops, static = _operands(program, n, rng, free)
        jout, tout = jfn(js, *jops, *static), tfn(ts, *tops, *static)
        if isinstance(jout, tuple):
            (js, jv), (ts, tv) = jout, tout
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        else:
            js, ts = jout, tout
        _same(js, ts)
    assert tmig.program_cache_sizes()[program] == jmig.program_cache_sizes()[program] == 2
    assert tmig.program_cache_size() == jmig.program_cache_size() == 2


def test_heat_update_matches_jax():
    """The standalone heat pass at two buckets and the first again: the
    reference's pad lanes hold an out-of-bounds id of weight 0, the port's
    repeat lane 0 with weight 0; planes within 1e-6, two variants each."""
    clear_program_caches()
    rng = np.random.default_rng(3)
    heat = rng.random(NB).astype(np.float32)
    jheat, theat = jnp.asarray(heat), torch.from_numpy(heat.copy())
    for k in (10, 3, 12):  # buckets 16, 4, 16
        ids = rng.integers(0, NB, size=k)
        w = rng.random(k).astype(np.float32)
        b = bucket_size(k)
        jids = np.full(b, NB, np.int32)
        jids[:k] = ids
        (tids,) = pad_to_bucket(b, ids)
        wpad = np.concatenate([w, np.zeros(b - k, np.float32)])
        jheat = jmig.heat_update(jheat, jnp.asarray(jids), jnp.asarray(wpad), 0.8)
        out = tmig.heat_update(theat, torch.from_numpy(tids.astype(np.int64)),
                               torch.from_numpy(wpad), 0.8)
        assert out is theat  # in place
        np.testing.assert_allclose(theat.numpy(), np.asarray(jheat), **HEAT_TOL)
    sizes = tmig.program_cache_sizes()
    assert sizes["heat_update"] == jmig.program_cache_sizes()["heat_update"] == 2
    assert sum(sizes.values()) == 2


# ---------------------------------------------------------------------------
# F2: the force moves its payload with one K1 call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("program", ["force_areas", "force_migrate", "megastep"])
def test_force_moves_its_payload_through_copy_blocks(program, monkeypatch):
    """One ``copy_blocks`` call over the flat pool view with the flat ids of
    the table as it stands and of the destinations; no other read of the
    pool's payload."""
    calls = []
    inner = tmig.ops.copy_blocks_impl

    def tap(pool, src, dst, **kw):
        calls.append((pool.data_ptr(), tuple(pool.shape), src.tolist(), dst.tolist()))
        return inner(pool, src, dst, **kw)

    monkeypatch.setattr(tmig.ops, "copy_blocks_impl", tap)
    _, ts = _pair_state(4)
    ids, slots = np.array([5, 9, 2]), np.array([30, 1, 17])
    before = ts.pool.clone()
    t = lambda x: torch.from_numpy(np.asarray(x, np.int64))  # noqa: E731
    if program == "force_areas":  # padded to 4 lanes: lane 0 repeated
        (pid, preg, pslot) = pad_to_bucket(4, ids, np.ones(3), slots)
        tmig.force_areas(ts, t(pid), t(preg), t(pslot))
        want = (list(pid), list(SL + pslot))
    elif program == "force_migrate":
        tmig.force_migrate(ts, t(ids), t(slots), 1)
        want = (list(ids), list(SL + slots))
    else:
        empty = t(np.zeros(0))
        ops = [empty] * 8 + [t(ids), t(np.ones(3)), t(slots)] + [empty] * 4
        tmig.megastep(ts, *ops, torch.zeros(0), empty, torch.zeros(0))
        want = (list(ids), list(SL + slots))
    assert calls == [(ts.pool.data_ptr(), (2 * SL, 2, 8), *want)]
    torch.testing.assert_close(ts.pool[1, slots], before[0, ids], rtol=0, atol=0)
    assert ts.table[ids].tolist() == [[1, s] for s in slots]
    assert not ts.dirty[ids].any() and not ts.in_flight[ids].any()


@pytest.mark.parametrize("mode", ["megastep", "batched", "legacy"])
def test_forced_batches_match_jax(mode):
    """Escalation after one rejection under a write to every block each
    tick: every area forced, in batches padded to buckets (batched:
    ``force_areas``; legacy: ``force_migrate``; megastep: its force phase)."""
    n = 24
    p = Pair(n, 2 * n + 8, dict(initial_area_blocks=6, budget_blocks_per_tick=6,
                                max_attempts_before_force=1, fused_dispatch=mode), seed=6)
    rng = np.random.default_rng(6)
    p.leap(np.arange(n), 1)
    for _ in range(100):
        if all(s.done for s in p.sessions):
            break
        p.tick()
        p.write(np.arange(n), rng.normal(size=(n, 4)).astype(np.float32))
        p.assert_equal()
    p.drain()
    p.assert_equal()
    assert p.t.stats.blocks_forced > 0 and (p.t.host_placement() == 1).all()
    assert tmig.program_cache_sizes() == jmig.program_cache_sizes()


@pytest.mark.parametrize("mode", ["megastep", "batched", "legacy"])
def test_promotions_match_jax(mode):
    """Cold aligned groups promoted every tick through ``force_areas`` at
    their real length (G lanes), beside a drain with reads and writes."""
    n = 24
    p = Pair(n, 32, dict(budget_blocks_per_tick=8, tiering=True, promote_per_tick=2,
                         fused_dispatch=mode), n_regions=3, huge_factor=G, topology=True,
             placement=np.full(n, 2, np.int32), seed=12)
    rng = np.random.default_rng(12)
    p.leap(np.arange(n // 2), 0)
    for step in range(100):
        if all(s.done for s in p.sessions) and step > 6:
            break
        p.read(rng.choice(n, size=3, replace=False))
        if step % 4 == 0:
            ids = rng.choice(n, size=2, replace=False)
            p.write(ids, rng.normal(size=(2, 4)).astype(np.float32))
        p.tick()
        p.assert_equal()
    p.drain()
    p.assert_equal()
    assert p.t.stats.promotions > 0
    assert tmig.program_cache_sizes() == jmig.program_cache_sizes()
    assert tmig.program_cache_sizes()["force_areas"] > 0


def _sync_drain(P, mode):
    """``SyncResharder`` over a pool whose first blocks a live leap holds:
    the whole-pool force, then the live leap drains."""
    cfg = P.core.PoolConfig(2, 40, (4,))
    data = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
    drv = P.driver(cfg, 32, np.zeros(32), data,
                   leap=P.core.LeapConfig(initial_area_blocks=4, budget_blocks_per_tick=4,
                                          fused_dispatch=mode))
    s = drv.default_session()
    s.leap(np.arange(6), 1)
    s.tick()
    s.poll(block=True)
    r = P.core.SyncResharder(cfg).migrate_driver(drv, np.arange(32), 1)
    assert s.drain()
    assert (drv.host_placement() == 1).all()
    return dict(migrated=np.asarray(r.migrated), failed=np.asarray(r.failed),
                read=np.asarray(drv.read(P.ids(np.arange(32)), note=False)), out=outcome(drv))


@pytest.mark.parametrize("mode", ["megastep", "batched", "legacy"])
def test_sync_resharder_matches_jax(mode):
    """``SyncResharder``'s escalated, zero-filled moves through each
    generation's force: bit for bit, misses included."""
    got = both(_sync_drain, mode)
    assert len(got["failed"]) > 0 and len(got["migrated"]) + len(got["failed"]) == 32


# ---------------------------------------------------------------------------
# Drains: every program's variant count and the misses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm_dispatch"])
@pytest.mark.parametrize("huge", [1, G], ids=["small", "two_tier"])
@pytest.mark.parametrize("mode", ["megastep", "batched", "legacy"])
def test_drain_variant_counts_match_jax(mode, huge, warm):
    """Writes every tick, escalation after two rejections, tiering on; each
    program's variants and ``jit_cache_misses`` (``Pair.assert_equal``)
    equal to the reference's after every tick."""
    n = 32
    p = Pair(n, 48 if huge > 1 else 2 * n,
             dict(initial_area_blocks=8, chunk_blocks=4, budget_blocks_per_tick=8,
                  max_attempts_before_force=2, fused_dispatch=mode, tiering=True,
                  warm_dispatch=warm), huge_factor=huge, seed=7)
    if huge > 1:
        for d in (p.j, p.t):
            assert d.adopt_huge(np.arange(n // huge)) == n // huge
    rng = np.random.default_rng(7)
    p.leap(np.arange(n), 1)
    for _ in range(200):
        if all(s.done for s in p.sessions):
            break
        p.read(rng.choice(n, size=3, replace=False))
        p.tick()
        ids = rng.choice(n, size=3, replace=False)
        p.write(ids, rng.normal(size=(3, 4)).astype(np.float32))
        p.assert_equal()
        assert tmig.program_cache_sizes() == jmig.program_cache_sizes()
    p.drain()
    p.assert_equal()
    sizes = tmig.program_cache_sizes()
    assert sizes == jmig.program_cache_sizes()
    copy, commit = ("fused_copy_runs", "commit_groups") if huge > 1 else ("", "")
    used = {"megastep": {"megastep"},
            "batched": {"begin_areas", copy or "fused_copy", commit or "commit_areas"},
            "legacy": {"begin_area", copy or "copy_chunk", commit or "commit_area"}}[mode]
    assert all(sizes[name] > 0 for name in used), sizes
    assert p.t.stats.jit_cache_misses == p.j.stats.jit_cache_misses


# ---------------------------------------------------------------------------
# ppermute drains against the JAX package on 4 host devices
# ---------------------------------------------------------------------------

# Runs in a fresh process with 4 host devices; writes the stats and every
# program's variant count.
JAX_PPERMUTE = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
import repro.core as J
from repro.core import migrator

sched, params = np.load(sys.argv[1]), json.loads(sys.argv[2])
R, N, S = params["R"], params["N"], params["S"]
mesh = jax.make_mesh((R,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
pc = J.PoolConfig(R, S, tuple(params["block"]), region_axis="data")
place = sched["place"]
state = jax.tree.map(jax.device_put, J.init_state(pc, N, place), J.state_sharding(pc, mesh))
state = J.leap_write(state, jnp.arange(N), jnp.asarray(sched["data"]))
drv = J.MigrationDriver(state, pc, J.LeapConfig(**params["cfg"]), mesh=mesh)
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
print(json.dumps(dict(stats=repr(dataclasses.asdict(drv.stats)),
                      sizes=migrator.program_cache_sizes(),
                      table=np.asarray(drv.state.table).tolist())))
"""


@pytest.mark.parametrize("mode", ["batched", "legacy"])
def test_ppermute_drain_variant_counts_match_jax(tmp_path, mode):
    """Every region's blocks leap to the next region under writes: one
    ``fused_copy_ppermute`` per region pair a tick (padded), or one
    ``copy_chunk_ppermute`` a chunk (real lengths)."""
    cfg_kw = dict(backend="ppermute", axis_name="data", fused_dispatch=mode,
                  initial_area_blocks=4, chunk_blocks=2, budget_blocks_per_tick=12,
                  max_attempts_before_force=2, tiering=True)
    sched = _schedule(11, 8)
    np.savez(tmp_path / "sched.npz", **sched)
    params = dict(R=R, N=N, S=S, block=list(BLOCK), cfg=cfg_kw)
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_PPERMUTE), str(tmp_path / "sched.npz"),
         json.dumps(params)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    drv, _, ticks = _port_ppermute_drain(sched, cfg_kw, "leap")  # empties the port's caches
    assert ticks < MAX_TICKS
    assert dataclasses.asdict(drv.stats) == ast.literal_eval(want["stats"])
    np.testing.assert_array_equal(drv.state.table.numpy(), np.asarray(want["table"]))
    sizes = tmig.program_cache_sizes()
    assert sizes == want["sizes"]
    copy = "fused_copy_ppermute" if mode == "batched" else "copy_chunk_ppermute"
    assert sizes[copy] > 0
