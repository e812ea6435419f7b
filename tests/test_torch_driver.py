"""The port as a whole: the same schedules through both ``LeapSession`` s.

Each schedule starts both packages from the same bytes and drives them with
blocking harvest (``poll(block=True)`` after every tick), so that verdicts
arrive at the same tick on both sides.  Then the host table, the device
state, ``MigrationStats`` and every handle's progress must be equal, and the
heat plane equal within rtol = atol = 1e-6.  ``jit_cache_misses`` is
compared too, under every dispatch generation, with both packages' caches
of every migration program cleared when the pair is built.
The import checks keep the port free of JAX and of the JAX package.
"""

import dataclasses
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import migrator as jmig  # noqa: E402
from repro_torch.core import migrator as tmig  # noqa: E402
from repro.topology import NumaTopology as JTopo  # noqa: E402
from repro_torch.topology import NumaTopology as TTopo  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
HEAT_TOL = dict(rtol=1e-6, atol=1e-6)


def clear_program_caches():
    """Empty every migration program's variant cache in both packages."""
    for name in jmig._PROGRAMS:
        jmig._PROGRAMS[name].clear_cache()
    tmig.clear_program_caches()


class Pair:
    """One driver per package over equal pools; every call goes to both.

    ``topology``: False (none), True (``cxl_pooled(2, 1)``), or a function
    of a package's ``NumaTopology`` class that builds one.  ``scheduler``: a
    name, or a ``(jax, port)`` pair of policy instances.
    """

    def __init__(self, n_blocks, slots, cfg_kw, *, block_shape=(4,), n_regions=2,
                 huge_factor=1, placement=None, topology=False, scheduler=None, seed=0):
        rng = np.random.default_rng(seed)
        placement = np.zeros(n_blocks, np.int32) if placement is None else placement
        data = rng.normal(size=(n_blocks,) + block_shape).astype(np.float32)
        if topology is True:
            topology = lambda M: M.cxl_pooled(2, 1)  # noqa: E731
        jtopo = topology(JTopo) if topology else None
        ttopo = topology(TTopo) if topology else None
        jsched, tsched = scheduler if isinstance(scheduler, tuple) else (scheduler, scheduler)
        jpc = J.PoolConfig(n_regions, slots, block_shape, huge_factor=huge_factor, topology=jtopo)
        tpc = T.PoolConfig(n_regions, slots, block_shape, huge_factor=huge_factor, topology=ttopo)
        js = J.leap_write(J.init_state(jpc, n_blocks, placement), jnp.arange(n_blocks),
                          jnp.asarray(data))
        ts = T.LeapState.from_numpy(*(np.asarray(x) for x in
                                      (js.pool, js.table, js.dirty, js.in_flight)), device="cpu")
        # every program's cache starts empty on both sides: equal histories,
        # equal misses
        clear_program_caches()
        self.j = J.MigrationDriver(js, jpc, J.LeapConfig(**cfg_kw), scheduler=jsched)
        self.t = T.MigrationDriver(ts, tpc, T.LeapConfig(**cfg_kw), scheduler=tsched)
        self.sessions = (self.j.default_session(), self.t.default_session())
        self.handles = []
        self.expected = data.copy()
        self.n_blocks = n_blocks

    def leap(self, ids, dst, **kw):
        pair = tuple(s.leap(ids, dst, **kw) for s in self.sessions)
        self.handles.append(pair)
        return pair

    def tick(self):
        for s in self.sessions:
            s.tick()
            s.poll(block=True)

    def write(self, ids, vals):
        self.j.write(jnp.asarray(ids), jnp.asarray(vals))
        self.t.write(ids, torch.from_numpy(vals))
        self.expected[ids] = vals

    def read(self, ids):
        got = self.t.read(ids).numpy()
        np.testing.assert_array_equal(got, np.asarray(self.j.read(jnp.asarray(ids))))
        np.testing.assert_array_equal(got, self.expected[ids])

    def drain(self):
        assert all(s.drain() for s in self.sessions)

    def assert_equal(self):
        j, t = self.j, self.t
        np.testing.assert_array_equal(t.host_table(), j.host_table())
        for got, want in zip(t.state.to_numpy(), (j.state.pool, j.state.table,
                                                  j.state.dirty, j.state.in_flight)):
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_allclose(t.heat_snapshot(), j.heat_snapshot(), **HEAT_TOL)
        js, ts = dataclasses.asdict(j.stats), dataclasses.asdict(t.stats)
        assert ts == js
        for hj, ht in self.handles:
            assert dataclasses.asdict(ht.progress()) == dataclasses.asdict(hj.progress())
            assert ht.status.value == hj.status.value
        assert t.verify_mirror() and j.verify_mirror() and t.verify_tiers()
        np.testing.assert_array_equal(
            t.read(np.arange(self.n_blocks), note=False).numpy(), self.expected
        )


@pytest.mark.parametrize("scheduler", ["leap", "sync", "sampling"])
def test_interleaved_writes_with_force_escalation(scheduler):
    """``_run_interleaved`` of the megastep tests, at eight writes per tick
    and escalation after two rejections; the sync and sampling policies add
    fresh-destination zero fills, forced moves and busy-block skips."""
    n = 32
    p = Pair(n, 2 * n, dict(initial_area_blocks=8, chunk_blocks=4, budget_blocks_per_tick=8,
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
    if scheduler == "leap":
        assert p.t.stats.dirty_rejections > 0 and p.t.stats.blocks_forced > 0
    s = p.t.stats
    assert s.blocks_migrated + s.blocks_forced + s.blocks_cancelled == s.blocks_requested
    assert 0.0 < s.dispatches_per_tick <= 1.0


def test_huge_tier_drain_under_writes():
    """Two-tier pool: group commits and run copies, rejected runs retried
    whole and then demoted to small blocks under write pressure."""
    G, n = 4, 32
    p = Pair(n, 48, dict(initial_area_blocks=8, budget_blocks_per_tick=8), huge_factor=G, seed=5)
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


def test_tiering_drain_with_reads_and_promotion():
    """Heat phase on every tick (reads and writes feed it), a cxl topology
    with link budgets, and promotions of cold aligned groups."""
    G, n = 4, 24
    p = Pair(n, 32, dict(budget_blocks_per_tick=8, tiering=True, tier_heat_decay=0.8,
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


def test_port_refuses_dispatch_generations_it_lacks():
    # every generation of the JAX package is ported: legacy constructs too
    for kw in (dict(fused_dispatch="legacy"), dict(fused_dispatch=False),
               dict(fused_dispatch="legacy", backend="ppermute")):
        assert T.LeapConfig(**kw).dispatch_mode == "legacy"
    with pytest.raises(ValueError):
        T.LeapConfig(fused_dispatch="warp")
    with pytest.raises(ValueError):
        T.LeapConfig(copy_impl="pallas")
    with pytest.raises(NotImplementedError, match="ROADMAP"):  # a pool sharded per device
        T.make_region_mesh(2, ["cpu", "meta"])
    assert T.LeapConfig(fused_dispatch="batched").dispatch_mode == "batched"
    assert T.LeapConfig(backend="ppermute").dispatch_mode == "batched"


# ---------------------------------------------------------------------------
# Imports
# ---------------------------------------------------------------------------

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    # every module file, those of the namespace packages (no __init__.py,
    # as in the JAX package's data/ and distributed/) included
    code = (
        "import importlib, pathlib, sys, repro_torch\n"
        "root = pathlib.Path(repro_torch.__file__).parent\n"
        "for f in sorted(root.rglob('*.py')):\n"
        "    parts = f.relative_to(root.parent).with_suffix('').parts\n"
        "    importlib.import_module('.'.join(parts[:-1] if parts[-1] == '__init__' else parts))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_have_no_jax_or_repro_imports():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [
        f"{f.relative_to(REPO)}: {m.group(0).strip()}"
        for f in files
        for m in _IMPORT.finditer(f.read_text())
    ]
    assert not offenders, offenders
