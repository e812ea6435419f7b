"""The paper's contenders (``SyncResharder``, ``AutoBalancer``) and the fault
drain plan of the port against the JAX package.

Each case of ``tests/test_core_baselines.py``, and the three ``drain_plan``
cases of ``tests/test_topology.py``, runs as one scenario written once
against a package surface (:class:`Pkg`): once over the JAX package, once
over the port on the CPU.  The port's run must pass the reference test's
own assertions and the JAX package's ``InvariantChecker``, and end in the
same state as the reference's run: pools, tables, dirty and in-flight bits,
host table, ``MigrationStats`` (``jit_cache_misses`` too: both packages'
program caches are emptied before each side runs) and the scenario's own
results, bit for bit.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.chaos import InvariantChecker  # noqa: E402
from repro.core.pipeline import busy_mask as jbusy  # noqa: E402
from repro.distributed import fault as jfault  # noqa: E402
from repro.tiering import policy as jtiering  # noqa: E402
from repro.topology import NumaTopology as JTopo  # noqa: E402
from repro_torch.core.pipeline import busy_mask as tbusy  # noqa: E402
from repro_torch.distributed import fault as tfault  # noqa: E402
from repro_torch.tiering import policy as ttiering  # noqa: E402
from repro_torch.topology import NumaTopology as TTopo  # noqa: E402

from test_torch_driver import clear_program_caches  # noqa: E402


class Pkg:
    """One package's surface, as the scenarios use it: ``core``, ``Topo``,
    ``fault``, ``tiering``, and state builders that hide how each package takes arrays
    (the port's states live on the CPU here)."""

    def __init__(self, name):
        self.name = name
        self.torch = name == "torch"
        self.core = T if self.torch else J
        self.Topo = TTopo if self.torch else JTopo
        self.fault = tfault if self.torch else jfault
        self.tiering = ttiering if self.torch else jtiering
        self.busy_mask = tbusy if self.torch else jbusy

    def __repr__(self):
        return self.name

    def init(self, cfg, n, placement):
        placement = np.asarray(placement, np.int32)
        if self.torch:
            return T.init_state(cfg, n, placement, device="cpu")
        return J.init_state(cfg, n, placement)

    def write(self, state, data):
        n = len(data)
        if self.torch:
            return T.leap_write(state, np.arange(n), torch.from_numpy(data))
        return J.leap_write(state, jnp.arange(n), jnp.asarray(data))

    def ids(self, x):
        return torch.as_tensor(np.asarray(x, np.int64)) if self.torch else jnp.asarray(x)

    def values(self, x):
        return torch.from_numpy(np.asarray(x)) if self.torch else jnp.asarray(x)

    def driver(self, cfg, n, placement, data=None, leap=None, **kw):
        state = self.init(cfg, n, placement)
        if data is not None:
            state = self.write(state, data)
        return self.core.MigrationDriver(state, cfg, leap or self.core.LeapConfig(), **kw)


JAX, PORT = Pkg("jax"), Pkg("torch")


def outcome(drv) -> dict:
    """Everything the two packages must agree on after a scenario."""
    st = drv.state
    if hasattr(st, "to_numpy"):
        leaves = st.to_numpy()
    else:
        leaves = tuple(np.asarray(x) for x in (st.pool, st.table, st.dirty, st.in_flight))
    stats = dataclasses.asdict(drv.stats)
    return dict(leaves=leaves, host_table=drv.host_table(), stats=stats,
                heat=drv.heat_snapshot())


def assert_same(a, b, path="result"):
    """Deep equality of scenario results: numpy arrays bit for bit, heat
    planes within rtol = atol = 1e-6."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if path.endswith(".heat"):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=path)
    else:
        assert a == b, (path, a, b)


def both(scenario, *args):
    """Run ``scenario(P, *args)`` over each package, each from empty program
    caches; results must agree."""
    clear_program_caches()
    want = scenario(JAX, *args)
    clear_program_caches()
    got = scenario(PORT, *args)
    assert_same(want, got)
    return got


def make(P, n_blocks=8, n_regions=2, slots=16):
    cfg = P.core.PoolConfig(n_regions, slots, (4,))
    data = np.arange(n_blocks * 4, dtype=np.float32).reshape(n_blocks, 4)
    return cfg, P.driver(cfg, n_blocks, np.zeros(n_blocks), data), data


def res(r) -> dict:
    return dataclasses.asdict(r)


# ---------------------------------------------------------------------------
# SyncResharder: the move_pages() analogue
# ---------------------------------------------------------------------------


def _sync_moves(P):
    cfg, drv, data = make(P)
    r = P.core.SyncResharder(cfg).migrate_driver(drv, np.arange(8), dst_region=1)
    assert len(r.migrated) == 8 and len(r.failed) == 0
    assert (drv.host_placement() == 1).all()
    InvariantChecker(drv).check_final(expected=data)
    assert r.bytes_touched == 2 * r.bytes_copied  # the fresh-allocation zero pass
    assert drv.stats.blocks_forced == 8 and drv.stats.blocks_migrated == 0
    return dict(res=res(r), out=outcome(drv))


def test_sync_reshard_moves_and_preserves():
    both(_sync_moves)


def _sync_busy(P):
    cfg, drv, data = make(P)
    drv.state = P.core.migrator.begin_area(drv.state, P.ids([2, 5]))  # blocks 2, 5 busy
    r = P.core.SyncResharder(cfg).migrate_driver(drv, np.arange(8), dst_region=1)
    assert sorted(r.failed.tolist()) == [2, 5]  # no retry: unreliable
    placement = drv.host_placement()
    assert placement[2] == 0 and placement[5] == 0
    assert (placement[[0, 1, 3, 4, 6, 7]] == 1).all()
    return dict(res=res(r), out=outcome(drv))


def test_sync_reshard_skips_busy_blocks():
    both(_sync_busy)


def _sync_claimed(P):
    cfg, drv, data = make(P)
    sess = drv.default_session()
    h = sess.leap(np.asarray([0, 1]), 1)  # queued, epoch not yet open
    r = P.core.SyncResharder(cfg).migrate_driver(drv, np.arange(8), dst_region=1)
    assert sorted(r.failed.tolist()) == [0, 1]
    assert sorted(r.migrated.tolist()) == [2, 3, 4, 5, 6, 7]
    assert h.wait()  # the leap request still completes on its own
    assert (drv.host_placement() == 1).all()
    InvariantChecker(drv).check_final(expected=data)
    return dict(res=res(r), out=outcome(drv), progress=dataclasses.asdict(h.progress()))


def test_sync_reshard_skips_blocks_claimed_by_live_leap_requests():
    both(_sync_claimed)


def _sync_pooled(P):
    cfg, drv, _ = make(P)
    r = P.core.SyncResharder(cfg, fresh_alloc=False).migrate_driver(drv, np.arange(4), 1)
    assert r.bytes_touched == r.bytes_copied
    return dict(res=res(r), out=outcome(drv))


def test_sync_reshard_pooled_mode_no_zero_pass():
    both(_sync_pooled)


def _sync_out_of_slots(P):
    cfg = P.core.PoolConfig(2, 8, (4,))
    drv = P.driver(cfg, 14, [0] * 7 + [1] * 7)
    with pytest.raises(RuntimeError, match="out of slots"):
        P.core.SyncResharder(cfg).migrate_driver(drv, np.arange(7), dst_region=1)
    return outcome(drv)


def test_sync_reshard_out_of_slots_raises():
    both(_sync_out_of_slots)


def _sync_tiered(P):
    cfg = P.core.PoolConfig(2, 32, (4,), huge_factor=4)
    data = np.arange(64, dtype=np.float32).reshape(16, 4)
    drv = P.driver(cfg, 16, np.zeros(16), data)
    assert drv.adopt_huge(np.arange(4)) == 4
    r = P.core.SyncResharder(cfg).migrate_driver(drv, np.arange(16), dst_region=1)
    assert len(r.migrated) == 16 and len(r.failed) == 0
    assert (drv.host_placement() == 1).all()
    InvariantChecker(drv).check_final(expected=data)
    assert drv.stats.demotions == 4 and drv.stats.blocks_forced == 16
    return dict(res=res(r), out=outcome(drv))


def test_sync_reshard_on_tiered_pool_splits_huge_mappings():
    both(_sync_tiered)


# ---------------------------------------------------------------------------
# AutoBalancer: the auto-NUMA analogue
# ---------------------------------------------------------------------------


def _ab_idle(P):
    cfg, drv, data = make(P)
    ab = P.core.AutoBalancer(cfg, 8, P.core.AutoBalanceConfig(hot_threshold=3))
    for _ in range(4):
        ab.observe_driver(drv, np.asarray([0, 1]), reader_region=1)
    moved = ab.scan_driver(drv)
    assert moved == 2
    placement = drv.host_placement()
    assert placement[0] == 1 and placement[1] == 1
    InvariantChecker(drv).check_final(expected=data)
    assert ab.blocks_migrated == 2 and ab.bytes_copied == 2 * cfg.block_bytes
    assert drv.stats.blocks_forced == 2
    return dict(moved=moved, counts=ab.remote_counts.copy(), out=outcome(drv))


def test_autobalancer_migrates_hot_blocks_when_idle():
    both(_ab_idle)


def _ab_pressure(P):
    cfg, drv, _ = make(P)
    ab = P.core.AutoBalancer(cfg, 8, P.core.AutoBalanceConfig(hot_threshold=1,
                                                              pressure_threshold=0.1))
    ab.observe_driver(drv, np.arange(8), reader_region=1)
    ab.observe_writes(100)  # heavy write burst
    first = ab.scan_driver(drv)
    assert first == 0  # "waits for times of little load"
    second = ab.scan_driver(drv)
    assert second > 0  # pressure cleared
    return dict(scans=[first, second], out=outcome(drv))


def test_autobalancer_defers_under_write_pressure():
    both(_ab_pressure)


def _ab_bidirectional(P):
    # Both directions move in ONE scan tick, so one move's freshly freed
    # source slot is the other direction's zero-filled destination: the zero
    # pass must never land before the force has read the slot.
    cfg = P.core.PoolConfig(2, 16, (4,))
    data = np.arange(32, dtype=np.float32).reshape(8, 4) + 1.0
    drv = P.driver(cfg, 8, [0, 0, 0, 0, 1, 1, 1, 1], data)
    ab = P.core.AutoBalancer(cfg, 8, P.core.AutoBalanceConfig(hot_threshold=1))
    ab.observe_driver(drv, np.asarray([0]), reader_region=1)  # 0 -> region 1
    ab.observe_driver(drv, np.asarray([4]), reader_region=0)  # 4 -> region 0
    assert ab.scan_driver(drv) == 2
    InvariantChecker(drv).check_final(expected=data)
    return outcome(drv)


def test_autobalancer_bidirectional_scan_preserves_payloads():
    both(_ab_bidirectional)


def _ab_unrelated(P):
    cfg = P.core.PoolConfig(2, 64, (4,))
    drv = P.driver(cfg, 40, np.zeros(40),
                   leap=P.core.LeapConfig(initial_area_blocks=4, budget_blocks_per_tick=4))
    sess = drv.default_session()
    background = sess.leap(np.arange(8, 40), 1, priority=-1)
    ab = P.core.AutoBalancer(cfg, 40, P.core.AutoBalanceConfig(hot_threshold=1))
    ab.observe_driver(drv, np.arange(4), reader_region=1)
    moved = ab.scan_driver(drv)
    assert moved == 4
    assert not background.done  # the scan waited for its own moves only
    mid = outcome(drv)
    assert sess.drain()
    return dict(moved=moved, mid=mid, out=outcome(drv))


def test_autobalancer_scan_does_not_drain_unrelated_requests():
    both(_ab_unrelated)


def _ab_capacity(P):
    cfg = P.core.PoolConfig(2, 8, (4,))
    drv = P.driver(cfg, 14, [0] * 7 + [1] * 7)
    ab = P.core.AutoBalancer(cfg, 14, P.core.AutoBalanceConfig(hot_threshold=1))
    ab.observe_driver(drv, np.arange(7), reader_region=1)
    moved = ab.scan_driver(drv)  # only one free slot on region 1
    assert moved == 1
    InvariantChecker(drv).check_final()
    return dict(moved=moved, out=outcome(drv))


def test_autobalancer_respects_destination_capacity():
    both(_ab_capacity)


# ---------------------------------------------------------------------------
# The fault drain plan (tests/test_topology.py)
# ---------------------------------------------------------------------------


def _topo_driver(P, topo, n_regions, n_blocks, slots):
    cfg = P.core.PoolConfig(n_regions, slots, (1, 16), topology=topo)
    return P.driver(cfg, n_blocks, np.zeros(n_blocks))


def _plan_near(P):
    drv = _topo_driver(P, P.Topo.cxl_pooled(2, 2), 4, 24, 64)
    plan = P.fault.drain_plan(drv, 0)
    assert set(plan) == {1} and len(plan[1]) == 24  # near region 1 takes it all
    return plan


def test_drain_plan_prefers_near_tier():
    both(_plan_near)


def _plan_spill(P):
    cfg = P.core.PoolConfig(4, 32, (1, 16), topology=P.Topo.cxl_pooled(2, 2))
    placement = np.concatenate([np.zeros(24, np.int32), np.ones(24, np.int32)])
    drv = P.driver(cfg, 48, placement)
    plan = P.fault.drain_plan(drv, 0)
    assert len(plan.get(1, [])) == 8  # near tier filled to capacity first
    assert sum(len(v) for r, v in plan.items() if r in (2, 3)) == 16
    n = P.fault.drain_region(drv, 0)
    assert n == 24 and drv.default_session().drain()
    assert not (drv.host_placement() == 0).any()
    return dict(plan=plan, n=n, out=outcome(drv))


def test_drain_plan_spills_to_far_tier_when_near_full():
    both(_plan_spill)


def _plan_uniform(P):
    drv = _topo_driver(P, None, 3, 12, 32)
    plan = P.fault.drain_plan(drv, 0)
    assert sum(len(v) for v in plan.values()) == 12 and set(plan) <= {1, 2}
    return plan


def test_drain_plan_uniform_unchanged_without_topology():
    both(_plan_uniform)


# ---------------------------------------------------------------------------
# The contenders under concurrent writes (the contest's shape, small)
# ---------------------------------------------------------------------------


def _contest(P, arm):
    """64 blocks from region 0 to 1 under 4 writes a tick; ``arm`` is how
    they move: page_leap (megastep or legacy), one blocking
    ``migrate_driver``, or auto-balancing scans."""
    n = 64
    rng = np.random.default_rng(21)
    cfg = P.core.PoolConfig(2, 2 * n, (4,))
    data = rng.normal(size=(n, 4)).astype(np.float32)
    mode = "legacy" if arm == "leap_legacy" else "megastep"
    drv = P.driver(cfg, n, np.zeros(n), data, leap=P.core.LeapConfig(
        initial_area_blocks=8, budget_blocks_per_tick=16, fused_dispatch=mode))
    sess = drv.default_session()

    def writes():
        ids = rng.choice(n, size=4, replace=False)
        vals = rng.normal(size=(4, 4)).astype(np.float32)
        drv.write(P.ids(ids), P.values(vals))
        data[ids] = vals

    out = {}
    if arm.startswith("leap"):
        sess.leap(np.arange(n), 1)
        while not drv.done:
            sess.tick()
            sess.poll(block=True)
            writes()
    elif arm == "sync":
        sess.leap(np.arange(8), 1)  # a live request: its blocks are busy
        sess.tick()
        writes()
        busy = np.asarray(P.busy_mask(drv.state, P.ids(np.arange(n))))
        busy = np.nonzero(busy | drv.in_migration(np.arange(n)))[0]
        r = P.core.SyncResharder(cfg).migrate_driver(drv, np.arange(n), 1)
        assert r.failed.tolist() == busy.tolist()
        out = res(r)
    else:
        ab = P.core.AutoBalancer(cfg, n, P.core.AutoBalanceConfig(hot_threshold=1))
        moved = []
        for _ in range(6):
            rids = rng.choice(n, size=8, replace=False)
            ab.observe_driver(drv, rids, reader_region=1)
            ab.observe_writes(4)
            moved.append(ab.scan_driver(drv))
            writes()
        out = dict(moved=moved)
    assert sess.drain()
    InvariantChecker(drv).check_final(expected=data)
    return dict(out=out, state=outcome(drv))


@pytest.mark.parametrize("arm", ["leap_megastep", "leap_legacy", "sync", "autobalance"])
def test_contest_arms_match_jax(arm):
    got = both(_contest, arm)
    if arm == "sync":
        assert len(got["out"]["failed"]) > 0
