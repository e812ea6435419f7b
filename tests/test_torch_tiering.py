"""Closed-loop tiering of the port against the JAX package.

The 18 cases of ``tests/test_tiering.py``, each written once against a
package surface (``test_torch_baselines.Pkg``) and run over both packages:
the port passes the reference test's own assertions and ends in the same
state (pools, tables, flags, host table, ``MigrationStats`` but
``jit_cache_misses``, scenario results) bit for bit, with heat planes within
rtol = atol = 1e-6.  Every tick is followed by a blocking harvest
(:func:`step`) on both sides.  The heat-kernel cases hold K3's plain
version against the numpy oracle and against ``heat_scan_pallas`` in
interpret mode.

Last, a ``Pair`` drain with ``TieringPolicy.maybe_apply`` every tick, whose
state, stats and every handle (the policy's included) match at every tick.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_baselines import both, outcome  # noqa: E402
from test_torch_driver import Pair  # noqa: E402

from repro.kernels.heat_scan import heat_scan_pallas  # noqa: E402
from repro.kernels.heat_scan import padded_heat_len as jpadded  # noqa: E402
from repro.tiering import TieringConfig as JTieringConfig  # noqa: E402
from repro.tiering import TieringPolicy as JTieringPolicy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.heat_scan import padded_heat_len  # noqa: E402
from repro_torch.tiering import TieringConfig, TieringPolicy  # noqa: E402


def make(P, n_regions=2, slots=64, n_blocks=32, seed=0, leap=None):
    cfg = P.core.PoolConfig(n_regions, slots, (4,))
    data = np.random.default_rng(seed).normal(size=(n_blocks, 4)).astype(np.float32)
    return cfg, P.driver(cfg, n_blocks, np.zeros(n_blocks), data, leap=leap), data


def cxl_pool(P, n_blocks=48, slots=64, far_share=1.0, seed=0, leap=None):
    """3-region cxl_pooled pool (near = {0, 1}, far = {2}), blocks start far."""
    cfg = P.core.PoolConfig(3, slots, (4,), topology=P.Topo.cxl_pooled(2, 1))
    init_regions = np.full(n_blocks, 2, np.int32)
    init_regions[: int(n_blocks * (1.0 - far_share))] = 0
    data = np.random.default_rng(seed).normal(size=(n_blocks, 4)).astype(np.float32)
    return cfg, P.driver(cfg, n_blocks, init_regions, data, leap=leap), data


def step(drv):
    """One tick, then blocking harvest: verdicts land at the same tick in
    both packages, whatever the JAX package's async timing (ROADMAP R2)."""
    drv.tick()
    drv.poll(block=True)


def host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Heat kernel vs. numpy oracle
# ---------------------------------------------------------------------------


def heat_oracle(heat, ids, w, decay):
    out = np.asarray(heat, np.float32) * np.float32(decay)
    for i, ww in zip(np.asarray(ids), np.asarray(w)):
        if 0 <= i < len(out):
            out[i] += np.float32(ww)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("decay", [1.0, 0.9, 0.5])
def test_heat_scan_matches_oracle_random_traces(seed, decay):
    """K3's plain version == numpy decay oracle == the Pallas kernel in
    interpret mode on random chained traces: duplicate ids sum, sentinel
    (>= L) lanes are inert."""
    rng = np.random.default_rng(seed)
    L = padded_heat_len(100)
    heat = rng.gamma(1.0, 1.0, size=L).astype(np.float32)
    expect, jgot, tgot = heat.copy(), jnp.asarray(heat), torch.from_numpy(heat.copy())
    for _ in range(4):
        k = int(rng.integers(1, 70))
        ids = rng.integers(0, 100, size=k).astype(np.int32)
        ids[rng.random(k) < 0.15] = L
        w = rng.uniform(0.25, 2.0, size=k).astype(np.float32)
        expect = heat_oracle(expect, ids, w, decay)
        jgot = heat_scan_pallas(jgot, jnp.asarray(ids), jnp.asarray(w), decay, interpret=True)
        tgot = ops.heat_scan_impl(tgot, torch.from_numpy(ids.astype(np.int64)),
                                  torch.from_numpy(w), decay)
    np.testing.assert_allclose(tgot.numpy(), expect, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgot.numpy(), np.asarray(jgot), rtol=1e-6, atol=1e-6)


def test_heat_scan_ref_matches_oracle():
    rng = np.random.default_rng(7)
    L = padded_heat_len(40)
    heat = rng.gamma(1.0, 1.0, size=L).astype(np.float32)
    ids = rng.integers(0, 45, size=33).astype(np.int64)
    ids[:5] = L
    w = rng.uniform(0.0, 2.0, size=33).astype(np.float32)
    got = ref.heat_scan_ref(torch.from_numpy(heat.copy()), torch.from_numpy(ids),
                            torch.from_numpy(w), 0.8)
    np.testing.assert_allclose(got.numpy(), heat_oracle(heat, ids, w, 0.8), rtol=1e-5)


def test_heat_scan_dispatcher_empty_is_identity():
    heat = torch.arange(padded_heat_len(8), dtype=torch.float32)
    out = ops.heat_scan_impl(heat.clone(), torch.zeros(0, dtype=torch.int64),
                             torch.zeros(0), 0.5)
    assert torch.equal(out, heat)


def test_padded_heat_len_tile_aligned():
    for n in (1, 7, 1024, 1025, 5000):
        L = padded_heat_len(n)
        assert L == jpadded(n) and L >= n and L % 1024 == 0


# ---------------------------------------------------------------------------
# Drains with the heat phase
# ---------------------------------------------------------------------------


def _drain_with_reads(P, tiering, seed=11, n_blocks=32, reads_per_tick=4):
    cfg, drv, _ = make(P, slots=2 * n_blocks, n_blocks=n_blocks, seed=seed,
                       leap=P.core.LeapConfig(budget_blocks_per_tick=16, tiering=tiering))
    drv.default_session().leap(np.arange(n_blocks), 1)
    rng = np.random.default_rng(seed)
    steps = 0
    while not drv.done and steps < 500:
        drv.read(rng.choice(n_blocks, size=reads_per_tick, replace=False))
        step(drv)
        steps += 1
    assert drv.default_session().drain()
    return drv


def _single_dispatch(P):
    drv = _drain_with_reads(P, tiering=True)
    assert 0.0 < drv.stats.dispatches_per_tick <= 1.0
    assert drv.verify_mirror()
    heat = drv.heat_snapshot()
    assert heat.shape == (32,) and (heat > 0).any()
    return outcome(drv)


def test_single_dispatch_with_heat_phase():
    both(_single_dispatch)


def _tiering_off(P):
    off = _drain_with_reads(P, tiering=False, seed=13)
    on = _drain_with_reads(P, tiering=True, seed=13)
    for a, b in zip(outcome(off)["leaves"], outcome(on)["leaves"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(off.host_table(), on.host_table())
    assert (off.heat_snapshot() == 0).all()
    return dict(off=outcome(off), on=outcome(on))


def test_tiering_off_bit_identical_and_on_logically_inert():
    both(_tiering_off)


def _warm_path(P):
    cfg, drv, _ = make(P, n_blocks=32, slots=64, seed=41,
                       leap=P.core.LeapConfig(budget_blocks_per_tick=16, tiering=True))
    sess = drv.default_session()
    rng = np.random.default_rng(41)
    sess.leap(np.arange(32), 1)
    while not drv.done:
        drv.read(rng.choice(32, size=8, replace=False))
        step(drv)
    assert sess.drain()
    before = P.core.migrator.program_cache_sizes()["megastep"]
    misses = drv.stats.jit_cache_misses
    sess.leap(np.arange(32), 0)
    steps = 0
    while not drv.done and steps < 500:
        drv.read(rng.choice(32, size=8, replace=False))
        step(drv)
        steps += 1
    assert sess.drain()
    assert P.core.migrator.program_cache_sizes()["megastep"] == before
    assert drv.stats.jit_cache_misses == misses
    return outcome(drv)


def test_heat_warm_path_does_not_recompile():
    """A second drain over the same shapes adds no megastep variant and no
    jit miss in either package; the warm drain itself must match the
    reference's."""
    both(_warm_path)


def _heat_flush(P):
    out = {}
    for mode in ("batched", "legacy"):
        cfg, drv, _ = make(P, n_blocks=16, slots=32, seed=5,
                           leap=P.core.LeapConfig(tiering=True, fused_dispatch=mode))
        for _ in range(4):
            drv.read(np.array([3, 3, 9]))
            step(drv)
        heat = drv.heat_snapshot()
        assert heat[3] > heat[9] > 0 and heat[4] == 0
        out[mode] = outcome(drv)
    return out


def test_heat_flush_on_batched_and_legacy_modes():
    both(_heat_flush)


def _heat_decay(P):
    cfg, drv, _ = make(P, n_blocks=16, slots=32, seed=6,
                       leap=P.core.LeapConfig(tiering=True, tier_heat_decay=0.5))
    drv.read(np.array([1]))
    step(drv)
    for _ in range(4):
        drv.read(np.array([2]))
        step(drv)
    heat = drv.heat_snapshot()
    assert heat[2] > heat[1] > 0
    return heat


def test_heat_decay_orders_recency():
    both(_heat_decay)


# ---------------------------------------------------------------------------
# split_tiers
# ---------------------------------------------------------------------------


def _split(P):
    split, Topo = P.tiering.split_tiers, P.Topo
    out = [split(Topo.cxl_pooled(2, 1)), split(Topo.cxl_pooled(2, 2)),
           split(Topo.symmetric(4)), split(Topo.symmetric(4), far=(3,)),
           split(Topo.quad_socket()), split(Topo.cxl_pooled(4, 4), near=(0, 1))]
    assert out[:4] == [((0, 1), (2,)), ((0, 1), (2, 3)), ((0, 1, 2, 3), ()), ((0, 1, 2), (3,))]
    return out


def test_split_tiers_cxl_and_uniform():
    both(_split)


# ---------------------------------------------------------------------------
# TieringPolicy: watermarks, hysteresis, G-aligned demotion
# ---------------------------------------------------------------------------


def run_policy(drv, pol, hot_ids, ticks):
    sess = drv.default_session()
    for _ in range(ticks):
        if len(hot_ids):
            drv.read(hot_ids)
        pol.maybe_apply(sess)
        step(drv)
    sess.drain()
    return drv.host_placement()


def _promote_demote(P):
    cfg, drv, data = cxl_pool(P, leap=P.core.LeapConfig(tiering=True, budget_blocks_per_tick=16))
    pol = P.tiering.TieringPolicy(drv, P.tiering.TieringConfig(
        hot_watermark=2.0, cold_watermark=0.1, epoch_ticks=4, cooldown_ticks=8))
    hot = np.array([20, 21, 22, 23], np.int32)
    placement = run_policy(drv, pol, hot, 40)
    assert set(placement[hot].tolist()) <= {0, 1}, placement[hot]
    assert drv.stats.tier_promotions >= len(hot)
    np.testing.assert_array_equal(host(drv.read(np.arange(48))), data)
    assert drv.verify_mirror()
    return outcome(drv)


def test_policy_promotes_hot_and_demotes_cold():
    both(_promote_demote)


def _cooldown(P):
    cfg, drv, _ = cxl_pool(P, leap=P.core.LeapConfig(tiering=True))
    pol = P.tiering.TieringPolicy(drv, P.tiering.TieringConfig(
        hot_watermark=1.5, cold_watermark=1.0, epoch_ticks=1, cooldown_ticks=10_000))
    sess = drv.default_session()
    for _ in range(4):
        drv.read(np.array([30]))
        step(drv)
    pol.maybe_apply(sess)
    for _ in range(10):
        step(drv)
    assert sess.drain()
    assert drv.host_placement()[30] in (0, 1)
    for _ in range(30):  # heat now ~0 — decisively cold
        pol.maybe_apply(sess)
        step(drv)
    assert sess.drain()
    assert drv.host_placement()[30] in (0, 1), "cooldown must prevent demotion"
    assert drv.stats.tier_demotions == 0
    return outcome(drv)


def test_policy_cooldown_pins_recent_movers():
    both(_cooldown)


def _aligned_runs(P):
    G, n = 4, 16
    cfg = P.core.PoolConfig(3, 32, (4,), huge_factor=G, topology=P.Topo.cxl_pooled(2, 1))
    drv = P.driver(cfg, n, np.zeros(n), leap=P.core.LeapConfig(tiering=True))
    pol = P.tiering.TieringPolicy(drv, P.tiering.TieringConfig(
        hot_watermark=2.0, cold_watermark=0.5, epoch_ticks=2, cooldown_ticks=4))
    hot = np.array([4], np.int32)  # group 1 is half-hot; groups 0, 2, 3 all-cold
    for _ in range(6):
        drv.read(hot)
        step(drv)
    placement = run_policy(drv, pol, hot, 30)
    assert (placement[4:8] != 2).all(), "half-hot run must stay near"
    demoted = [g for g in (0, 2, 3) if (placement[g * G : (g + 1) * G] == 2).all()]
    assert demoted, placement
    assert drv.stats.tier_demotions % G == 0
    return outcome(drv)


def test_policy_demotes_whole_aligned_runs_on_tiered_pool():
    both(_aligned_runs)


def _noop(P):
    cfg, drv, _ = make(P, n_blocks=8, slots=16, leap=P.core.LeapConfig(tiering=True))
    assert P.tiering.TieringPolicy(drv).decide(drv.default_session().facade) == []
    return outcome(drv)


def test_policy_noop_without_topology_or_far_tier():
    both(_noop)


# ---------------------------------------------------------------------------
# Ping-pong metering
# ---------------------------------------------------------------------------


def _ping_pong(P):
    cfg, drv, _ = make(P, n_blocks=8, slots=32, seed=9,
                       leap=P.core.LeapConfig(tier_pingpong_window=16))
    sess = drv.default_session()
    ids = np.array([0, 1], np.int32)
    for dst in (1, 0, 1):  # three rapid moves: 2nd and 3rd are ping-pongs
        sess.leap(ids, dst)
        assert sess.drain()
    assert drv.stats.ping_pong_migrations == 2 * len(ids)
    before = drv.stats.ping_pong_migrations
    for _ in range(20):
        step(drv)
    sess.leap(ids, 0)
    assert sess.drain()
    assert drv.stats.ping_pong_migrations == before
    return outcome(drv)


def test_ping_pong_counter_meters_rapid_remigration():
    both(_ping_pong)


# ---------------------------------------------------------------------------
# Telemetry: residency gauges, counters, extra stacking
# ---------------------------------------------------------------------------


def _gauge_lines(txt):
    keys = ("tier_resident", "leap_tier_", "leap_ping_pong")
    return sorted(line for line in txt.splitlines() if line.startswith(keys))


def _residency(P):
    cfg, drv, _ = cxl_pool(P, n_blocks=24, far_share=0.5, leap=P.core.LeapConfig(tiering=True))
    sess = drv.default_session()
    txt = sess.telemetry().metrics_text()
    bb = cfg.block_bytes
    assert f'tier_resident_bytes{{tier="far"}} {12 * bb}' in txt
    assert f'tier_resident_bytes{{tier="near"}} {12 * bb}' in txt
    assert "leap_tier_promotions_total 0" in txt
    assert "leap_tier_demotions_total 0" in txt
    assert "leap_ping_pong_migrations_total 0" in txt
    before = _gauge_lines(txt)
    sess.leap(np.arange(24), 2)
    assert sess.drain()
    txt = sess.telemetry().metrics_text()
    assert f'tier_resident_bytes{{tier="far"}} {24 * bb}' in txt
    assert 'tier_resident_bytes{tier="near"} 0' in txt
    return dict(before=before, after=_gauge_lines(txt))


def test_tier_residency_gauges_and_counters_in_prometheus():
    both(_residency)


def _stacking(P):
    cfg, drv, _ = cxl_pool(P, n_blocks=8)
    view = drv.default_session().telemetry().with_extra(lambda reg: reg.gauge("custom_extra", 7))
    txt = view.metrics_text()
    assert "custom_extra 7" in txt
    assert 'tier_resident_bytes{tier="near"}' in txt, "stacking dropped prior extra"
    return _gauge_lines(txt)


def test_with_extra_stacks_not_replaces():
    both(_stacking)


def _facade_heat(P):
    cfg, drv, _ = make(P, n_blocks=8, slots=16, leap=P.core.LeapConfig(tiering=True))
    drv.read(np.array([2, 2, 5]))
    step(drv)
    heat = drv.default_session().facade.heat()
    assert heat.shape == (8,) and heat[2] > heat[5] > 0 and heat[0] == 0
    return heat


def test_facade_heat_accessor():
    both(_facade_heat)


# ---------------------------------------------------------------------------
# The closed loop through the Pair harness: maybe_apply every tick
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["megastep", "legacy"])
def test_policy_loop_matches_jax_every_tick(mode):
    """A rotating working set on a cxl_pooled two-tier pool, read every tick
    with writes; each package's policy decides from its own heat plane, and
    state, stats and every handle (the policy's moves too) agree tick by
    tick."""
    G, n = 4, 48
    placement = np.repeat([0, 1, 2], n // 3).astype(np.int32)  # 16 a region
    p = Pair(n, 64, dict(budget_blocks_per_tick=8, tiering=True, tier_heat_decay=0.8,
                         fused_dispatch=mode), n_regions=3, huge_factor=G, topology=True,
             placement=placement, seed=17)
    for d in (p.j, p.t):
        assert d.adopt_huge(np.arange(8)) == 8  # the near regions' groups are huge
    kw = dict(hot_watermark=2.0, cold_watermark=0.3, epoch_ticks=3, cooldown_ticks=6,
              max_promotions=4, max_demotions=2)
    pols = (JTieringPolicy(p.j, JTieringConfig(**kw)), TieringPolicy(p.t, TieringConfig(**kw)))
    rng = np.random.default_rng(17)
    for step in range(60):
        hot = np.arange(32, 36) if step < 30 else np.arange(40, 44)  # far, then rotated
        p.read(hot)
        if step % 2:
            ids = rng.choice(n, size=2, replace=False)
            p.write(ids, rng.normal(size=(2, 4)).astype(np.float32))
        hj, ht = (pol.maybe_apply(s) for pol, s in zip(pols, p.sessions))
        assert [h.tag for h in ht] == [h.tag for h in hj]
        p.handles.extend(zip(hj, ht))
        p.tick()
        p.assert_equal()
    p.drain()
    p.assert_equal()
    s = p.t.stats
    assert s.tier_promotions > 0 and s.tier_demotions > 0
    assert set(p.t.host_placement()[40:44].tolist()) <= {0, 1}
