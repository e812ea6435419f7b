"""The port's host plane against the JAX package: the buddy allocator and
two-level table, the topology model, the session API, telemetry, and the
pipeline stages; then the drains that guard them, tick by tick.

Modules with no device state (``pool``, ``topology``, ``obs``) get the same
calls on both packages and must give the same answers.  Scenarios through a
driver run once per package (``test_torch_baselines.both``) or in lockstep
through the ``Pair`` harness of ``test_torch_driver`` (blocking harvest),
whose state, stats and handle progress must match after every tick, heat
within rtol = atol = 1e-6.  The lockstep drains cover a two-hop relay on a
congested ``quad_socket`` link, cancelling mid-drain with priorities, a
full destination, ``SloScheduler`` pacing from observed latencies,
``session.apply`` with a topology spill, and cancelling a drain of huge
blocks.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from test_torch_baselines import assert_same, both, outcome  # noqa: E402
from test_torch_driver import Pair  # noqa: E402

import repro.core.pipeline as JP  # noqa: E402
import repro.obs as JO  # noqa: E402
import repro.pool as JPool  # noqa: E402
import repro.topology as JTop  # noqa: E402
import repro_torch.core.pipeline as TP  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
import repro_torch.pool as TPool  # noqa: E402
import repro_torch.topology as TTop  # noqa: E402
from repro.api import Move as JMove  # noqa: E402
from repro_torch.api import Move as TMove  # noqa: E402

# ---------------------------------------------------------------------------
# pool: buddy allocator and two-level table
# ---------------------------------------------------------------------------


def _buddy_trace(pool, seed):
    """A seeded sequence of allocator calls; returns every answer and the
    final free lists."""
    rng = np.random.default_rng(seed)
    b = pool.BuddyAllocator(64, 8)
    live, out = [], []
    for _ in range(120):
        op = rng.integers(0, 5)
        if op == 0:
            order = int(rng.integers(0, 4))
            s = b.alloc(order)
            out.append(("alloc", order, s))
            if s is not None:
                live.append((s, order))
        elif op == 1 and live:
            s, order = live.pop(int(rng.integers(0, len(live))))
            b.free(s, order)
            out.append(("free", s, order))
        elif op == 2:
            n = int(rng.integers(1, 6))
            got = b.take(n)
            out.append(("take", n, None if got is None else got.tolist()))
            if got is not None:
                live.extend((int(x), 0) for x in got)
        elif op == 3:
            s = b.take_run()
            out.append(("take_run", s))
            if s is not None:
                live.append((s, 3))
        elif op == 4 and live:
            s, order = live.pop(0)
            if order == 3 and rng.random() < 0.5:
                b.split_allocated(s)
                live.extend((s + i, 0) for i in range(8))
                out.append(("split", s))
            else:
                b.free(s, order)
                out.append(("free", s, order))
        out.append(("len", len(b), b.has_run()))
        assert b.check()
    out.append(("final", sorted(b)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_buddy_allocator_matches_jax(seed):
    assert _buddy_trace(TPool, seed) == _buddy_trace(JPool, seed)


def _table_trace(pool):
    t = pool.TwoLevelTable(32, 4)
    out = []
    for g, region, start in ((0, 1, 8), (3, 0, 0), (5, 1, 12)):
        t.promote(g, region, start)
    t.relocate(3, 1, 16)
    t.demote(5)
    ids = np.arange(32)
    out += [t.group_of(ids).tolist(), t.members(3).tolist(), t.is_huge(ids).tolist(),
            t.huge_groups().tolist(), t.tier.tolist()]
    flat = np.zeros((32, 2), np.int32)
    flat[0:4] = [[1, 8], [1, 9], [1, 10], [1, 11]]
    flat[12:16] = [[1, 16], [1, 17], [1, 18], [1, 19]]
    out.append(bool(t.check_consistent(flat)))
    return out


def test_two_level_table_matches_jax():
    assert _table_trace(TPool) == _table_trace(JPool)


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


def _topologies(M):
    return [M.two_socket(), M.quad_socket(), M.symmetric(6), M.cxl_pooled(2, 1),
            M.cxl_pooled(4, 4), M.quad_socket().congested(0, 1, 16),
            M.two_socket().with_link(0, 1, bandwidth=0.05)]


def _topo_answers(mod):
    out = []
    for topo in _topologies(mod.NumaTopology):
        r = topo.n_regions
        pairs = [(s, d) for s in range(r) for d in range(r) if s != d]
        out.append(dict(
            distance=np.asarray(topo.distance), bandwidth=np.asarray(topo.bandwidth),
            min_link=topo.min_link_distance,
            routes=[topo.route(s, d) for s, d in pairs],
            hops=[topo.hops(s, d) for s, d in pairs],
            cost=[topo.link_cost(s, d) for s, d in pairs],
            blocks=[topo.link_blocks(s, d, 64) for s, d in pairs],
            nearest=[topo.nearest(i) for i in range(r)],
            nearest_ex=[topo.nearest(i, exclude=(0,)) for i in range(r)],
        ))
        ids = np.arange(12)
        spill = mod.spill_assignments(topo, ids, np.full(12, r - 1), 0,
                                      {i: 4 for i in range(r)})
        out[-1]["spill"] = [[(a.tolist(), int(b)) for a, b in spill[0]], spill[1].tolist()]
    return out


def test_topology_model_matches_jax():
    assert_same(_topo_answers(JTop), _topo_answers(TTop))


def test_modeled_tick_time_and_area_sizing_match_jax():
    import repro.core.adaptive as JA
    import repro_torch.core.adaptive as TA

    for Jt, Tt in zip(_topologies(JTop.NumaTopology), _topologies(TTop.NumaTopology)):
        per_link = {(0, 1): 32, (1, 0): 8}
        assert TTop.modeled_tick_time(per_link, Tt, 4096) == JTop.modeled_tick_time(
            per_link, Jt, 4096)
        for d in (10, 11, 21, 31, 40):
            assert TA.area_blocks_for_distance(64, d, Tt.min_link_distance) == \
                JA.area_blocks_for_distance(64, d, Jt.min_link_distance)


# ---------------------------------------------------------------------------
# obs: recorder, histograms, metrics, traces
# ---------------------------------------------------------------------------


def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 1e-6
        return t[0]

    return clock


def _recorder_trace(obs):
    rec = obs.TelemetryRecorder(capacity=8, clock=_fake_clock())
    for tick in range(6):
        rec.begin_tick(tick)
        with rec.stage("dispatch.run_tick", opened=tick):
            rec.count("dispatches", 1, program="megastep")
        rec.request_submitted(tick, 1, 0)
        rec.request_phase(tick, "EPOCH_OPEN", n=4)
        rec.request_resolved(tick, 3, 1, 0, 4)
        rec.event("note", "x", k=tick)
    h = obs.Histogram((5e-4, 1e-3, 2e-3, 4e-3, 8e-3))
    for v in np.random.default_rng(0).gamma(2.0, 1e-3, size=500):
        h.observe(float(v))
    return dict(events=rec.events(), counters=rec.counter_totals(),
                spans=[dataclasses.asdict(s) for s in rec.request_spans()],
                latency=dataclasses.asdict(rec.latency(2)),
                hist=(h.counts, h.sum, h.count), quantiles=[h.quantile(q) for q in (0.5, 0.9, 0.99)])


def test_recorder_and_histogram_match_jax():
    assert_same(_recorder_trace(JO), _recorder_trace(TO))


def _telemetry_drain(P):
    cfg = P.core.PoolConfig(2, 24, (4,))
    data = np.arange(64, dtype=np.float32).reshape(16, 4)
    drv = P.driver(cfg, 16, np.zeros(16), data, leap=P.core.LeapConfig(
        initial_area_blocks=4, chunk_blocks=2, budget_blocks_per_tick=4, telemetry=True))
    sess = drv.default_session()
    h = sess.leap(np.arange(16), 1)
    rng = np.random.default_rng(3)
    while not h.done:
        sess.tick()
        sess.poll(block=True)
        drv.write(P.ids(rng.choice(16, 2, replace=False)), P.values(np.ones((2, 4), np.float32)))
    view = sess.telemetry()
    trace = view.chrome_trace()
    (TO if P.torch else JO).validate_chrome_trace(trace)
    # jit-miss events depend on what the process compiled before (both
    # packages' caches are process-wide); test_torch_graphs.py holds them
    events = [(e["kind"], e["name"]) for e in view.events() if e["kind"] != "jit"]
    spans = [{k: v for k, v in dataclasses.asdict(s).items() if not k.endswith("_ts")}
             for s in view.request_spans()]  # all but wall-clock stamps
    counters = {k: v for k, v in view.metrics_json()["counters"].items() if "seconds" not in k}
    return dict(events=events, spans=spans, counters=counters, out=outcome(drv),
                trace_names=sorted({e["name"] for e in trace["traceEvents"]} - {"jit_miss"}))


def test_telemetry_of_a_drain_matches_jax():
    """Event families, request spans, counters and trace event names of a
    telemetry drain agree; the port's Chrome trace validates."""
    both(_telemetry_drain)


# ---------------------------------------------------------------------------
# api and pipeline stages, scenario by scenario
# ---------------------------------------------------------------------------


def _session(P, n=16, slots=32, huge=1, **leap_kw):
    cfg = P.core.PoolConfig(2, slots, (4,), huge_factor=huge)
    data = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    kw = dict(initial_area_blocks=4, budget_blocks_per_tick=4)
    kw.update(leap_kw)
    drv = P.driver(cfg, n, np.zeros(n), data, leap=P.core.LeapConfig(**kw))
    return drv, drv.default_session()


def _progress(h):
    return (dataclasses.asdict(h.progress()), h.status.value, h.done, h.requested)


def _api_lifecycle(P):
    drv, sess = _session(P)
    done = []
    h = sess.leap(np.arange(8), 1, on_done=lambda x: done.append(x.request_id))
    seen = [_progress(h)]
    while not h.done:
        sess.tick()
        seen.append(_progress(h))
        sess.poll(block=True)
        seen.append(_progress(h))
    dup = sess.leap(np.arange(8), 1)  # everything home: vacuous
    over = sess.leap(np.arange(4, 12), 1)  # only 8..11 are new
    twice = sess.leap(np.array([12, 12, 13, 13]), 1)  # duplicates collapse
    assert over.requested == 4 and twice.requested == 2 and dup.done
    assert sess.drain()
    return dict(seen=seen, done=done, extra=[_progress(x) for x in (dup, over, twice)],
                live=len(sess.live_handles()), out=outcome(drv),
                placement=sess.facade.placement())


def test_session_lifecycle_dedupe_and_callbacks():
    both(_api_lifecycle)


def _api_cancels(P):
    drv, sess = _session(P)
    a = sess.leap(np.arange(16), 1)
    dropped = [a.cancel(), a.cancel()]  # before any copy; idempotent
    b = sess.leap(np.arange(16), 1)
    sess.tick()  # epochs open and copy
    drv.write(P.ids(np.arange(16)), P.values(np.ones((16, 4), np.float32)))
    dropped.append(b.cancel())
    assert sess.drain()
    tdrv, tsess = _session(P, slots=32, huge=4)
    assert tdrv.adopt_huge(np.arange(4)) == 4
    c = tsess.leap(np.arange(16), 1)
    dropped.append(c.cancel())
    d = tsess.leap(np.arange(16), 1)
    assert d.wait() and tdrv.verify_tiers()
    return dict(dropped=dropped, h=[_progress(x) for x in (a, b, c, d)],
                out=outcome(drv), tiered=outcome(tdrv))


def test_cancels_before_and_mid_epoch_and_on_a_tiered_pool():
    both(_api_cancels)


def _api_priorities_and_moves(P):
    drv, sess = _session(P, n=64, slots=80, initial_area_blocks=8, budget_blocks_per_tick=8)
    order = []
    low = sess.leap(np.arange(48), 1, priority=0, on_done=lambda h: order.append("low"))
    sess.tick()
    high = sess.leap(np.arange(48, 64), 1, priority=5, on_done=lambda h: order.append("high"))
    assert sess.drain() and order == ["high", "low"]
    Move = TMove if P.torch else JMove
    handles = sess.submit_moves([Move(np.arange(8, dtype=np.int32), 0, tag="home"),
                                 Move(np.arange(8, 16, dtype=np.int32), 0, priority=3)])
    assert sess.drain()
    facade = sess.facade
    return dict(order=order, h=[_progress(x) for x in (low, high, *handles)],
                tags=[x.tag for x in handles], out=outcome(drv),
                facade=dict(placement=facade.placement(), free=[facade.free_slots(r)
                                                               for r in range(2)],
                            stats=outcome_stats(facade.snapshot_stats())))


def outcome_stats(stats) -> dict:
    out = dataclasses.asdict(stats)
    out.pop("jit_cache_misses")
    return out


def test_priorities_and_static_moves():
    both(_api_priorities_and_moves)


def _tickets(P):
    drv, sess = _session(P, n=8, slots=16)
    Ticket = (TP if P.torch else JP).AdmissionTicket
    a = sess.leap(np.arange(4), 1, ticket=Ticket(escalate=True))
    b = sess.leap(np.asarray([4, 5]), 1, ticket=Ticket(fresh_alloc=True))
    c = sess.leap(np.asarray([6, 7]), 1, ticket=Ticket(escalate=True, fresh_alloc=True))
    assert sess.drain()
    # a forced move and an opposite fresh force open in one tick (quarantine)
    d = sess.leap(np.arange(4), 0, ticket=Ticket(escalate=True))
    e = sess.leap(np.arange(4, 8), 0, ticket=Ticket(escalate=True, fresh_alloc=True))
    assert sess.drain()
    names = ("leap", "sync", "slo")
    kinds = [type((TP if P.torch else JP).make_scheduler(n)).__name__ for n in names]
    hdrv, _ = _session(P, n=16, slots=32, huge=4)
    assert hdrv.adopt_huge(np.arange(4)) == 4
    req = hdrv.submit(np.arange(16), 0, ticket=Ticket(escalate=True))
    assert req.requested == 0 and hdrv.stats.demotions == 0
    return dict(h=[_progress(x) for x in (a, b, c, d, e)], kinds=kinds, out=outcome(drv),
                huge=outcome(hdrv))


def test_admission_tickets_and_scheduler_names():
    both(_tickets)


def _snapshots(P):
    drv, sess = _session(P, n=24, slots=40, initial_area_blocks=8, budget_blocks_per_tick=6,
                         max_attempts_before_force=1)
    sess.leap(np.arange(24), 1)
    snaps = []
    for t in range(12):
        sess.tick()
        drv.write(P.ids([t % 24]), P.values(np.zeros((1, 4), np.float32)))
        snaps.append(dataclasses.asdict(drv.introspect()))
        sess.poll(block=True)
    assert sess.drain()
    return dict(snaps=snaps, out=outcome(drv))


def test_pipeline_snapshots_match_jax_every_tick():
    both(_snapshots)


# ---------------------------------------------------------------------------
# Lockstep drains (the re-anchor's probes)
# ---------------------------------------------------------------------------


def _lockstep(p, ticks, n, rng=None, writes=0, shape=(4,), between=None):
    for t in range(ticks):
        if all(s.done for s in p.sessions):
            break
        if between is not None:
            between(t)
        p.tick()
        if writes:
            ids = rng.choice(n, size=writes, replace=False)
            p.write(ids, rng.normal(size=(writes,) + shape).astype(np.float32))
        p.assert_equal()
    p.drain()
    p.assert_equal()


def _quad(M):
    return M.quad_socket().congested(0, 1, 16)


@pytest.mark.parametrize("mode", ["megastep", "batched", "legacy"])
def test_two_hop_relay_under_writes(mode):
    n = 48
    p = Pair(n, 64, dict(initial_area_blocks=8, budget_blocks_per_tick=16,
                         fused_dispatch=mode), block_shape=(1, 16), n_regions=4,
             topology=_quad, seed=2)
    p.leap(np.arange(n), 1)
    _lockstep(p, 500, n, np.random.default_rng(2), writes=2, shape=(1, 16))
    s = p.t.stats
    assert s.multi_hop_areas > 0 and (p.t.host_placement() == 1).all()
    assert s.bytes_per_link.get((0, 1), 0) < s.bytes_copied


def test_cancel_mid_drain_with_priorities():
    n = 64
    p = Pair(n, 80, dict(initial_area_blocks=8, budget_blocks_per_tick=8), seed=6)
    low = p.leap(np.arange(48), 1, priority=0)
    high = p.leap(np.arange(48, 64), 1, priority=5)
    rng = np.random.default_rng(6)

    def between(t):
        if t == 3:
            dropped = [h.cancel() for h in low]
            assert dropped[0] == dropped[1] > 0

    _lockstep(p, 300, n, rng, writes=3, between=between)
    assert all(h.done for h in high) and high[1].progress().committed + \
        high[1].progress().forced == 16


def test_full_destination_takes_the_out_of_slots_path():
    n = 32
    placement = np.concatenate([np.zeros(24, np.int32), np.ones(8, np.int32)])
    p = Pair(n, 34, dict(initial_area_blocks=16, budget_blocks_per_tick=8), placement=placement,
             seed=8)
    p.leap(np.arange(24), 1)  # 26 free slots for 24 blocks: areas split to fit
    p.leap(np.arange(24, 32), 0)
    _lockstep(p, 400, n, np.random.default_rng(8), writes=2)
    assert p.t.stats.splits > 0 or p.t.stats.ticks > 4


def test_slo_scheduler_paces_from_observed_latencies():
    n = 48
    scheds = (JP.SloScheduler(), TP.SloScheduler())
    for s in scheds:
        s.register_tenant("a", slo_latency=10.0)
        s.register_tenant("b", slo_latency=20.0, priority=1)
    p = Pair(n, 96, dict(initial_area_blocks=4, budget_blocks_per_tick=16), scheduler=scheds,
             seed=10)
    p.leap(np.arange(n), 1)
    rng = np.random.default_rng(10)
    budgets = []

    def between(t):
        lat = rng.uniform(0.5, 1.5, size=8) * (4 + 2 * t)  # slack falls tick by tick
        for s in scheds:
            s.observe_tokens("a", lat)
            s.observe_tokens("b", 2 * lat)
        budgets.append([s.tick_budget(p.t.cfg) for s in scheds])
        assert budgets[-1][0] == budgets[-1][1]
        assert scheds[0].migration_priority("a") == scheds[1].migration_priority("a")

    _lockstep(p, 400, n, rng, writes=2, between=between)
    assert len({b[0] for b in budgets}) > 1  # the pace really moved


def test_session_apply_with_topology_spill():
    """One move to a nearly full region spills to its nearest neighbour:
    one decision becomes several handles, all tracked in lockstep."""
    n = 24
    placement = np.concatenate([np.full(12, 2, np.int32), np.full(12, 1, np.int32)])
    p = Pair(n, 16, dict(), block_shape=(1, 16), n_regions=4, placement=placement,
             topology=lambda M: M.cxl_pooled(2, 2), seed=12)

    class Policy:
        def __init__(self, Move):
            self.Move = Move

        def decide(self, facade):
            return [self.Move(np.arange(12, dtype=np.int32), 1, tag="hot")]

    hj, ht = (s.apply(Policy(M)) for s, M in zip(p.sessions, (JMove, TMove)))
    assert len(ht) == len(hj) > 1
    assert [(h.dst_region, h.requested, h.tag) for h in ht] == \
        [(h.dst_region, h.requested, h.tag) for h in hj]
    p.handles.extend(zip(hj, ht))
    _lockstep(p, 300, n)
    assert not (p.t.host_placement()[:12] == 2).any()


def test_cancel_a_huge_drain():
    G, n = 4, 32
    p = Pair(n, 48, dict(initial_area_blocks=8, budget_blocks_per_tick=8), huge_factor=G, seed=14)
    for d in (p.j, p.t):
        assert d.adopt_huge(np.arange(n // G)) == n // G
    hs = p.leap(np.arange(n), 1)

    def between(t):
        if t == 2:
            assert hs[0].cancel() == hs[1].cancel()

    _lockstep(p, 300, n, np.random.default_rng(14), writes=2, between=between)
    assert p.t.verify_tiers() and hs[1].progress().cancelled > 0
