"""The port's serving-load subsystem against the JAX package's, on the CPU.

The cases of ``tests/test_load.py``, each run once over the JAX package
and once over the port (reduced two-layer granite_3_2b, the JAX weights
carried across with ``params_from_numpy``, the port's engines on the CPU):
deterministic arrival streams, admission backpressure, the SLO scheduler's
pacing curve and priorities, per-tenant telemetry, the autoscaler and the
chaos serving workload.  Engines tick with blocking harvest on both sides
(their sessions' ``tick`` is wrapped here: ROADMAP R2).  ``gen.report()``,
the tick log, the tokens, tables, flags, page accounting, tenant stats and
``MigrationStats`` (``jit_cache_misses`` too, from empty program caches)
must be equal, pools within rtol = atol = 1e-5 (matrix products sum in different orders), heat
within 1e-6.  One more case drives ``SloScheduler`` end to end through the
generator at the ``serving_slo`` benchmark's high load.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_baselines import JAX, PORT  # noqa: E402
from test_torch_chaos import both_chaos  # noqa: E402
from test_torch_driver import clear_program_caches  # noqa: E402

import repro.core.pipeline as JP  # noqa: E402
import repro.load as JL  # noqa: E402
import repro_torch.chaos as TC  # noqa: E402
import repro_torch.core.pipeline as TP  # noqa: E402
import repro_torch.load as TL  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.smoke import reduce as jax_reduce  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import PagedConfig as JPagedConfig  # noqa: E402
from repro.serving.engine import PagedEngine as JPagedEngine  # noqa: E402
from repro_torch.configs.base import get_config as torch_config  # noqa: E402
from repro_torch.configs.smoke import reduce as torch_reduce  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving.engine import PagedConfig, PagedEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
HEAT_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jax_reduce(jax_config("granite_3_2b")), n_layers=2)
    tc = dataclasses.replace(torch_reduce(torch_config("granite_3_2b")), n_layers=2)
    jparams = jlm.init_params(jax.random.key(0), jc)
    return jc, tc, jparams, tlm.params_from_numpy(jax.tree.map(np.asarray, jparams), tc, "cpu")


class Side:
    """One package's serving surface: ``load``, ``pipe`` (``SloScheduler``,
    ``SloConfig``), ``P`` (the ``test_torch_baselines.Pkg``) and
    :meth:`engine`."""

    def __init__(self, P):
        self.P = P
        self.torch = P.torch
        self.load = TL if P.torch else JL
        self.pipe = TP if P.torch else JP

    def __repr__(self):
        return self.P.name

    def spec(self, **kw):
        load = self.load
        kw.setdefault("tenants", (
            load.TenantSpec("gold", rate=0.5, prompt_tokens=6, decode_tokens=8,
                            slo_latency=2.5, priority=2, region=0),
            load.TenantSpec("batch", rate=0.3, prompt_tokens=8, decode_tokens=12,
                            slo_latency=10.0, priority=0, region=1),
        ))
        kw.setdefault("ticks", 12)
        kw.setdefault("seed", 7)
        return load.WorkloadSpec(**kw)

    def engine(self, models, leap=None, **kw):
        """``tests/test_load.py``'s ``_engine``; ``leap`` is a dict of
        ``LeapConfig`` fields.  The session's ``tick`` harvests with
        ``poll(block=True)`` after every tick, and ``release`` keeps the
        released sequence's tokens (``eng.finished``)."""
        jc, tc, jparams, model = models
        kw.setdefault("block_tokens", 4)
        kw.setdefault("max_blocks_per_seq", 16)
        kw.setdefault("n_regions", 2)
        kw.setdefault("slots_per_region", 64)
        leap = self.P.core.LeapConfig(**(leap or {}))
        if self.torch:
            eng = PagedEngine(tc, model, PagedConfig(leap=leap, **kw), device="cpu")
        else:
            eng = JPagedEngine(jc, jparams, JPagedConfig(leap=leap, **kw))
        session, release = eng.session, eng.release

        def blocking_tick(tick=session.tick):
            tick()
            session.poll(block=True)

        def keep_tokens(sid):
            eng.finished[sid] = list(eng.seqs[sid].tokens)
            release(sid)

        session.tick, eng.release, eng.finished = blocking_tick, keep_tokens, {}
        return eng


SIDES = (Side(JAX), Side(PORT))


def engine_outcome(eng) -> dict:
    drv = eng.driver
    st = drv.state
    if hasattr(st, "to_numpy"):
        pool, *flags = st.to_numpy()
    else:
        pool, *flags = (np.asarray(x) for x in (st.pool, st.table, st.dirty, st.in_flight))
    stats = dataclasses.asdict(drv.stats)
    tokens = dict(eng.finished)
    tokens.update({sid: list(s.tokens) for sid, s in eng.seqs.items()})
    return dict(pool=pool, flags=flags, host_table=drv.host_table(), stats=stats,
                heat=drv.heat_snapshot(), tokens=tokens, pages=eng.page_accounting(),
                tenants=eng.tenant_stats())


def same(a, b, path="result"):
    """Deep equality: numpy arrays bit for bit, pools within ``TOL``, heat
    planes within ``HEAT_TOL``."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        tol = TOL if path.endswith(".pool") else HEAT_TOL if path.endswith(".heat") else None
        if tol is None:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=path)
        else:
            np.testing.assert_allclose(np.asarray(b), np.asarray(a), err_msg=path, **tol)
    else:
        assert a == b, (path, a, b)


def both(scenario, *args):
    clear_program_caches()
    want = scenario(SIDES[0], *args)
    clear_program_caches()
    got = scenario(SIDES[1], *args)
    same(want, got)
    return got


# -- workload determinism ---------------------------------------------------


def _arrivals(S):
    spec = S.spec(ticks=64)
    a, b = S.load.ArrivalStream(spec), S.load.ArrivalStream(spec)
    assert np.array_equal(a.counts, b.counts)
    assert a.total() > 0
    for t in (0, 13, 63):
        assert [i for i, _ in a.arrivals(t)] == [i for i, _ in b.arrivals(t)]
    c = S.load.ArrivalStream(dataclasses.replace(spec, seed=8))
    assert not np.array_equal(a.counts, c.counts)
    return dict(a=a.counts, c=c.counts, t13=[i for i, _ in a.arrivals(13)])


def test_arrival_stream_deterministic():
    both(_arrivals)


def _isolated(S):
    spec = S.spec(ticks=64)
    extra = spec.tenants + (
        S.load.TenantSpec("new", rate=1.0, prompt_tokens=4, decode_tokens=4, slo_latency=5.0),
    )
    a = S.load.ArrivalStream(spec)
    b = S.load.ArrivalStream(dataclasses.replace(spec, tenants=extra))
    assert np.array_equal(a.counts, b.counts[: len(spec.tenants)])
    return b.counts


def test_arrival_stream_tenant_isolated():
    both(_isolated)


def test_workload_spec_roundtrip_and_validation():
    jax_side, port = SIDES
    spec = port.spec(churn_every=3, churn_count=2)
    assert TL.WorkloadSpec.from_json(spec.to_json()) == spec
    # across packages: the same JSON both ways
    jspec = jax_side.spec(churn_every=3, churn_count=2)
    assert jspec.to_json() == spec.to_json()
    assert TL.WorkloadSpec.from_json(jspec.to_json()) == spec
    with pytest.raises(ValueError):
        TL.WorkloadSpec(tenants=()).validate()
    with pytest.raises(ValueError):
        port.spec(tenants=(
            TL.TenantSpec("x", rate=-1, prompt_tokens=4, decode_tokens=4, slo_latency=1.0),
        )).validate()
    with pytest.raises(ValueError):
        port.spec(tenants=port.spec().tenants + port.spec().tenants).validate()


def test_pow2_chunks():
    assert TL.pow2_chunks(0) == []
    assert TL.pow2_chunks(7) == [4, 2, 1]
    assert TL.pow2_chunks(12) == [8, 4]
    for n in range(1, 40):
        chunks = TL.pow2_chunks(n)
        assert chunks == JL.pow2_chunks(n) and sum(chunks) == n
        assert all(c & (c - 1) == 0 for c in chunks)


# -- generator over a live engine -------------------------------------------


def _deterministic_run(S, models):
    spec = S.spec(ticks=10, churn_every=2)
    runs = []
    for _ in range(2):
        clear_program_caches()  # each run compiles from empty caches
        eng = S.engine(models, scheduler="slo", leap=dict(budget_blocks_per_tick=4))
        gen = S.load.LoadGenerator(eng, spec, scheduler=eng.driver.scheduler)
        runs.append(dict(report=gen.run(), log=gen.tick_log, engine=engine_outcome(eng)))
        gen.verify_accounting()
    assert runs[0]["report"] == runs[1]["report"]  # modeled clock => bit-identical
    same(runs[0], runs[1])
    return runs[0]


def test_generator_deterministic_run(models):
    both(_deterministic_run, models)


def _backpressure(S, models):
    eng = S.engine(models, slots_per_region=16)
    spec = S.spec(
        tenants=(S.load.TenantSpec("flood", rate=3.0, prompt_tokens=6, decode_tokens=8,
                                   slo_latency=5.0),),
        ticks=12, max_queue=4,
    )
    gen = S.load.LoadGenerator(eng, spec)
    rep = gen.run()  # raises RuntimeError if backpressure ever fails
    gen.verify_accounting()
    assert rep["dropped"] > 0
    assert max(e["queued"] for e in gen.tick_log) > 0
    assert rep["completed"] > 0
    acc = eng.page_accounting()
    assert acc["used"] + acc["spare"] + acc["free"] == acc["total"]
    return dict(report=rep, log=gen.tick_log, engine=engine_outcome(eng))


def test_admission_backpressure_out_of_slots(models):
    both(_backpressure, models)


def _feeds_slo(S, models):
    eng = S.engine(models, scheduler="slo", leap=dict(budget_blocks_per_tick=8))
    sched = eng.driver.scheduler
    assert isinstance(sched, S.pipe.SloScheduler)
    gen = S.load.LoadGenerator(eng, S.spec(ticks=8, churn_every=2), scheduler=sched)
    rep = gen.run()
    assert set(sched._slo) == {"gold", "batch"}
    assert sched.min_slack() < 1.0
    return dict(report=rep, slack=sched.min_slack(), pacing=sched.pacing_factor(),
                engine=engine_outcome(eng))


def test_generator_feeds_slo_scheduler(models):
    both(_feeds_slo, models)


# -- SLO scheduler policy ---------------------------------------------------


def _pacing_curve(S):
    sched = S.pipe.SloScheduler(S.pipe.SloConfig(window=8, low_slack=0.1, high_slack=0.5))
    sched.register_tenant("t", slo_latency=2.0)
    out = [sched.pacing_factor()]
    assert out[-1] == 1.0
    sched.observe_tokens("t", [0.5] * 8)
    out.append(sched.pacing_factor())
    assert out[-1] == 1.0
    sched.observe_tokens("t", [1.8] * 8)
    out.append(sched.pacing_factor())
    assert out[-1] == 0.0
    sched.observe_tokens("t", [1.4] * 8)
    out.append(sched.pacing_factor())
    assert 0.0 < out[-1] < 1.0
    cfg = S.P.core.LeapConfig(budget_blocks_per_tick=8)
    assert sched.tick_budget(cfg) >= sched.cfg.min_blocks
    assert sched.link_unit(cfg, 8) >= sched.cfg.min_blocks
    return out + [sched.tick_budget(cfg), sched.link_unit(cfg, 8)]


def test_slo_pacing_factor_curve():
    both(_pacing_curve)


def _priority_by_slack(S):
    sched = S.pipe.SloScheduler(S.pipe.SloConfig(window=8))
    sched.register_tenant("tight", slo_latency=1.0)
    sched.register_tenant("loose", slo_latency=10.0)
    sched.observe_tokens("tight", [0.95] * 8)
    sched.observe_tokens("loose", [0.95] * 8)
    prio = [sched.migration_priority("tight"), sched.migration_priority("loose")]
    assert prio[0] > prio[1]
    return prio


def test_slo_migration_priority_orders_by_slack():
    both(_priority_by_slack)


def _overtake(S):
    P = S.P
    cfg = P.core.PoolConfig(2, 64, (4,))
    driver = P.driver(cfg, 32, np.zeros(32), leap=P.core.LeapConfig(
        initial_area_blocks=2, chunk_blocks=2, budget_blocks_per_tick=2))
    session = driver.default_session()
    sched = S.pipe.SloScheduler(S.pipe.SloConfig(window=8))
    sched.register_tenant("gold", slo_latency=1.0)
    sched.observe_tokens("gold", [0.99] * 8)
    background = session.leap(np.arange(16), 1, priority=0)
    session.tick()
    session.poll(block=True)
    assert not background.done
    urgent = session.leap(np.arange(20, 24), 1, priority=sched.migration_priority("gold"))
    ticks = 0
    for _ in range(4):
        session.tick()
        session.poll(block=True)
        ticks += 1
        if urgent.done:
            break
    assert urgent.done and not background.done, (urgent.progress(), background.progress())
    progress = [dataclasses.asdict(h.progress()) for h in (urgent, background)]
    assert session.drain()
    return dict(ticks=ticks, progress=progress, host_table=driver.host_table())


def test_slo_priority_overtakes_background_drain():
    both(_overtake)


# -- per-tenant telemetry ---------------------------------------------------


def _tenant_metrics(S, models):
    jc = models[0]
    eng = S.engine(models)
    rng = np.random.default_rng(0)
    sid = eng.admit(rng.integers(0, jc.vocab_size, size=6), region=0, tenant="gold")
    eng.admit(rng.integers(0, jc.vocab_size, size=6), region=1, tenant="batch")
    eng.observe_tokens("gold", [1.0, 2.0, 3.0])
    eng.observe_tokens("batch", 5.0)
    handle = eng.rebalance(sid, 1)
    while not handle.done:
        eng.tick()
    text = eng.telemetry().metrics_text()
    assert 'leap_tenant_tokens_total{tenant="gold"} 3' in text
    assert 'leap_tenant_tokens_total{tenant="batch"} 1' in text
    assert 'leap_tenant_token_latency_bucket{tenant="gold",le="2"} 2' in text
    assert 'leap_tenant_token_latency_count{tenant="gold"} 3' in text
    p = handle.progress()
    moved = (p.committed + p.forced) * eng.pool_cfg.block_bytes
    assert moved > 0
    assert f'leap_tenant_migration_bytes_total{{tenant="gold"}} {moved}' in text
    assert 'leap_tenant_migration_bytes_total{tenant="batch"}' not in text
    stats = eng.tenant_stats()
    assert stats["gold"]["migration_bytes"] == moved
    assert stats["batch"]["tokens"] == 1
    js = eng.telemetry().metrics_json()
    assert js["counters"]['leap_tenant_tokens_total{tenant="gold"}'] == 3
    assert 'leap_tenant_token_latency{tenant="gold"}' in js["histograms"]
    tenant_lines = sorted(ln for ln in text.splitlines() if ln.startswith("leap_tenant"))
    return dict(lines=tenant_lines, stats=stats, engine=engine_outcome(eng))


def test_tenant_metrics_exposition(models):
    both(_tenant_metrics, models)


# -- autoscaler -------------------------------------------------------------


def _four_on_region_0(S, models, seed):
    eng = S.engine(models)
    rng = np.random.default_rng(seed)
    for _ in range(4):
        eng.admit(rng.integers(0, models[0].vocab_size, size=6), region=0)
    return eng


def _autoscaler_drains(S, models):
    eng = _four_on_region_0(S, models, 1)
    sched = S.pipe.SloScheduler(S.pipe.SloConfig(window=4))
    sched.register_tenant("t", slo_latency=2.0)
    sched.observe_tokens("t", [0.5] * 4)
    scaler = S.load.RegionAutoscaler(eng, sched, max_moves_per_tick=1)
    moved = scaler.step()
    assert len(moved) == 1 and moved[0][1] == 1
    assert eng.seqs[moved[0][0]].region == 1
    return dict(moved=moved, engine=engine_outcome(eng))


def test_autoscaler_drains_when_slack_allows(models):
    both(_autoscaler_drains, models)


def _autoscaler_yields(S, models):
    eng = _four_on_region_0(S, models, 2)
    sched = S.pipe.SloScheduler(S.pipe.SloConfig(window=4))
    sched.register_tenant("t", slo_latency=2.0)
    sched.observe_tokens("t", [1.9] * 4)
    scaler = S.load.RegionAutoscaler(eng, sched, max_moves_per_tick=2)
    assert scaler.step() == []
    assert scaler.yields == 1
    moved = S.load.RegionAutoscaler(eng, None, max_moves_per_tick=2).step()
    assert len(moved) == 2
    return dict(moved=moved, engine=engine_outcome(eng))


def test_autoscaler_yields_under_slo_pressure(models):
    both(_autoscaler_yields, models)


# -- chaos serving workload -------------------------------------------------


def test_chaos_serving_scenario_runs_invariants():
    """Both packages' chaos serving workloads (each with its own tiny
    model's weights) report the same counts, tables and load reports."""
    spec = TC.ScenarioSpec(
        seed=5, ticks=10, n_regions=2, slots_per_region=32, workload="serving",
        scheduler="slo", serving_rate=0.5, serving_churn_every=2,
        faults=(TC.FaultEvent("cancel_storm", tick=5, args={"frac": 0.5}),),
    )
    assert TC.ScenarioSpec.from_json(spec.to_json()) == spec
    _, rep = both_chaos(spec)
    assert rep.completed
    assert rep.checks_run > spec.ticks
    assert rep.blocks_requested > 0


def test_chaos_serving_rejects_raw_pool_faults():
    with pytest.raises(ValueError, match="serving"):
        TC.ScenarioSpec(workload="serving",
                        faults=(TC.FaultEvent("out_of_slots", tick=1),)).validate()


# -- SloScheduler end to end through the generator ----------------------------


def _serving_slo(S, models, scheduler):
    """``benchmarks/serving_slo.py``'s run at its high load (1.0)."""
    eng = S.engine(models, slots_per_region=96, scheduler=scheduler, leap=dict(
        initial_area_blocks=2, chunk_blocks=1, budget_blocks_per_tick=8,
        max_attempts_before_force=4))
    spec = S.spec(
        tenants=(
            S.load.TenantSpec("gold", rate=0.45, prompt_tokens=6, decode_tokens=10,
                              slo_latency=2.5, priority=2, region=0),
            S.load.TenantSpec("batch", rate=0.3, prompt_tokens=8, decode_tokens=14,
                              slo_latency=10.0, priority=0, region=1),
        ),
        ticks=48, seed=11, churn_every=2, churn_count=2,
    )
    gen = S.load.LoadGenerator(eng, spec, scheduler=eng.driver.scheduler)
    gen.run()
    gen.verify_accounting()
    rep = gen.report(warmup=16)
    assert rep["dropped"] == 0
    return dict(report=rep, log=gen.tick_log, engine=engine_outcome(eng))


def test_slo_scheduler_through_the_generator_matches_jax(models):
    """Under the plain scheduler migration pushes the gold tenant past its
    SLO; ``SloScheduler`` paces it back under while still migrating — on
    both packages, with the same report bit for bit."""
    reps = {s: both(_serving_slo, models, s)["report"] for s in ("leap", "slo")}
    assert not reps["leap"]["tenants"]["gold"]["slo_met"]
    assert reps["slo"]["tenants"]["gold"]["slo_met"]
    assert reps["slo"]["mig_rate"] > 0
