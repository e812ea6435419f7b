"""The port's compile model against the JAX package's, on the CPU.

The megastep goes through a variant cache (``repro_torch.core.graphs``), the
port's counterpart of ``jax.jit``'s: on the card a variant is a captured CUDA
graph, on the CPU it is only registered.  Both packages run the same drains
through ``test_torch_driver.Pair``: every megastep call gets the same
operand lengths (the reference's buckets), the port's pad lanes replicate
lane 0 where the reference's hold out-of-bounds sentinels, the state stays
bit-identical, and ``jit_cache_misses`` is equal, cold and with
``warm_dispatch``.  The decode step keeps one variant per batch size.  The
graphed path itself runs on the card (``tests/test_torch_cuda.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import migrator as jmig  # noqa: E402
from repro.serving.engine import PagedConfig as JPagedConfig  # noqa: E402
from repro.serving.engine import PagedEngine as JPagedEngine  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core import migrator as tmig  # noqa: E402
from repro_torch.core.queues import VerdictFuture  # noqa: E402
from repro_torch.kernels import heat_scan, leap_copy, paged_attn  # noqa: E402
from repro_torch.serving.engine import PagedConfig, PagedEngine  # noqa: E402

from test_torch_driver import Pair  # noqa: E402
from test_torch_serving import LIVE, models  # noqa: E402, F401

# The megastep's operands after the state, in order, and the out-of-bounds
# sentinel the reference pads each with (None: it replicates lane 0 too).
OPERANDS = (
    ("commit_ids", "N"), ("commit_regions", "R"), ("commit_slots", "S"),
    ("grp_members", None), ("grp_regions", None), ("grp_starts", None),
    ("begin_ids", "N"), ("zero_flat", "RS"), ("force_ids", "N"), ("force_regions", "R"),
    ("force_slots", "S"), ("copy_src", None), ("copy_dst", None), ("run_src", None),
    ("run_dst", None), ("heat", None), ("heat_ids", "L"), ("heat_w", "L"),
)


def _small(warm):
    return Pair(64, 128, dict(initial_area_blocks=16, budget_blocks_per_tick=16,
                              warm_dispatch=warm), seed=1), dict(leaps=[(np.arange(64), 1)],
                                                                 writes=2)


def _retry_storm(warm):
    return Pair(32, 64, dict(initial_area_blocks=8, chunk_blocks=4, budget_blocks_per_tick=8,
                             max_attempts_before_force=2, warm_dispatch=warm),
                seed=3), dict(leaps=[(np.arange(32), 1)], writes=8)


def _two_tier(warm):
    p = Pair(32, 48, dict(initial_area_blocks=8, budget_blocks_per_tick=8, warm_dispatch=warm),
             huge_factor=4, seed=5)
    for d in (p.j, p.t):
        assert d.adopt_huge(np.arange(8)) == 8
    return p, dict(leaps=[(np.arange(32), 1)], writes=3)


def _tiering(warm):
    return Pair(24, 32, dict(budget_blocks_per_tick=8, tiering=True, tier_heat_decay=0.8,
                             tier_write_weight=2.0, promote_per_tick=1, warm_dispatch=warm),
                n_regions=3, huge_factor=4, topology=True, placement=np.full(24, 2, np.int32),
                seed=11), dict(leaps=[(np.arange(12), 0), (np.arange(12, 24), 1)], writes=2,
                               reads=4)


SCENARIOS = {"small": _small, "retry_storm": _retry_storm, "two_tier": _two_tier,
             "tiering": _tiering}


def _record(monkeypatch, module, calls):
    """Wrap ``module.megastep`` to keep every call's operands as numpy arrays."""
    inner = module.megastep

    def tap(state, *operands, **kw):
        calls.append([np.asarray(x) for x in operands])
        return inner(state, *operands, **kw)

    monkeypatch.setattr(module, "megastep", tap)


def _drive(p, plan, seed):
    rng = np.random.default_rng(seed)
    n = p.n_blocks
    for ids, dst in plan["leaps"]:
        p.leap(ids, dst)
    for step in range(300):
        if all(s.done for s in p.sessions) and step > 2:
            break
        if plan.get("reads"):
            p.read(rng.choice(n, size=plan["reads"], replace=False))
        p.tick()
        k = plan["writes"]
        ids = rng.choice(n, size=k, replace=False)
        p.write(ids, rng.normal(size=(k,) + p.expected.shape[1:]).astype(np.float32))
        p.assert_equal()
    p.drain()
    p.assert_equal()


def _check_pads(jcall, tcall, p):
    """The port's operands equal the reference's on the real lanes and in
    length; its pad lanes repeat lane 0 (heat weights: 0) where the
    reference's hold sentinels."""
    pc = p.t.pool_cfg
    sentinel = {"N": p.n_blocks, "R": pc.n_regions, "S": pc.slots_per_region,
                "RS": pc.n_regions * pc.slots_per_region}
    heat_real = None
    for (name, kind), j, t in zip(OPERANDS, jcall, tcall):
        assert t.shape == j.shape, name
        if name == "heat" or not len(j):
            continue
        if kind is None:
            np.testing.assert_array_equal(t, j, err_msg=name)
            continue
        if name == "heat_ids":
            real = heat_real = int((j != len(jcall[OPERANDS.index(("heat", None))])).sum())
        elif name == "heat_w":
            real = heat_real
        else:
            real = int((j != sentinel[kind]).sum())
            assert (j[real:] == sentinel[kind]).all(), name
        np.testing.assert_array_equal(t[:real], j[:real], err_msg=name)
        pad = 0.0 if name == "heat_w" else t[0]
        assert (t[real:] == pad).all(), name


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm_dispatch"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_padded_drain_matches_the_reference(scenario, warm, monkeypatch):
    """Every tick of a drain: the same buckets and pad lanes as the JAX
    package's megastep, bit-identical state (``Pair.assert_equal``, which
    also holds ``jit_cache_misses`` equal), and as many variants."""
    p, plan = SCENARIOS[scenario](warm)
    jcalls, tcalls = [], []
    _record(monkeypatch, jmig, jcalls)
    _record(monkeypatch, tmig, tcalls)
    _drive(p, plan, seed=len(scenario))
    assert len(tcalls) == len(jcalls) > 0
    for jcall, tcall in zip(jcalls, tcalls):
        _check_pads(jcall, tcall, p)
    assert len(tmig.MEGASTEP) == jmig.program_cache_sizes()["megastep"] > 0


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_warm_dispatch_registers_the_reference_signatures(scenario):
    """A driver built with ``warm_dispatch`` registers as many megastep
    variants as the JAX package compiles, and its first tick may miss only
    where the reference's does."""
    jmig.megastep.clear_cache()
    tmig.MEGASTEP.clear()
    p, _ = SCENARIOS[scenario](True)
    assert len(tmig.MEGASTEP) == jmig.megastep._cache_size() in (3, 7, 11, 15)
    assert tmig.program_cache_size() == len(tmig.MEGASTEP)
    assert p.t.stats.jit_cache_misses == p.j.stats.jit_cache_misses == 0


def test_jit_misses_land_as_events():
    """tests/test_obs.py's test over both packages: a fresh driver's megastep
    variants surface as "jit" events carrying the per-tick delta, on the same
    ticks as the reference's."""
    events = {}
    for P, mig in ((J, jmig), (T, tmig)):
        if P is J:
            mig.megastep.clear_cache()
        else:
            mig.MEGASTEP.clear()
        cfg = P.PoolConfig(2, 24, (6,))
        state = P.init_state(cfg, 16, np.zeros(16, np.int32), **({} if P is J else
                                                                   {"device": "cpu"}))
        drv = P.MigrationDriver(state, cfg, P.LeapConfig(
            initial_area_blocks=4, chunk_blocks=3, budget_blocks_per_tick=6, telemetry=True))
        sess = drv.default_session()
        sess.leap(np.arange(16), 1)
        while not drv.done:
            sess.tick()
            sess.poll(block=True)
        misses = [e for e in drv.telemetry.events() if e["kind"] == "jit"]
        assert drv.stats.jit_cache_misses > 0
        assert sum(e["args"]["n"] for e in misses) == drv.stats.jit_cache_misses
        events[P is T] = [(e["tick"], e["args"]["n"]) for e in misses]
    assert events[True] == events[False]


def test_disable_capture_registers_nothing():
    """Inside ``disable_capture`` (``jax.disable_jit``'s counterpart) the
    drain runs eagerly, registers no variant and counts no miss, and ends in
    the same state as the registered run."""
    runs = {}
    for name in ("registered", "disabled"):
        tmig.MEGASTEP.clear()
        cfg = T.PoolConfig(2, 40, (3, 5))
        state = T.LeapState.from_numpy(
            np.random.default_rng(0).normal(size=(2, 40, 3, 5)).astype(np.float32),
            np.stack([np.zeros(32), np.arange(32)], 1).astype(np.int32),
            np.zeros(32, bool), np.zeros(32, bool), "cpu")
        drv = T.MigrationDriver(state, cfg, T.LeapConfig(budget_blocks_per_tick=8))
        sess = drv.default_session()
        sess.leap(np.arange(32), 1)
        if name == "disabled":
            with graphs.disable_capture():
                assert sess.drain()
            assert len(tmig.MEGASTEP) == 0 and drv.stats.jit_cache_misses == 0
        else:
            assert sess.drain()
            assert len(tmig.MEGASTEP) == drv.stats.jit_cache_misses > 0
        runs[name] = drv
    for a, b in zip(runs["registered"].state.to_numpy(), runs["disabled"].state.to_numpy()):
        np.testing.assert_array_equal(a, b)


def _verdict_ticks(device):
    """Two megastep calls of one variant: the first verdict, wrapped in a
    ``VerdictFuture`` before the second call, reads back unchanged."""
    n = 8
    state = T.LeapState.from_numpy(
        np.zeros((2, 16, 4), np.float32), np.stack([np.zeros(n), np.arange(n)], 1).astype(np.int32),
        np.array([1, 0, 1, 0, 0, 0, 0, 0], bool), np.ones(n, bool), device)
    empty = torch.zeros(0, dtype=torch.int64)
    ids = torch.arange(4)

    def tick(dirty_ids):
        state.dirty.zero_()
        state.dirty[torch.as_tensor(dirty_ids, dtype=torch.int64).to(state.device)] = True
        _, verdict, _, _ = tmig.megastep(
            state, ids, torch.ones(4, dtype=torch.int64), ids + 8, *([empty] * 12),
            torch.zeros(0), empty, torch.zeros(0))
        return VerdictFuture(verdict)

    first = tick([0, 2])
    second = tick([1, 3])
    assert first.result().tolist() == [True, False, True, False]
    assert second.result().tolist() == [False, True, False, True]


def test_verdict_survives_the_next_tick():
    _verdict_ticks("cpu")


def test_replay_counts_what_its_capture_counted():
    """The launch counters a capture advanced are put back (the capture ran
    nothing) and added again at every replay."""
    before = graphs._counts()
    leap_copy.copy_blocks.launches += 2
    heat_scan.heat_scan.launches += 1
    paged_attn.paged_decode.launches_by_head_dim[64] = (
        paged_attn.paged_decode.launches_by_head_dim.get(64, 0) + 3)
    delta = graphs._restore(before)
    assert graphs._counts() == before
    assert delta == {(leap_copy.copy_blocks, "launches"): 2,
                     (heat_scan.heat_scan, "launches"): 1,
                     (paged_attn.paged_decode, "launches_by_head_dim"): {64: 3}}
    graphs._advance(delta)
    graphs._advance(delta)
    assert leap_copy.copy_blocks.launches == before[leap_copy.copy_blocks, "launches"] + 4
    assert paged_attn.paged_decode.launches_by_head_dim[64] == before[
        paged_attn.paged_decode, "launches_by_head_dim"].get(64, 0) + 6
    graphs._restore(before)


def test_one_decode_variant_per_batch_size(models):
    """The decode step keeps one variant per batch size in both packages:
    batches of 3, 3, 2, 3 and 1 sequences make three."""
    jcfg, tcfg, jparams, tmodel = models
    jeng = JPagedEngine(jcfg, jparams, JPagedConfig(leap=J.LeapConfig(**LIVE)))
    teng = PagedEngine(tcfg, tmodel, PagedConfig(leap=T.LeapConfig(**LIVE)), device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n) for n in (6, 9, 4)]
    jsids = [jeng.admit(p) for p in prompts]
    tsids = [teng.admit(p) for p in prompts]
    for k in (3, 3, 2, 3, 1):
        assert teng.decode(tsids[:k]) == jeng.decode(jsids[:k])
    assert teng._decode_shapes == jeng._decode_shapes == {1, 2, 3}
    assert len(teng._decode_step) == jeng._decode_step._cache_size() == 3
    with graphs.disable_capture():  # no variant registered for a batch of 4
        teng.decode(tsids + tsids[:1])
    assert len(teng._decode_step) == 3 and 4 in teng._decode_shapes
