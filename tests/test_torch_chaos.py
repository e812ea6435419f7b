"""The port's chaos harness against the JAX package's, on the CPU.

The cases of ``tests/test_chaos.py`` over both packages: spec round trips
(the port reads the JAX package's JSON and writes the same dict back), the
seeded ``sample_spec`` sweep, the explicit fault matrix, the sabotage that
the checker must catch with a replayable repro (``python -m
repro_torch.chaos --replay ... --device cpu``), the checker's unit cases,
``drain_region`` idempotency and the working-set-shift tiering scenarios.
A scenario passes only when both packages report the same ``ChaosReport``
and end in the same state: host table, pool, flags, shadow and
``MigrationStats`` (``jit_cache_misses`` too, from empty program caches)
bit for bit, heat within rtol = atol = 1e-6.

Both sides harvest with ``poll(block=True)`` before every invariant check.
The port's ``ChaosDriver`` does so itself (ROADMAP D2); the JAX package's is
wrapped here (:func:`jax_chaos`), since its non-blocking harvest lets the
mirror check race an unharvested commit (ROADMAP R1) and lets harvest
timing steer its decisions (R2).  Last, a source scan keeps every port chaos
module but ``sabotage.py`` off pipeline privates, and one bounded
Hypothesis case holds generated scenarios to the same agreement.
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from test_torch_baselines import JAX, PORT, assert_same  # noqa: E402
from test_torch_driver import clear_program_caches  # noqa: E402

import repro.chaos as J  # noqa: E402
import repro_torch.chaos as T  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent

# The minimal deterministic scenario that trips the ``skip_quarantine``
# sabotage (tests/test_chaos.py): a sync-policy exchange over a spread
# placement forces both directions in one tick with fresh-alloc zero fill.
SABOTAGE_SPEC = T.ScenarioSpec(
    seed=0, ticks=4, n_regions=2, slots_per_region=16, n_blocks=8, block_elems=4,
    placement="spread", scheduler="sync", workload="exchange",
)

WSS_SPEC = T.ScenarioSpec(
    seed=7, ticks=40, n_regions=3, slots_per_region=16, n_blocks=12,
    topology="cxl_pooled", topology_args=(2, 1), workload="working_set_shift",
    tiering=True, tier_epoch=2, shift_every=10, hot_frac=0.25, reads_per_tick=8,
)


# ---------------------------------------------------------------------------
# Harness: one scenario through each package
# ---------------------------------------------------------------------------


def jax_spec(spec):
    return J.ScenarioSpec.from_dict(spec.to_dict())


def jax_chaos(spec, sabotage=None):
    """The JAX package's ``ChaosDriver`` for a port ``spec``, harvesting with
    ``poll(block=True)`` before every invariant check and placement reading,
    as the port's does."""
    chaos = J.ChaosDriver(jax_spec(spec), sabotage=sabotage)
    poll = chaos.session.poll
    chaos.session.poll = lambda block=False: poll(block=True)
    for name in ("check_all", "check_final"):
        check = getattr(chaos.checker, name)

        def harvested(*args, _check=check, **kw):
            poll(block=True)
            return _check(*args, **kw)

        setattr(chaos.checker, name, harvested)
    return chaos


def port_chaos(spec, sabotage=None):
    return T.ChaosDriver(spec, sabotage=sabotage, device="cpu")


def chaos_outcome(chaos, report) -> dict:
    """Everything the two packages must agree on after a scenario.  Under
    the serving workload each package's tiny model has its own random
    weights, so the KV pool's bytes are left out (tables and flags stay)."""
    drv = chaos.driver
    st = drv.state
    if hasattr(st, "to_numpy"):
        pool, *flags = st.to_numpy()
    else:
        pool, *flags = (np.asarray(x) for x in (st.pool, st.table, st.dirty, st.in_flight))
    stats = dataclasses.asdict(drv.stats)
    rep = dataclasses.asdict(report)
    rep["spec"] = report.spec.to_dict()
    out = dict(report=rep, flags=flags, host_table=drv.host_table(), stats=stats,
               heat=drv.heat_snapshot())
    if chaos.generator is None:
        out.update(pool=pool, shadow=np.asarray(chaos.shadow))
    else:
        out.update(load=chaos.generator.report(), log=chaos.generator.tick_log,
                   pages=chaos.engine.page_accounting())
    return out


def both_chaos(spec, **kw):
    """Run ``spec`` through both packages; returns the port's driver and
    report after asserting that the outcomes agree."""
    clear_program_caches()
    jc = jax_chaos(spec, **kw)
    want = chaos_outcome(jc, jc.run())
    clear_program_caches()
    tc = port_chaos(spec, **kw)
    report = tc.run()
    assert_same(want, chaos_outcome(tc, report))
    return tc, report


# ---------------------------------------------------------------------------
# Spec round trips
# ---------------------------------------------------------------------------


def test_spec_json_roundtrip_with_faults():
    spec = T.ScenarioSpec(
        seed=7, ticks=12, n_regions=4, slots_per_region=16, n_blocks=8,
        topology="cxl_pooled", topology_args=(2, 2), workload="stream",
        faults=(
            T.FaultEvent("drain_region", tick=3, args={"region": 1}),
            T.FaultEvent("congest_link", args={"src": 0, "dst": 1, "factor": 4.0}),
            T.FaultEvent("cancel_storm", tick=5, args={"frac": 0.5}),
        ),
    )
    spec.validate()
    assert T.ScenarioSpec.from_json(spec.to_json()) == spec
    assert T.ScenarioSpec.from_dict(spec.to_dict()) == spec
    raw = json.loads(spec.to_json())
    assert raw["faults"][0] == {"kind": "drain_region", "tick": 3, "args": {"region": 1}}
    # across packages: the port reads the JAX package's JSON and writes the
    # same dict back, and the other way round
    jspec = jax_spec(spec)
    assert jspec.to_json() == spec.to_json()
    assert T.ScenarioSpec.from_json(jspec.to_json()).to_dict() == jspec.to_dict()


def test_spec_rejects_unknown_fields_and_bad_events():
    with pytest.raises(ValueError, match="warp_factor"):
        T.ScenarioSpec.from_dict({"seed": 1, "warp_factor": 9})
    with pytest.raises(ValueError):
        T.ScenarioSpec(faults=(T.FaultEvent("meteor_strike"),)).validate()
    with pytest.raises(ValueError):
        T.ScenarioSpec(n_blocks=99, slots_per_region=16).validate()
    with pytest.raises(ValueError):
        T.ScenarioSpec(topology="two_socket", n_regions=3).validate()
    assert T.EVENT_KINDS == J.EVENT_KINDS and T.SABOTAGES == J.SABOTAGES


def test_sampled_specs_are_valid_and_deterministic():
    for seed in range(20):
        spec = T.sample_spec(seed)
        spec.validate()
        assert spec == T.sample_spec(seed)
        assert all(ev.kind in T.EVENT_KINDS for ev in spec.faults)
        assert spec.to_json() == J.sample_spec(seed).to_json()  # the same draws


# ---------------------------------------------------------------------------
# Scenario runs
# ---------------------------------------------------------------------------


def test_scenario_run_is_deterministic():
    spec = T.sample_spec(3)
    a, b = port_chaos(spec).run(), port_chaos(spec).run()
    assert a.completed and b.completed
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("seed", range(8))
def test_seeded_scenarios_hold_invariants(seed):
    _, report = both_chaos(T.sample_spec(seed))
    assert report.completed, "scenario pipeline failed to drain"
    assert report.checks_run >= report.spec.ticks + len(report.events_fired) + 1
    assert (report.blocks_migrated + report.blocks_forced + report.blocks_cancelled
            == report.blocks_requested)


def test_explicit_fault_matrix_scenario():
    spec = T.ScenarioSpec(
        seed=11, ticks=20, n_regions=3, slots_per_region=16, n_blocks=10,
        topology="symmetric", workload="stream", leap_every=2, blocks_per_leap=4,
        writes_per_tick=2,
        faults=(
            T.FaultEvent("congest_link", tick=2, args={"src": 0, "dst": 1, "factor": 8.0}),
            T.FaultEvent("drain_region", tick=4, args={"region": 2}),
            T.FaultEvent("cancel_storm", tick=6, args={"frac": 0.5}),
            T.FaultEvent("write_burst", tick=8, args={"blocks": 6}),
            T.FaultEvent("restore_topology", tick=10),
            T.FaultEvent("out_of_slots", tick=12),
        ),
    )
    _, report = both_chaos(spec)
    assert report.completed
    assert len(report.events_fired) == 6


# ---------------------------------------------------------------------------
# Sabotage: the checker must catch a deliberately re-introduced bug
# ---------------------------------------------------------------------------


def test_sabotage_clean_run_passes():
    _, report = both_chaos(SABOTAGE_SPEC)
    assert report.completed and report.blocks_forced == 8


def test_sabotage_is_caught_with_replayable_repro(tmp_path):
    with pytest.raises(J.InvariantViolation) as jexc:
        jax_chaos(SABOTAGE_SPEC, sabotage="skip_quarantine").run()
    with pytest.raises(T.InvariantViolation) as exc:
        T.run_with_repro(SABOTAGE_SPEC, str(tmp_path), sabotage="skip_quarantine",
                         device="cpu")
    assert exc.value.invariant == jexc.value.invariant == "payload"
    assert "--replay" in str(exc.value) and "--device cpu" in str(exc.value)
    path = tmp_path / "last_failure.json"
    assert path.exists()
    replayed = T.ScenarioSpec.from_json(path.read_text())
    assert replayed == SABOTAGE_SPEC
    with pytest.raises(T.InvariantViolation):
        T.run_scenario(replayed, sabotage="skip_quarantine", device="cpu")
    assert T.run_scenario(replayed, device="cpu").completed


def test_sabotage_failure_dumps_a_loadable_trace(tmp_path):
    from repro_torch.obs import validate_chrome_trace

    with pytest.raises(T.InvariantViolation) as exc:
        T.run_with_repro(SABOTAGE_SPEC, str(tmp_path), sabotage="skip_quarantine",
                         device="cpu")
    traces = list(tmp_path.glob("chaos-*-trace.json"))
    assert len(traces) == 1
    assert traces[0].name in str(exc.value)
    trace = json.loads(traces[0].read_text())
    validate_chrome_trace(trace)
    evs = trace["traceEvents"]
    assert any(e["ph"] == "X" and e["name"] == "tick" for e in evs)
    assert any(e.get("cat") == "request" for e in evs)


def test_cli_replay_exit_codes(tmp_path):
    """The port's CLI, with the JAX package's exit codes: 0 clean, 1 on a
    violation; ``--seeds`` sweeps a range."""
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(SABOTAGE_SPEC.to_json())
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "repro_torch.chaos", *args,
                               "--device", "cpu"], cwd=tmp_path, env=env,
                              capture_output=True, text=True, timeout=300)

    clean = cli("--replay", str(spec_path))
    assert clean.returncode == 0, clean.stderr
    broken = cli("--replay", str(spec_path), "--sabotage", "skip_quarantine")
    assert broken.returncode == 1
    assert "payload" in (broken.stdout + broken.stderr)
    sweep = cli("--seeds", "1-2", "--repro-dir", str(tmp_path / "repro"))
    assert sweep.returncode == 0, sweep.stderr
    assert "2/2 scenarios passed" in sweep.stdout


# ---------------------------------------------------------------------------
# Checker unit behaviour
# ---------------------------------------------------------------------------


def test_checker_flags_leaked_slot():
    cfg = PORT.core.PoolConfig(2, 8, (4,))
    drv = PORT.driver(cfg, 4, np.zeros(4))
    drv.debug_free_list(1).take(1)  # leak a slot behind the pipeline's back
    with pytest.raises(T.InvariantViolation) as exc:
        T.InvariantChecker(drv).check_slots()
    assert exc.value.invariant == "slots"
    assert "leaked" in str(exc.value)


def test_checker_flags_payload_divergence():
    cfg = PORT.core.PoolConfig(2, 8, (4,))
    data = np.ones((4, 4), np.float32)
    drv = PORT.driver(cfg, 4, np.zeros(4), data)
    wrong = data.copy()
    wrong[2] += 1.0
    with pytest.raises(T.InvariantViolation, match=r"blocks \[2\]") as exc:
        T.InvariantChecker(drv).check_payload(expected=wrong)
    assert exc.value.invariant == "payload"
    T.InvariantChecker(drv).check_payload(expected=data)
    T.InvariantChecker(drv).check_payload(expected=torch.from_numpy(data))


# ---------------------------------------------------------------------------
# drain_region idempotency
# ---------------------------------------------------------------------------


def _tight_driver(P, huge_factor=1):
    cfg = P.core.PoolConfig(2, 8, (4,), huge_factor=huge_factor)
    data = np.arange(32, dtype=np.float32).reshape(8, 4)
    drv = P.driver(cfg, 8, np.zeros(8), data,
                   leap=P.core.LeapConfig(initial_area_blocks=8))
    return drv, data


def _checker(P):
    return T.InvariantChecker if P.torch else J.InvariantChecker


def _idempotent(P, huge_factor):
    drv, data = _tight_driver(P, huge_factor)
    planned = []
    if huge_factor > 1:
        assert drv.adopt_huge(np.arange(2)) == 2
    planned.append(P.fault.drain_region(drv, 0))
    drv.tick()  # epochs open: every block in flight, all of region 1 reserved
    drv.poll(block=True)
    assert drv.in_migration(np.arange(8)).all()
    planned.append(P.fault.drain_region(drv, 0))
    assert planned == [8, 0]
    assert drv.default_session().drain()
    assert (drv.host_placement() == 1).all()
    _checker(P)(drv).check_final(expected=data)
    stats = dataclasses.asdict(drv.stats)
    return dict(planned=planned, host_table=drv.host_table(), stats=stats)


@pytest.mark.parametrize("huge_factor", [1, 4], ids=["small", "tiered_huge_groups"])
def test_drain_region_idempotent_while_in_flight(huge_factor):
    clear_program_caches()
    want = _idempotent(JAX, huge_factor)
    clear_program_caches()
    assert_same(want, _idempotent(PORT, huge_factor))


def test_drain_region_empty_region_is_noop():
    for P in (JAX, PORT):
        cfg = P.core.PoolConfig(2, 8, (4,))
        assert P.fault.drain_region(P.driver(cfg, 4, np.ones(4)), 0) == 0


def test_chaos_driver_drain_refusal_is_not_a_violation():
    spec = T.ScenarioSpec(
        seed=5, ticks=6, n_regions=2, slots_per_region=8, n_blocks=8, workload="drain",
        faults=(T.FaultEvent("drain_region", tick=0, args={"region": 1}),),
    )
    _, report = both_chaos(spec)
    assert report.completed
    assert report.drain_refusals + len(report.events_fired) >= 1


# ---------------------------------------------------------------------------
# Closed-loop tiering scenarios
# ---------------------------------------------------------------------------


def test_working_set_shift_closes_the_loop():
    _, report = both_chaos(WSS_SPEC)
    assert report.completed
    assert report.blocks_migrated > 0, "tiering policy never moved a block"
    again = port_chaos(WSS_SPEC).run()
    assert again.blocks_migrated == report.blocks_migrated


def test_working_set_shift_spec_roundtrips():
    assert T.ScenarioSpec.from_json(WSS_SPEC.to_json()) == WSS_SPEC
    with pytest.raises(ValueError):
        T.ScenarioSpec(hot_frac=0.0).validate()
    with pytest.raises(ValueError):
        T.ScenarioSpec(tier_epoch=0).validate()


def test_working_set_shift_under_faults():
    spec = T.ScenarioSpec(
        seed=9, ticks=30, n_regions=3, slots_per_region=16, n_blocks=12,
        topology="cxl_pooled", topology_args=(2, 1), workload="working_set_shift",
        tiering=True, tier_epoch=2, shift_every=8,
        faults=(
            T.FaultEvent("out_of_slots", tick=12),
            T.FaultEvent("congest_link", tick=20, args={"src": 0, "dst": 2, "factor": 4.0}),
        ),
    )
    _, report = both_chaos(spec)
    assert report.completed
    assert len(report.events_fired) == 2


def test_hysteresis_monitor_flags_ping_pong():
    placement = np.zeros(4, np.int32)
    mon = T.HysteresisMonitor(placement, window=16, max_moves=2)
    p = placement.copy()
    p[1] = 1
    mon.observe(1, p)
    p[1] = 0
    mon.observe(4, p)
    p[1] = 1
    with pytest.raises(T.InvariantViolation, match="tiering_hysteresis"):
        mon.observe(7, p)


def test_hysteresis_monitor_phase_shift_resets_and_window_expires():
    placement = np.zeros(2, np.int32)
    mon = T.HysteresisMonitor(placement, window=8, max_moves=1)
    p = placement.copy()
    p[0] = 1
    mon.observe(0, p)
    mon.phase_shift()
    p[0] = 0
    mon.observe(1, p)
    p[0] = 1
    mon.observe(20, p)
    p[0] = 0
    with pytest.raises(T.InvariantViolation):
        mon.observe(22, p)


# ---------------------------------------------------------------------------
# Boundaries
# ---------------------------------------------------------------------------

# The private pipeline names of tests/test_api_boundaries.py.
_PRIVATE = (
    "table|free|queue|active|pending|migrating|last_write|policy|"
    "cache_baseline|next_rid|default_session|harvest|alloc|open_epoch|"
    "open_epoch_huge|request_huge|demote_group|finalize_success|remap_host|"
    "note_writes|credit|cancelled|drop_blocks|fire_callbacks|pad|"
    "dispatch_begin_batch|dispatch_force_batch|dispatch_copy_batch|"
    "dispatch_commit_batch|dispatch_copy_runs|dispatch_commit_groups|"
    "dispatch_copy|dispatch_commit|next_copyable|dispatch|freed"
)
_LEAK = re.compile(r"(?<!self)\.\s*_(?:" + _PRIVATE + r")(?![A-Za-z0-9_])")


def test_only_sabotage_reaches_into_pipeline_privates():
    src = REPO / "src" / "repro_torch"
    files = sorted((src / "chaos").glob("*.py")) + sorted((src / "load").glob("*.py"))
    leaks = {f.name: [ln.strip() for ln in f.read_text().splitlines() if _LEAK.search(ln)]
             for f in files}
    assert leaks.pop("sabotage.py"), "the scan must see sabotage's own reach"
    assert not any(leaks.values()), leaks


# ---------------------------------------------------------------------------
# Generative exploration (bounded)
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings
except ImportError:  # pragma: no cover - optional dev dependency
    given = None


if given is not None:

    @settings(max_examples=8, deadline=None)
    @given(spec=T.scenario_specs())
    def test_generated_scenarios_agree_and_hold_invariants(spec):
        assert T.ScenarioSpec.from_json(spec.to_json()) == spec
        _, report = both_chaos(spec)
        assert report.completed, "generated scenario failed to drain"
        assert (report.blocks_migrated + report.blocks_forced + report.blocks_cancelled
                == report.blocks_requested)
