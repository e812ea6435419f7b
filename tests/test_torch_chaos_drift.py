"""Counter drift under chaos, on the port, against the JAX package.

The cases of ``tests/test_obs_drift.py``: after a chaos scenario the port's
telemetry counter totals must equal its ``MigrationStats`` fields, replaying
its event log must give the same totals when the ring never evicted, and
both must equal the JAX package's totals for the same scenario (run with
blocking harvest, ``test_torch_chaos.jax_chaos``).  One bounded Hypothesis
case drives generated scenarios through the same checks.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from test_torch_chaos import jax_chaos, port_chaos  # noqa: E402

import repro_torch.chaos as T  # noqa: E402

#: Stats fields mirrored 1:1 into the telemetry counter log.
MIRRORED = (
    "blocks_requested",
    "blocks_migrated",
    "blocks_forced",
    "blocks_cancelled",
    "bytes_copied",
    "dispatches",
)
#: Mirrored too, but only nonzero on some scenario shapes.
MIRRORED_EXTRA = (
    "dirty_rejections",
    "splits",
    "huge_areas_committed",
    "demotions",
    "promotions",
    "bytes_copied_huge",
    "deferred_congested",
    "multi_hop_areas",
)


def _replay_totals(events):
    totals: dict[str, int] = {}
    for ev in events:
        if ev["kind"] == "counter":
            totals[ev["name"]] = totals.get(ev["name"], 0) + ev["n"]
    return totals


def _assert_no_drift(driver):
    rec = driver.telemetry
    assert rec.enabled  # chaos always records (trace-on-failure contract)
    totals = rec.counter_totals()
    for key in MIRRORED + MIRRORED_EXTRA:
        assert totals.get(key, 0) == getattr(driver.stats, key), (
            f"counter {key!r} drifted: event log says {totals.get(key, 0)}, "
            f"MigrationStats says {getattr(driver.stats, key)}"
        )
    if rec.dropped == 0:
        assert _replay_totals(rec.events()) == totals


def _both_drift_free(spec):
    """The scenario on both packages: each drift-free, with equal totals."""
    drivers = []
    for chaos in (jax_chaos(spec), port_chaos(spec)):
        assert chaos.run().completed
        _assert_no_drift(chaos.driver)
        drivers.append(chaos.driver)
    jd, td = drivers
    assert td.telemetry.counter_totals() == jd.telemetry.counter_totals()
    return td


@pytest.mark.parametrize("seed", range(6))
def test_seeded_chaos_scenarios_never_drift(seed):
    driver = _both_drift_free(T.sample_spec(seed))
    assert driver.stats.blocks_requested > 0  # scenario actually moved


@pytest.mark.parametrize("mode", ["legacy", "batched"])
def test_seeded_chaos_never_drifts_on_prior_dispatch_generations(mode):
    _both_drift_free(dataclasses.replace(T.sample_spec(2), dispatch=mode))


def test_megastep_counts_one_dispatch_per_device_sync():
    driver = _both_drift_free(T.sample_spec(3))
    assert driver.stats.dispatches <= driver.stats.ticks
    per_program = [
        ev for ev in driver.telemetry.events()
        if ev["kind"] == "counter" and ev["name"] == "dispatches"
    ]
    assert per_program, "scenario must dispatch"
    assert all(ev["n"] == 1 for ev in per_program)
    assert {ev["args"]["program"] for ev in per_program} == {"megastep"}


def test_drift_check_survives_ring_eviction():
    chaos = port_chaos(T.sample_spec(1))
    rec = chaos.driver.telemetry
    rec._events = type(rec._events)(maxlen=32)
    rec.capacity = 32
    chaos.run()
    assert rec.dropped > 0
    _assert_no_drift(chaos.driver)


try:
    from hypothesis import given, settings
except ImportError:  # pragma: no cover - optional dev dependency
    given = None


if given is not None:

    @settings(max_examples=6, deadline=None)
    @given(spec=T.scenario_specs())
    def test_generated_chaos_scenarios_never_drift(spec):
        _both_drift_free(spec)
