"""Chaos harness: declarative scenario matrix + standing-invariant checker.

The paper's reliability claims ("all pages are eventually migrated",
"handles concurrent writes correctly") only show up under adversarial
interleavings — concurrent writers, faults mid-epoch, congestion,
cancellation storms.  This package institutionalizes that probing
(DESIGN.md §9):

  spec        :class:`ScenarioSpec` / :class:`FaultEvent` — a declarative,
              JSON-round-tripping description of one scenario.
  driver      :class:`ChaosDriver` — runs a spec tick-by-tick through the
              real ``LeapSession``/pipeline, injecting the fault schedule.
  invariants  :class:`InvariantChecker` — slot conservation, request
              accounting, payload integrity, table-mirror consistency;
              shared with the ordinary test suites.
  strategies  ``sample_spec`` (pure seeded sampling, CI sweeps) and
              Hypothesis strategies (generative exploration + shrinking).

Failing specs serialize to a repro file; replay with
``python -m repro_torch.chaos --replay <spec.json>``.
"""

from repro_torch.chaos.driver import (
    ChaosDriver,
    ChaosReport,
    run_scenario,
    run_with_repro,
)
from repro_torch.chaos.invariants import (
    HysteresisMonitor,
    InvariantChecker,
    InvariantViolation,
)
from repro_torch.chaos.sabotage import SABOTAGES, apply_sabotage
from repro_torch.chaos.spec import EVENT_KINDS, FaultEvent, ScenarioSpec
from repro_torch.chaos.strategies import sample_spec, sabotage_specs, scenario_specs

__all__ = [
    "EVENT_KINDS",
    "SABOTAGES",
    "ChaosDriver",
    "ChaosReport",
    "FaultEvent",
    "HysteresisMonitor",
    "InvariantChecker",
    "InvariantViolation",
    "ScenarioSpec",
    "apply_sabotage",
    "run_scenario",
    "run_with_repro",
    "sabotage_specs",
    "sample_spec",
    "scenario_specs",
]
