"""Declarative chaos scenarios: topology × pool × workload × fault schedule.

A :class:`ScenarioSpec` is a plain frozen dataclass describing one complete
chaos run — the machine (topology factory), the pool (small/huge/tiered),
the workload (bulk drain, serving-style leap stream, exchange, writer mix,
or a full open-loop serving workload driving a real PagedEngine through
``repro_torch.load``), the scheduler policy, and a schedule of timed
:class:`FaultEvent`\\ s.  It
round-trips exactly through dicts and JSON, which is what makes failures
*replayable*: a failing spec serializes to a repro file and
``python -m repro_torch.chaos --replay <spec.json>`` re-runs it deterministically
(everything random derives from ``seed``).

Event taxonomy (DESIGN.md §9):

  drain_region      region loss mid-epoch: ``fault.drain_region`` fires
                    while copy epochs are open.  args: ``region``,
                    optional ``scheduler`` ("sync" escalates).
  congest_link      contention spike: the live topology is swapped for
                    ``topology.congested(src, dst, factor)``.
  degrade_link      persistent link change via ``topology.with_link``.
                    args: ``src``, ``dst``, optional ``distance`` /
                    ``bandwidth``.
  restore_topology  swap the construction-time topology back in.
  cancel_storm      cancel a random fraction of live handles.  args:
                    ``frac`` in (0, 1].
  write_burst       writer interference at randomized blocks, on top of
                    the workload's steady ``writes_per_tick``.  args:
                    ``blocks``.
  out_of_slots      allocation pressure: leap a random set of blocks into
                    the currently fullest region (exercises the
                    out-of-slots halving/blocked paths).

An event with ``tick == -1`` is assigned a concrete tick from the spec's
seed at build time, so "random" schedules replay identically.
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.topology import NumaTopology

EVENT_KINDS = (
    "drain_region",
    "congest_link",
    "degrade_link",
    "restore_topology",
    "cancel_storm",
    "write_burst",
    "out_of_slots",
)

WORKLOADS = ("drain", "stream", "exchange", "serving", "working_set_shift")
SCHEDULERS = ("leap", "sync", "sampling", "slo")
DISPATCH_MODES = ("legacy", "batched", "megastep")

#: Fault kinds a "serving" workload admits.  The others (write_burst,
#: out_of_slots) address raw pool block ids directly — under serving the
#: engine owns the block space, so raw writes would corrupt live KV pages
#: by design rather than by bug.
SERVING_EVENT_KINDS = (
    "drain_region",
    "congest_link",
    "degrade_link",
    "restore_topology",
    "cancel_storm",
)
PLACEMENTS = ("dense", "spread", "random")
TOPOLOGIES = (None, "symmetric", "two_socket", "quad_socket", "cxl_pooled")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One timed fault: ``kind`` at ``tick`` (-1 = seeded-random tick)."""

    kind: str
    tick: int = -1
    args: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "tick": int(self.tick), "args": dict(self.args)}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(kind=d["kind"], tick=int(d.get("tick", -1)), args=dict(d.get("args", {})))


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One declarative chaos scenario (see module docstring)."""

    seed: int = 0
    ticks: int = 40  # driven ticks before the final drain

    # -- pool ---------------------------------------------------------------
    n_regions: int = 2
    slots_per_region: int = 16
    n_blocks: int = 8  # <= slots_per_region so any single request terminates
    block_elems: int = 4
    huge_factor: int = 1
    adopt_huge: bool = False  # adopt aligned groups at t=0 (needs dense placement)
    placement: str = "dense"

    # -- topology -----------------------------------------------------------
    topology: str | None = None
    topology_args: tuple = ()  # e.g. (n_local, n_far) for cxl_pooled

    # -- engine -------------------------------------------------------------
    scheduler: str = "leap"
    dispatch: str = "megastep"  # dispatch generation (LeapConfig.fused_dispatch)
    initial_area_blocks: int = 4
    chunk_blocks: int = 2
    budget_blocks_per_tick: int = 4
    max_attempts_before_force: int = 3
    demote_after_attempts: int = 2
    # Closed-loop tiering (DESIGN.md §13): enables the heat plane + an
    # epoch-driven TieringPolicy when the topology has a far tier.  Under
    # the "working_set_shift" workload the policy is the ONLY source of
    # migrations, which arms the tiering_hysteresis standing invariant.
    tiering: bool = False
    tier_epoch: int = 4  # TieringPolicy epoch cadence (ticks)

    # -- workload -----------------------------------------------------------
    workload: str = "drain"
    leap_every: int = 3  # stream: a new request every k ticks
    blocks_per_leap: int = 4
    max_priority: int = 3
    writes_per_tick: int = 0  # steady writer mix (blocks touched per tick)

    # -- working-set-shift workload (workload == "working_set_shift") --------
    # Zipf-free hot-set reads feeding the heat plane: ``reads_per_tick``
    # uniform draws from a hot set of ``hot_frac * n_blocks`` blocks that
    # rotates every ``shift_every`` ticks (each rotation is a *phase shift*
    # for the hysteresis invariant).  No explicit leaps are issued — all
    # migration comes from the tiering policy (when ``tiering`` is on).
    shift_every: int = 12
    hot_frac: float = 0.25
    reads_per_tick: int = 8

    # -- serving workload (workload == "serving") ----------------------------
    # The open-loop multi-tenant load generator (repro_torch.load) drives a real
    # PagedEngine inside the chaos loop; the engine builds its own pool from
    # n_regions/slots_per_region/huge_factor/topology/scheduler, so
    # n_blocks/block_elems/placement are ignored in this mode.
    serving_rate: float = 0.4  # interactive tenant arrivals/tick (batch: half)
    serving_prompt_tokens: int = 6
    serving_decode_tokens: int = 8
    serving_churn_every: int = 2  # background rebalance cadence (0 = none)
    serving_slo_latency: float = 2.5  # interactive per-token SLO, modeled units

    # -- faults + checker cadence -------------------------------------------
    faults: tuple = ()  # tuple[FaultEvent, ...]
    payload_every: int = 1  # payload integrity check every k ticks

    # -- validation ---------------------------------------------------------

    def validate(self) -> None:
        if self.n_regions < 2:
            raise ValueError("need at least 2 regions to migrate between")
        if not 1 <= self.n_blocks <= self.slots_per_region:
            # n_blocks <= slots_per_region guarantees every request can
            # terminate: any single destination region can hold all blocks.
            raise ValueError(
                f"n_blocks must be in [1, slots_per_region={self.slots_per_region}]"
            )
        if self.huge_factor < 1 or (self.huge_factor & (self.huge_factor - 1)):
            raise ValueError("huge_factor must be a power of two")
        if self.huge_factor > 1 and self.slots_per_region % self.huge_factor:
            raise ValueError("huge_factor must divide slots_per_region")
        if self.adopt_huge and (self.huge_factor < 2 or self.placement != "dense"):
            raise ValueError("adopt_huge needs huge_factor > 1 and dense placement")
        if self.workload not in WORKLOADS:
            raise ValueError(f"workload must be one of {WORKLOADS}")
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"scheduler must be one of {SCHEDULERS}")
        if self.dispatch not in DISPATCH_MODES:
            raise ValueError(f"dispatch must be one of {DISPATCH_MODES}")
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}")
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"topology must be one of {TOPOLOGIES}")
        if self.topology == "two_socket" and self.n_regions != 2:
            raise ValueError("two_socket topology needs n_regions == 2")
        if self.topology == "quad_socket" and self.n_regions != 4:
            raise ValueError("quad_socket topology needs n_regions == 4")
        if self.topology == "cxl_pooled" and sum(self.topology_args) != self.n_regions:
            raise ValueError("cxl_pooled topology_args must sum to n_regions")
        if self.ticks < 1 or self.payload_every < 1 or self.leap_every < 1:
            raise ValueError("ticks, payload_every and leap_every must be >= 1")
        if self.shift_every < 1 or self.tier_epoch < 1 or self.reads_per_tick < 1:
            raise ValueError("shift_every, tier_epoch and reads_per_tick must be >= 1")
        if not 0.0 < self.hot_frac <= 1.0:
            raise ValueError("hot_frac must be in (0, 1]")
        if self.workload == "serving":
            if self.serving_rate < 0:
                raise ValueError("serving_rate must be >= 0")
            if self.serving_prompt_tokens < 1 or self.serving_decode_tokens < 1:
                raise ValueError("serving prompt/decode tokens must be >= 1")
            if self.serving_churn_every < 0:
                raise ValueError("serving_churn_every must be >= 0")
            if self.serving_slo_latency <= 0:
                raise ValueError("serving_slo_latency must be > 0")
        for ev in self.faults:
            self._validate_event(ev)

    def _validate_event(self, ev: FaultEvent) -> None:
        if ev.kind not in EVENT_KINDS:
            raise ValueError(f"unknown fault kind {ev.kind!r}")
        if self.workload == "serving" and ev.kind not in SERVING_EVENT_KINDS:
            raise ValueError(
                f"fault {ev.kind!r} addresses raw pool blocks; the serving "
                f"workload admits only {SERVING_EVENT_KINDS}"
            )
        if ev.tick >= self.ticks:
            raise ValueError(f"fault tick {ev.tick} past scenario end {self.ticks}")
        a = ev.args
        if ev.kind == "drain_region" and not 0 <= a.get("region", 0) < self.n_regions:
            raise ValueError(f"drain_region region out of range: {a}")
        if ev.kind in ("congest_link", "degrade_link", "restore_topology"):
            if self.topology is None:
                raise ValueError(f"{ev.kind} needs a topology attached")
        if ev.kind in ("congest_link", "degrade_link"):
            src, dst = a.get("src", 0), a.get("dst", 1)
            if not (0 <= src < self.n_regions and 0 <= dst < self.n_regions) or src == dst:
                raise ValueError(f"{ev.kind} link out of range: {a}")
        if ev.kind == "congest_link" and a.get("factor", 2.0) < 1:
            raise ValueError("congestion factor must be >= 1")
        if ev.kind == "cancel_storm" and not 0 < a.get("frac", 1.0) <= 1:
            raise ValueError("cancel_storm frac must be in (0, 1]")

    # -- factories -----------------------------------------------------------

    def make_topology(self) -> NumaTopology | None:
        if self.topology is None:
            return None
        if self.topology == "symmetric":
            return NumaTopology.symmetric(self.n_regions)
        if self.topology == "two_socket":
            return NumaTopology.two_socket()
        if self.topology == "quad_socket":
            return NumaTopology.quad_socket()
        if self.topology == "cxl_pooled":
            return NumaTopology.cxl_pooled(*self.topology_args)
        raise ValueError(f"unknown topology {self.topology!r}")

    # -- dict / JSON round-trip ----------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["faults"] = [ev.to_dict() for ev in self.faults]
        d["topology_args"] = list(self.topology_args)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        d = dict(d)
        d["faults"] = tuple(FaultEvent.from_dict(ev) for ev in d.get("faults", ()))
        d["topology_args"] = tuple(d.get("topology_args", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ScenarioSpec fields: {sorted(unknown)}")
        return cls(**d)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(text))
