"""Chaos driver: run one :class:`ScenarioSpec` through the real pipeline.

The driver builds a live pool + :class:`LeapSession` exactly as an
application would, then ticks the scenario: each tick it steps the
workload (drain / serving-style leap stream / exchange, plus the steady
writer mix), fires any fault events scheduled for that tick, and runs the
:class:`InvariantChecker` after *every* event and *every* tick.  All
randomness derives from ``spec.seed``, so a run — including events whose
tick was seeded-random — replays deterministically from the serialized
spec alone.

``run_with_repro`` is the harness entry point: on an invariant violation
it serializes the offending spec to ``<repro_dir>/last_failure.json`` (and
a per-seed file) and re-raises, so generative exploration (Hypothesis) or
a CI sweep leaves behind a replayable minimized repro:

    python -m repro_torch.chaos --replay <spec.json>

``apply_sabotage`` deliberately re-introduces known-fixed bugs (e.g. the
pre-quarantine same-tick slot reuse) to prove the checker actually catches
them — the harness's own regression test.

The pool, the model of the ``serving`` workload and the payload shadow live
on ``device`` (the current CUDA device by default).  On the card verdicts
arrive asynchronously, so the driver harvests them (``poll(block=True)``)
before every invariant check: a commit whose verdict is still on its way
has flipped the device table but not yet the host mirror, and the mirror
check would report that as a violation.  Copy epochs stay open across
ticks, so writes still land in them and trip ``dirty |= in_flight``; only
the harvest lag is taken out of the check.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os

import numpy as np
import torch

from repro_torch.chaos.invariants import HysteresisMonitor, InvariantChecker, InvariantViolation
from repro_torch.chaos.sabotage import apply_sabotage
from repro_torch.chaos.spec import ScenarioSpec
from repro_torch.core import LeapConfig, MigrationDriver, PoolConfig, init_state, leap_write
from repro_torch.core.state import _default_device
from repro_torch.distributed import fault

DRAIN_TARGET_PRIORITY = 1  # bulk-drain workload priority (above stream's 0)


@functools.lru_cache(maxsize=None)
def _tiny_model(device: torch.device):
    """One shared tiny LM per device for every serving scenario in the
    process — the model is workload scaffolding, not the thing under test,
    and per-spec weights would pay an init per scenario."""
    from repro_torch.configs.base import get_config
    from repro_torch.configs.smoke import reduce
    from repro_torch.models import lm

    cfg = dataclasses.replace(reduce(get_config("granite_3_2b")), n_layers=2)
    return cfg, lm.init_params(torch.Generator(device).manual_seed(0), cfg, device)


@dataclasses.dataclass
class ChaosReport:
    """Outcome of one scenario run (the run raises on invariant violations)."""

    spec: ScenarioSpec
    completed: bool  # final drain emptied the pipeline within the tick cap
    ticks_run: int
    checks_run: int
    events_fired: list[str]
    drain_refusals: int  # drain_region raised "not enough surviving capacity"
    handles_issued: int
    blocks_requested: int
    blocks_migrated: int
    blocks_forced: int
    blocks_cancelled: int


class ChaosDriver:
    """Builds and runs one scenario; see the module docstring."""

    def __init__(self, spec: ScenarioSpec, sabotage: str | None = None, device=None):
        spec.validate()
        self.spec = spec
        self.device = _default_device(device)
        self.rng = np.random.default_rng(spec.seed)
        # Resolve seeded-random event ticks first (fixed draw order), so the
        # schedule is a pure function of the spec.
        self.schedule: list[tuple[int, object]] = []
        for ev in spec.faults:
            tick = ev.tick if ev.tick >= 0 else int(self.rng.integers(0, spec.ticks))
            self.schedule.append((tick, ev))

        topo = spec.make_topology()
        self.base_topology = topo
        self.engine = None  # PagedEngine, serving workload only
        self.generator = None  # LoadGenerator, serving workload only
        self.handles: list = []
        self.events_fired: list[str] = []
        self.drain_refusals = 0
        if spec.workload == "serving":
            self._build_serving(topo)
            if sabotage is not None:
                apply_sabotage(self.driver, sabotage)
            return
        pool_cfg = PoolConfig(
            spec.n_regions,
            spec.slots_per_region,
            (spec.block_elems,),
            huge_factor=spec.huge_factor,
            topology=topo,
        )
        placement = self._placement()
        state = init_state(pool_cfg, spec.n_blocks, placement, self.device)
        data = torch.from_numpy(
            self.rng.normal(size=(spec.n_blocks, spec.block_elems)).astype(np.float32)
        ).to(self.device)
        state = leap_write(state, np.arange(spec.n_blocks), data)
        cfg = LeapConfig(
            initial_area_blocks=spec.initial_area_blocks,
            chunk_blocks=spec.chunk_blocks,
            budget_blocks_per_tick=spec.budget_blocks_per_tick,
            max_attempts_before_force=spec.max_attempts_before_force,
            demote_after_attempts=spec.demote_after_attempts,
            fused_dispatch=spec.dispatch,
            tiering=spec.tiering,
            # Always record under chaos: a failing run dumps its trace next
            # to the repro spec, and the drift property test replays the
            # event log against MigrationStats.
            telemetry=True,
        )
        self.driver = MigrationDriver(state, pool_cfg, cfg, scheduler=spec.scheduler)
        if spec.adopt_huge:
            self.driver.adopt_huge(np.arange(spec.n_blocks // spec.huge_factor))
        self.session = self.driver.default_session()
        self.shadow = data.clone()  # the ground truth, on the pool's device
        self.checker = InvariantChecker(self.driver, self.shadow)
        self._attach_tiering()
        if sabotage is not None:
            apply_sabotage(self.driver, sabotage)

    def _build_serving(self, topo) -> None:
        """Serving workload: a real PagedEngine + open-loop LoadGenerator.

        The engine owns the pool (built from the spec's region/slot/tier/
        scheduler fields; ``n_blocks``/``block_elems``/``placement`` are
        raw-pool knobs and don't apply), so there is no host shadow — the
        payload invariant's stand-in is the per-tenant page-closure check
        (:meth:`_check_serving`) layered on the structural invariants.
        """
        from repro_torch.load import LoadGenerator, TenantSpec, WorkloadSpec
        from repro_torch.serving.engine import PagedConfig, PagedEngine

        spec = self.spec
        cfg_m, model = _tiny_model(self.device)
        leap = LeapConfig(
            initial_area_blocks=spec.initial_area_blocks,
            chunk_blocks=spec.chunk_blocks,
            budget_blocks_per_tick=spec.budget_blocks_per_tick,
            max_attempts_before_force=spec.max_attempts_before_force,
            demote_after_attempts=spec.demote_after_attempts,
            fused_dispatch=spec.dispatch,
            tiering=spec.tiering,
            telemetry=True,
        )
        self.engine = PagedEngine(
            cfg_m, model,
            PagedConfig(block_tokens=4, max_blocks_per_seq=16,
                        n_regions=spec.n_regions,
                        slots_per_region=spec.slots_per_region,
                        huge_factor=spec.huge_factor,
                        leap=leap, topology=topo, scheduler=spec.scheduler),
            device=self.device,
        )
        self.driver = self.engine.driver
        self.session = self.engine.session
        self.shadow = None
        self.checker = InvariantChecker(self.driver, None)
        wl = WorkloadSpec(
            tenants=(
                TenantSpec("interactive", rate=spec.serving_rate,
                           prompt_tokens=spec.serving_prompt_tokens,
                           decode_tokens=spec.serving_decode_tokens,
                           slo_latency=spec.serving_slo_latency,
                           priority=1, region=0),
                TenantSpec("batch", rate=spec.serving_rate / 2,
                           prompt_tokens=spec.serving_prompt_tokens + 2,
                           decode_tokens=spec.serving_decode_tokens + 4,
                           slo_latency=spec.serving_slo_latency * 4,
                           priority=0, region=spec.n_regions - 1),
            ),
            ticks=spec.ticks,
            seed=spec.seed,
            churn_every=spec.serving_churn_every,
            churn_count=1,
        )
        self.generator = LoadGenerator(
            self.engine, wl, scheduler=self.driver.scheduler
        )
        self._attach_tiering()

    def _attach_tiering(self) -> None:
        """Build the TieringPolicy (+ hysteresis monitor where it's armed).

        The policy needs a topology to tier against; on a uniform mesh
        ``split_tiers`` finds no far tier and ``decide`` no-ops, so the flag
        still exercises the heat plane + megastep heat phase.  The
        ``tiering_hysteresis`` monitor is armed only under the
        ``working_set_shift`` workload, where the policy is the sole source
        of migrations — elsewhere workload-driven leaps would trip it by
        design, not by bug.
        """
        spec = self.spec
        self.tiering_policy = None
        self.hysteresis = None
        if not spec.tiering or self.driver.topology is None:
            return
        from repro_torch.tiering import TieringConfig, TieringPolicy

        cooldown = 12
        self.tiering_policy = TieringPolicy(
            self.driver,
            TieringConfig(
                hot_watermark=1.0,
                cold_watermark=0.3,
                cooldown_ticks=cooldown,
                epoch_ticks=spec.tier_epoch,
                max_promotions=8,
                max_demotions=4,
            ),
        )
        if spec.workload == "working_set_shift":
            window = 32
            self.hysteresis = HysteresisMonitor(
                self.driver.host_placement(),
                window=window,
                # policy bound under the cooldown, plus one in-flight fault
                # landing after a phase-shift reset
                max_moves=(window - 1) // cooldown + 2,
            )

    def _check_serving(self) -> None:
        """Per-tenant accounting closure, surfaced as a standing invariant."""
        if self.generator is None:
            return
        try:
            self.generator.verify_accounting()
        except AssertionError as e:
            if isinstance(e, InvariantViolation):
                raise
            raise InvariantViolation("tenant_accounting", str(e)) from e

    def _placement(self) -> np.ndarray:
        spec = self.spec
        if spec.placement == "dense":
            return np.zeros(spec.n_blocks, np.int32)
        if spec.placement == "spread":
            return (np.arange(spec.n_blocks) % spec.n_regions).astype(np.int32)
        return self.rng.integers(0, spec.n_regions, size=spec.n_blocks).astype(np.int32)

    # -- workload ------------------------------------------------------------

    def _leap(self, ids, dst: int, priority: int = 0) -> None:
        h = self.session.leap(np.asarray(ids, np.int32), int(dst), priority=priority)
        self.handles.append(h)

    def _shift_reads(self, t: int) -> np.ndarray:
        """working_set_shift: uniform reads over the tick's rotated hot set."""
        spec = self.spec
        n = spec.n_blocks
        hot_n = max(1, int(round(spec.hot_frac * n)))
        start = ((t // spec.shift_every) * hot_n) % n
        hot = (start + np.arange(hot_n)) % n
        return hot[self.rng.integers(0, hot_n, size=spec.reads_per_tick)].astype(np.int32)

    def _step_workload(self, t: int) -> None:
        spec = self.spec
        if spec.workload == "serving":
            # The generator's step admits, decodes, churns AND runs the
            # engine's migration tick — run() must not tick again.
            self.generator.step()
            self._tiering_epoch()
            return
        if spec.workload == "working_set_shift":
            if t and t % spec.shift_every == 0 and self.hysteresis is not None:
                self.hysteresis.phase_shift()  # rotation legitimately re-tiers
            # reads only feed the heat plane (no-op with tiering off); the
            # tiering policy is this workload's only source of migrations
            self.driver.note_reads(self._shift_reads(t))
        elif spec.workload == "drain" and t == 0:
            self._leap(np.arange(spec.n_blocks), spec.n_regions - 1,
                       priority=DRAIN_TARGET_PRIORITY)
        elif spec.workload == "exchange" and t == 0:
            # Every region's blocks head to the next region over — the
            # bidirectional pattern that motivated the slot quarantine.
            placement = self.driver.host_placement()
            for r in range(spec.n_regions):
                mine = np.nonzero(placement == r)[0]
                if len(mine):
                    self._leap(mine, (r + 1) % spec.n_regions)
        elif spec.workload == "stream" and t % spec.leap_every == 0:
            k = min(spec.blocks_per_leap, spec.n_blocks)
            ids = self.rng.choice(spec.n_blocks, size=k, replace=False)
            self._leap(
                ids,
                int(self.rng.integers(0, spec.n_regions)),
                priority=int(self.rng.integers(0, spec.max_priority + 1)),
            )
        if spec.writes_per_tick:
            self._write_random(spec.writes_per_tick)
        self._tiering_epoch()

    def _tiering_epoch(self) -> None:
        if self.tiering_policy is not None:
            self.handles.extend(self.tiering_policy.maybe_apply(self.session))

    def _write_random(self, k: int) -> None:
        spec = self.spec
        k = min(k, spec.n_blocks)
        ids = self.rng.choice(spec.n_blocks, size=k, replace=False)
        vals = torch.from_numpy(
            self.rng.normal(size=(k, spec.block_elems)).astype(np.float32)
        ).to(self.device)
        self.driver.write(ids, vals)
        self.shadow[torch.from_numpy(ids).to(self.device)] = vals

    # -- fault events --------------------------------------------------------

    def _fire(self, ev) -> None:
        a = ev.args
        if ev.kind == "drain_region":
            try:
                fault.drain_region(
                    self.driver, int(a.get("region", 0)), scheduler=a.get("scheduler")
                )
            except RuntimeError:
                # A legitimate refusal (not enough surviving capacity right
                # now, e.g. everything reserved mid-flight) — recorded, not
                # an invariant violation.
                self.drain_refusals += 1
        elif ev.kind == "congest_link":
            self.driver.set_topology(
                self.driver.topology.congested(
                    int(a.get("src", 0)), int(a.get("dst", 1)),
                    float(a.get("factor", 2.0)),
                )
            )
        elif ev.kind == "degrade_link":
            kw = {}
            if "distance" in a:
                kw["distance"] = int(a["distance"])
            if "bandwidth" in a:
                kw["bandwidth"] = float(a["bandwidth"])
            self.driver.set_topology(
                self.driver.topology.with_link(int(a.get("src", 0)), int(a.get("dst", 1)), **kw)
            )
        elif ev.kind == "restore_topology":
            self.driver.set_topology(self.base_topology)
        elif ev.kind == "cancel_storm":
            pool = (
                self.handles
                if self.generator is None
                else self.engine.rebalance_handles()
            )
            live = [h for h in pool if not h.done]
            frac = float(a.get("frac", 1.0))
            k = max(1, int(round(frac * len(live)))) if live else 0
            for i in self.rng.choice(len(live), size=k, replace=False) if k else ():
                live[int(i)].cancel()
        elif ev.kind == "write_burst":
            self._write_random(int(a.get("blocks", 4)))
        elif ev.kind == "out_of_slots":
            free = [self.driver.free_slots(r) for r in range(self.spec.n_regions)]
            fullest = int(np.argmin(free))
            k = min(self.spec.n_blocks, max(1, free[fullest] + 2))
            ids = self.rng.choice(self.spec.n_blocks, size=k, replace=False)
            self._leap(ids, fullest)
        else:  # pragma: no cover - validate() rejects unknown kinds
            raise ValueError(f"unknown fault kind {ev.kind!r}")
        if self.hysteresis is not None:
            self.hysteresis.phase_shift()  # faults legitimately re-tier blocks
        self.events_fired.append(f"t{self.driver.stats.ticks}:{ev.kind}")

    # -- the run -------------------------------------------------------------

    def run(self, drain_ticks: int = 5000) -> ChaosReport:
        spec = self.spec
        for t in range(spec.ticks):
            self._step_workload(t)
            for when, ev in self.schedule:
                if when == t:
                    self._fire(ev)
                    # harvest first: under serving the generator has ticked
                    # and its commit may still be on its way (module docstring)
                    self.session.poll(block=True)
                    self.checker.check_all(payload=False)  # after every event
            if self.generator is None:
                self.session.tick()  # serving: the generator already ticked
            self.session.poll(block=True)
            if self.hysteresis is not None:
                self.hysteresis.observe(t, self.driver.host_placement())
            self.checker.check_all(payload=(t % spec.payload_every == 0))
            self._check_serving()
        completed = self.session.drain(max_ticks=drain_ticks)
        if completed:
            self.checker.check_final()
        else:
            self.checker.check_all()
        self._check_serving()
        s = self.driver.stats
        return ChaosReport(
            spec=spec,
            completed=completed,
            ticks_run=int(s.ticks),
            checks_run=self.checker.checks_run,
            events_fired=self.events_fired,
            drain_refusals=self.drain_refusals,
            handles_issued=(
                len(self.handles)
                if self.generator is None
                else len(self.engine.rebalance_handles())
            ),
            blocks_requested=int(s.blocks_requested),
            blocks_migrated=int(s.blocks_migrated),
            blocks_forced=int(s.blocks_forced),
            blocks_cancelled=int(s.blocks_cancelled),
        )


def run_scenario(spec: ScenarioSpec, sabotage: str | None = None, device=None) -> ChaosReport:
    """Build and run one scenario on ``device`` (the current CUDA device by
    default); raises InvariantViolation on a breach."""
    return ChaosDriver(spec, sabotage=sabotage, device=device).run()


def run_with_repro(
    spec: ScenarioSpec, repro_dir: str, sabotage: str | None = None, device=None
) -> ChaosReport:
    """Like :func:`run_scenario`, but a violation first serializes the spec.

    Three files are written: a content-addressed ``chaos-<digest>.json``,
    ``last_failure.json`` (overwritten per failure — under Hypothesis
    shrinking, the last failing run is the minimized example, so this file
    always holds the smallest repro found), and — since every chaos driver
    runs with telemetry on — ``chaos-<digest>-trace.json``, the Perfetto
    timeline of the failing run up to the violation.
    """
    chaos = ChaosDriver(spec, sabotage=sabotage, device=device)
    try:
        return chaos.run()
    except InvariantViolation as e:
        os.makedirs(repro_dir, exist_ok=True)
        text = spec.to_json()
        digest = hashlib.sha256(text.encode()).hexdigest()[:12]
        path = os.path.join(repro_dir, f"chaos-{digest}.json")
        for p in (path, os.path.join(repro_dir, "last_failure.json")):
            with open(p, "w") as f:
                f.write(text + "\n")
        trace_path = os.path.join(repro_dir, f"chaos-{digest}-trace.json")
        try:
            chaos.session.telemetry().write_trace(trace_path, label=f"chaos-{digest}")
        except Exception:  # the spec file is the repro; a trace is best-effort
            trace_path = "(trace export failed)"
        detail = str(e).removeprefix(f"[{e.invariant}] ")
        on = " --device cpu" if chaos.device.type == "cpu" else ""
        raise InvariantViolation(
            e.invariant,
            f"{detail} | spec serialized to {path} (trace: {trace_path}); "
            f"replay with: python -m repro_torch.chaos --replay {path}{on}",
        ) from e
