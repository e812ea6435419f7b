"""The `SchedulerPolicy` seam: pluggable migration strategies over one engine.

The pipeline's mechanism (decompose → route → budget → dispatch → verdict →
account) is policy-free; what *varies* between the paper's methods is how
requests are admitted and how aggressively a tick spends budget.  A
:class:`SchedulerPolicy` captures exactly that seam:

* :meth:`admission_ticket` — how admission stamps the areas of a request
  (escalate straight to the race-free force program? zero-fill the
  destination first, like a fresh mmap? skip busy blocks instead of
  retrying them?).
* :meth:`tick_budget` — how many blocks one ``tick()`` may move.

Three built-in policies reproduce the paper's contenders as configurations
of the SAME engine (no separate migration loops anywhere):

``LeapScheduler``      the paper's page_leap(): asynchronous copy epochs,
                       dirty verdicts, adaptive splitting, paced budget.
``SyncScheduler``      the move_pages() analogue: skip busy blocks (EBUSY,
                       no retry), zero-fill fresh destinations, escalate to
                       the atomic force program, unbounded per-tick budget
                       (the caller blocks until done).
``SamplingScheduler``  the autonuma analogue: access-sampling counters pick
                       hot remote blocks; migration itself is unconditional
                       (force + fresh destination) and paced by the scan
                       budget — the kernel heuristic with the shared
                       mechanism underneath.
``SloScheduler``       the serving configuration: reliable leap epochs whose
                       per-tick (and per-link) budget is throttled by the
                       worst observed SLO slack across tenants — migration
                       yields bandwidth to decode traffic exactly when p99
                       latency approaches a tenant's target, and recovers
                       the full budget when slack returns.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.config import LeapConfig

_UNBOUNDED = 1 << 30  # "whole request this tick" (sync policies)


@dataclasses.dataclass(frozen=True)
class AdmissionTicket:
    """How admission treats one request's areas (the policy's stamp).

    escalate:    stamp ``Area.attempts`` so dispatch takes the atomic
                 force path immediately (no copy epoch, no race window).
    fresh_alloc: zero-fill reserved destination slots before the copy/force
                 lands (the fresh-``mmap``/page-fault cost).
    skip_busy:   drop blocks that are dirty/in-flight on the device instead
                 of enqueueing them (move_pages()-style EBUSY, no retry).
    """

    escalate: bool = False
    fresh_alloc: bool = False
    skip_busy: bool = False


@runtime_checkable
class SchedulerPolicy(Protocol):
    """Strategy seam at admission and budget (see module docstring)."""

    name: str

    def admission_ticket(self) -> AdmissionTicket:
        """Default stamp for requests submitted without an explicit ticket."""
        ...

    def tick_budget(self, cfg: LeapConfig) -> int:
        """Blocks one ``tick()`` may copy (the pacing half of the policy)."""
        ...


class LeapScheduler:
    """The paper's page_leap(): reliable async epochs at the paced budget."""

    name = "leap"

    def admission_ticket(self) -> AdmissionTicket:
        return AdmissionTicket()

    def tick_budget(self, cfg: LeapConfig) -> int:
        return cfg.budget_blocks_per_tick


class SyncScheduler:
    """move_pages()-style configuration: synchronous, fresh, unreliable.

    Busy blocks are skipped at admission (reported as failed, no retry);
    everything else migrates through the shared dispatch stage's force
    program into zero-filled destinations, and the whole request is budgeted
    into a single tick so a driving caller returns after one drain.
    """

    name = "sync"

    def __init__(self, fresh_alloc: bool = True, skip_busy: bool = True):
        self.fresh_alloc = fresh_alloc
        self.skip_busy = skip_busy

    def admission_ticket(self) -> AdmissionTicket:
        return AdmissionTicket(
            escalate=True, fresh_alloc=self.fresh_alloc, skip_busy=self.skip_busy
        )

    def tick_budget(self, cfg: LeapConfig) -> int:
        return _UNBOUNDED


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Knobs of the autonuma-style sampling heuristic."""

    scan_budget_blocks: int = 32  # blocks migrated per scan, max
    hot_threshold: int = 4  # remote accesses (since decay) to qualify
    pressure_threshold: float = 0.05  # writes/block/tick above which it defers
    decay: float = 0.5  # counter decay per scan


class SamplingScheduler:
    """Autonuma-style configuration: sampled triggers, unconditional moves.

    Owns the access counters (the "NUMA hinting fault" sample stream) and
    the defer-under-write-pressure gate; :meth:`select_hot` is the heuristic
    half consumed by :class:`repro.core.baselines.AutoBalancer`, while the
    SchedulerPolicy half stamps the resulting requests to migrate like the
    kernel does — atomically forced into fresh zero-filled destinations —
    through the same dispatch/verdict stages as everything else.
    """

    name = "sampling"

    def __init__(self, n_blocks: int, cfg: SamplingConfig | None = None):
        self.cfg = cfg or SamplingConfig()
        self.remote_counts = np.zeros(n_blocks, dtype=np.float64)
        self.preferred_region = np.full(n_blocks, -1, dtype=np.int32)
        self.recent_writes = 0.0

    # -- SchedulerPolicy ---------------------------------------------------

    def admission_ticket(self) -> AdmissionTicket:
        return AdmissionTicket(escalate=True, fresh_alloc=True)

    def tick_budget(self, cfg: LeapConfig) -> int:
        # One scan's worth of blocks per tick: the kernel's bounded batch.
        return max(self.cfg.scan_budget_blocks, 1)

    # -- the sampling heuristic -------------------------------------------

    def observe_reads(self, block_ids, reader_region: int, regions) -> None:
        """Record accesses: ``regions[i]`` is where ``block_ids[i]`` lives."""
        block_ids = np.asarray(block_ids)
        remote = np.asarray(regions) != reader_region
        np.add.at(self.remote_counts, block_ids[remote], 1.0)
        self.preferred_region[block_ids[remote]] = reader_region

    def observe_writes(self, n_writes: int) -> None:
        self.recent_writes += n_writes

    def select_hot(self) -> np.ndarray:
        """One scan: hot remote blocks to move now (empty under pressure).

        Applies the pressure gate ("waits for times of little load"), the
        hot threshold, the per-scan budget, and the counter decay — exactly
        the kernel heuristic; callers turn the ids into moves/requests.
        Counters survive a deferred scan so the hint outlives the burst.
        """
        n_blocks = len(self.remote_counts)
        pressure = self.recent_writes / max(n_blocks, 1)
        self.recent_writes = 0.0
        if pressure > self.cfg.pressure_threshold:
            return np.zeros(0, dtype=np.int64)
        hot = np.nonzero(self.remote_counts >= self.cfg.hot_threshold)[0]
        if len(hot) == 0:
            self.remote_counts *= self.cfg.decay
            return hot
        hot = hot[np.argsort(-self.remote_counts[hot])][: self.cfg.scan_budget_blocks]
        return hot

    def settle(self, moved_ids) -> None:
        """Clear counters of blocks a scan migrated, then decay the rest."""
        if len(moved_ids):
            self.remote_counts[np.asarray(moved_ids)] = 0.0
        self.remote_counts *= self.cfg.decay


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Knobs of the deadline-driven pacing heuristic.

    Slack is the normalized headroom of a tenant's p99 token latency under
    its SLO target: ``(slo - p99) / slo`` — 1.0 with no load, 0.0 exactly at
    the target, negative in violation.  The scheduler throttles on the
    *minimum* slack over all registered tenants (the tenant closest to its
    deadline governs the pace).
    """

    window: int = 64  # recent token latencies kept per tenant (p99 basis)
    low_slack: float = 0.10  # at/below: migration throttled to min_blocks
    high_slack: float = 0.50  # at/above: the full configured budget
    min_blocks: int = 1  # forward-progress floor (never a full stall)
    quantile: float = 0.99  # the latency quantile slack is computed from


class SloScheduler:
    """Deadline-driven serving policy: leap epochs, slack-paced budget.

    The serving layer registers each tenant's latency target
    (:meth:`register_tenant`) and streams observed per-token latencies in
    (:meth:`observe_tokens`) — from the load generator's modeled clock, or
    from ``PagedEngine`` telemetry spans.  Between the two watermarks the
    per-tick block budget interpolates linearly from the forward-progress
    floor up to ``cfg.budget_blocks_per_tick``; the same factor scales the
    per-link byte budgets via the :meth:`link_unit` hook, so decode traffic
    reclaims link bandwidth precisely when p99 slack shrinks.  With no
    tenants registered (or no observations yet) the policy is exactly the
    LeapScheduler — full paced budget, reliable async epochs.
    """

    name = "slo"

    def __init__(self, cfg: SloConfig | None = None):
        self.cfg = cfg or SloConfig()
        self._slo: dict = {}  # tenant -> target token latency
        self._window: dict = {}  # tenant -> deque of recent latencies
        self._priority: dict = {}  # tenant -> serving priority (tie-break)

    # -- SchedulerPolicy ---------------------------------------------------

    def admission_ticket(self) -> AdmissionTicket:
        return AdmissionTicket()  # reliable async epochs, like the paper

    def tick_budget(self, cfg: LeapConfig) -> int:
        full = cfg.budget_blocks_per_tick
        return max(self.cfg.min_blocks, int(round(full * self.pacing_factor())))

    def link_unit(self, cfg: LeapConfig, unit: int) -> int:
        """Scale the per-link byte budget by the same pacing factor (budget
        stage hook): a saturated tenant shrinks every link's grant, not just
        the global block count."""
        return max(self.cfg.min_blocks, int(round(unit * self.pacing_factor())))

    # -- slack bookkeeping -------------------------------------------------

    def register_tenant(self, tenant, slo_latency: float, priority: int = 0) -> None:
        """Declare a tenant's per-token latency target (model time units)."""
        if slo_latency <= 0:
            raise ValueError("slo_latency must be positive")
        self._slo[tenant] = float(slo_latency)
        self._priority[tenant] = int(priority)
        self._window.setdefault(
            tenant, collections.deque(maxlen=self.cfg.window)
        )

    def observe_tokens(self, tenant, latencies) -> None:
        """Record observed per-token latencies for ``tenant`` (same time
        units as its registered SLO).  Unknown tenants are ignored — the
        caller may stream latencies for tenants it never gave targets."""
        win = self._window.get(tenant)
        if win is None:
            return
        win.extend(float(v) for v in np.atleast_1d(latencies))

    def slack(self, tenant) -> float:
        """Normalized headroom of ``tenant``'s p99 under its SLO (1.0 when
        unobserved: an idle tenant never throttles anyone)."""
        win = self._window.get(tenant)
        if not win:
            return 1.0
        p = float(np.quantile(np.asarray(win), self.cfg.quantile))
        return (self._slo[tenant] - p) / self._slo[tenant]

    def min_slack(self) -> float:
        """Worst slack over all registered tenants (the governing tenant)."""
        if not self._slo:
            return 1.0
        return min(self.slack(t) for t in self._slo)

    def pacing_factor(self) -> float:
        """Budget multiplier in [0, 1]: 1 above ``high_slack``, 0 at/below
        ``low_slack``, linear between (the min_blocks floor is applied by
        the budget methods, not here)."""
        s = self.min_slack()
        c = self.cfg
        if s >= c.high_slack:
            return 1.0
        if s <= c.low_slack:
            return 0.0
        return (s - c.low_slack) / (c.high_slack - c.low_slack)

    def migration_priority(self, tenant, scale: int = 8) -> int:
        """Pipeline priority for a migration serving ``tenant``: the less
        slack a tenant has, the sooner the rebalance that relieves it must
        drain (priority rises as slack falls), with the tenant's serving
        priority as tie-break.  Returns an int in [0, scale + max priority].
        """
        s = min(max(self.slack(tenant), 0.0), 1.0)
        return int(round((1.0 - s) * scale)) + self._priority.get(tenant, 0)


_SCHEDULERS = {
    "leap": LeapScheduler,
    "sync": SyncScheduler,
    "slo": SloScheduler,
}


def make_scheduler(spec, n_blocks: int | None = None):
    """Resolve a scheduler spec: a policy instance (returned as-is), a name
    (``"leap"``/``"sync"``/``"slo"``/``"sampling"``), or None (the default
    leap policy).  ``"sampling"`` needs ``n_blocks`` for its counter
    vectors."""
    if spec is None:
        return LeapScheduler()
    if isinstance(spec, str):
        if spec == "sampling":
            if n_blocks is None:
                raise ValueError("scheduler 'sampling' needs n_blocks")
            return SamplingScheduler(n_blocks)
        try:
            return _SCHEDULERS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown scheduler {spec!r} (want one of "
                f"{sorted(_SCHEDULERS) + ['sampling']})"
            ) from None
    return spec
