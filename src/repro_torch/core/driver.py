"""Host-side control plane for leap migration (the user-space part).

The paper's `page_leap()` runs its migration loop in a user-space thread:
pick an area, copy it, check the dirty flag, remap or requeue.  Here the
control plane is ordinary Python driving PyTorch device programs, decomposed
into an explicit staged pipeline (``repro_torch.core.pipeline``):

  admission → routing → budget → dispatch → verdict → accounting

:class:`MigrationDriver` is the thin composition root: it builds the shared
:class:`~repro.core.pipeline.PipelineContext` (device state + exact host
mirrors + queues), wires the stages, and keeps the stable public API.  The
active :class:`~repro.core.pipeline.SchedulerPolicy` decides how requests
are admitted and how fast ticks drain — the paper's baselines
(move_pages()-style sync, autonuma-style sampling) are policies over this
same engine, not separate code paths.

Asynchrony model: every device program is queued on the current CUDA
stream; the driver only blocks when it *needs* a commit verdict and the
device hasn't produced it yet.  The driver runs on the device of
``state.pool`` and builds its heat plane there.  Interleaving application write/compute steps between
``tick()`` calls reproduces the paper's concurrent-writer races at step
granularity (see DESIGN.md §2).

Compatibility: ``LeapConfig`` / ``MigrationStats`` / ``RequestState`` /
``FreeList`` now live in ``core/config.py`` / ``core/stats.py`` /
``core/queues.py`` and are re-exported here, so
``from repro_torch.core.driver import LeapConfig`` keeps working.
``request()`` and ``drain()`` survive as deprecation shims over the default
:class:`repro_torch.api.LeapSession`.  The JAX package's ``mesh`` argument
waits for the multi-device slice.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core import migrator
from repro_torch.core.config import LeapConfig
from repro_torch.core.pipeline import (
    AccountingStage,
    AdmissionStage,
    AdmissionTicket,
    BudgetStage,
    DispatchStage,
    PipelineContext,
    RoutingStage,
    VerdictStage,
    make_scheduler,
)
from repro_torch.core.queues import AreaQueue, CommitBatch, FreeList, _AreaQueue, _CommitBatch
from repro_torch.core.state import (
    REGION,
    SLOT,
    LeapState,
    PoolConfig,
    leap_read,
    leap_write,
    leap_write_rows,
)
from repro_torch.core.stats import MigrationStats, RequestState
from repro_torch.obs import make_recorder
from repro_torch.pool import BuddyAllocator, PromotionPolicy, TwoLevelTable

__all__ = [
    # the driver itself
    "MigrationDriver",
    # re-export shims (pre-pipeline homes of these types)
    "LeapConfig",
    "MigrationStats",
    "RequestState",
    "FreeList",
    "AreaQueue",
    "CommitBatch",
    "_AreaQueue",
    "_CommitBatch",
]


def _host_ids(block_ids) -> np.ndarray:
    """Block ids on the host, where the mirrors and heat samples live."""
    if isinstance(block_ids, torch.Tensor):
        return block_ids.cpu().numpy()
    return np.asarray(block_ids)


class MigrationDriver:
    """Owns a :class:`LeapState` and migrates blocks reliably between regions."""

    def __init__(
        self,
        state: LeapState,
        pool_cfg: PoolConfig,
        cfg: LeapConfig | None = None,
        scheduler=None,  # SchedulerPolicy | "leap" | "sync" | "sampling" | None
    ):
        cfg = cfg or LeapConfig()
        # Host mirrors (the driver performs every allocation/remap, so these
        # stay exact without device round-trips).
        table = state.table.cpu().numpy().copy()
        free_mask = np.ones((pool_cfg.n_regions, pool_cfg.slots_per_region), bool)
        free_mask[table[:, REGION], table[:, SLOT]] = False
        if pool_cfg.huge_factor > 1:
            # Two-tier pool: per-region buddy allocators (FreeList-compatible
            # for order-0 traffic) + the level-1 table.  All groups start
            # small; promote_group / adopt_huge raise them.
            free = []
            for r in range(pool_cfg.n_regions):
                buddy = BuddyAllocator(pool_cfg.slots_per_region, pool_cfg.huge_factor)
                buddy.reserve(np.nonzero(~free_mask[r])[0])
                free.append(buddy)
            tiers = TwoLevelTable(state.n_blocks, pool_cfg.huge_factor)
            promotion = PromotionPolicy(cold_ticks=cfg.promote_cold_ticks)
            last_write = np.full(state.n_blocks, -(1 << 40), dtype=np.int64)
        else:
            # store descending so the LIFO top hands out the lowest slot first
            free = [
                FreeList(np.nonzero(free_mask[r])[0][::-1])
                for r in range(pool_cfg.n_regions)
            ]
            tiers, promotion, last_write = None, None, None
        if cfg.tiering:
            # Closed-loop tiering: the device heat plane (updated as the
            # megastep's trailing phase) starts cold, on the pool's device.
            from repro_torch.kernels.heat_scan import padded_heat_len

            heat = torch.zeros(
                padded_heat_len(state.n_blocks), dtype=torch.float32, device=state.device
            )
        else:
            heat = None
        self.ctx = PipelineContext(
            state=state,
            pool_cfg=pool_cfg,
            cfg=cfg,
            topology=pool_cfg.topology,  # None -> uniform (all links equal)
            scheduler=make_scheduler(scheduler, n_blocks=state.n_blocks),
            table=table,
            free=free,
            migrating=np.zeros(state.n_blocks, dtype=bool),  # open requests
            tiers=tiers,
            promotion=promotion,
            last_write=last_write,
            heat=heat,
            # Migration-recency mirror: unconditional (cheap host array) so
            # ping-pong accounting meters every scheduler/policy identically.
            last_migrated=np.full(state.n_blocks, -(1 << 40), dtype=np.int64),
            telemetry=make_recorder(cfg),
        )
        # Stage wiring (construction order follows the data flow).
        self._accounting = AccountingStage(self.ctx)
        self._routing = RoutingStage(self.ctx)
        self._admission = AdmissionStage(self.ctx, self._routing, self._accounting)
        self._budget = BudgetStage(self.ctx)
        self._verdict = VerdictStage(self.ctx, self._routing, self._accounting)
        self._dispatch = DispatchStage(self.ctx, self._budget, self._accounting)
        self._cache_baseline = migrator.program_cache_size()
        self._default_session = None  # lazily built repro.api.LeapSession

    # -- context views (the context is the single source of truth) ---------

    @property
    def state(self) -> LeapState:
        return self.ctx.state

    @state.setter
    def state(self, value: LeapState) -> None:
        self.ctx.state = value

    @property
    def pool_cfg(self) -> PoolConfig:
        return self.ctx.pool_cfg

    @property
    def cfg(self) -> LeapConfig:
        return self.ctx.cfg

    @property
    def topology(self):
        return self.ctx.topology

    @property
    def scheduler(self):
        """The active :class:`~repro.core.pipeline.SchedulerPolicy`."""
        return self.ctx.scheduler

    @property
    def stats(self) -> MigrationStats:
        return self.ctx.stats

    @property
    def telemetry(self):
        """The context's recorder (``NULL_RECORDER`` when telemetry is off)."""
        return self.ctx.telemetry

    @property
    def tiers(self):
        return self.ctx.tiers

    @property
    def requests(self) -> dict[int, RequestState]:
        return self.ctx.requests

    # -- application-facing I/O (everything mutating goes through here) ----

    def read(self, block_ids, *, note: bool = True) -> torch.Tensor:
        """Read blocks out of the pool.

        ``note=False`` skips the heat-plane accounting — for introspection
        readers (the chaos payload checker scans the whole pool every tick,
        which would wash out the workload's access signal), not workloads.
        """
        block_ids = _host_ids(block_ids)
        if note:
            self.ctx.note_reads(block_ids)
        return leap_read(self.ctx.state, block_ids)

    def note_reads(self, block_ids) -> None:
        """Feed read accesses into the heat plane without copying data out.

        For layers that read the pool inside their own jitted programs (the
        paged-KV decode step) and therefore never call :meth:`read` — they
        report the block ids they touched here so the tiering loop still
        sees them.  No-op when ``cfg.tiering`` is off.
        """
        self.ctx.note_reads(_host_ids(block_ids))

    def write(self, block_ids, values) -> None:
        block_ids = _host_ids(block_ids)
        self.ctx.note_writes(block_ids)
        self.ctx.state = leap_write(self.ctx.state, block_ids, values)

    def write_rows(self, block_ids, row_offsets, rows) -> None:
        block_ids = _host_ids(block_ids)
        self.ctx.note_writes(block_ids)
        self.ctx.state = leap_write_rows(self.ctx.state, block_ids, row_offsets, rows)

    # -- migration API ------------------------------------------------------

    def submit(
        self,
        block_ids,
        dst_region: int,
        priority: int = 0,
        callbacks=(),
        ticket: AdmissionTicket | None = None,
    ) -> RequestState:
        """Enqueue migration of ``block_ids`` to ``dst_region`` as one request.

        See :meth:`repro.core.pipeline.AdmissionStage.submit` — ``ticket``
        overrides the scheduler policy's default admission stamp.
        ``callbacks`` are invoked with the :class:`RequestState` once every
        enqueued block has committed, been forced, or been cancelled; a
        request that enqueues nothing completes (and fires) immediately.
        """
        return self._admission.submit(
            block_ids,
            dst_region,
            priority=priority,
            callbacks=callbacks,
            ticket=ticket,
        )

    def cancel_request(self, rid: int) -> int:
        """Cancel request ``rid``; see :meth:`AdmissionStage.cancel`."""
        return self._admission.cancel(rid)

    def request_in_flight(self, rid: int) -> bool:
        """True while any area of ``rid`` has an open epoch or pending verdict."""
        if any(a.request_id == rid for a in self.ctx.active):
            return True
        return any(
            a.request_id == rid for batch in self.ctx.pending for a in batch.areas
        )

    def in_migration(self, block_ids) -> np.ndarray:
        """Which of ``block_ids`` currently belong to an open request
        (queued, copying, or awaiting a verdict).  Read-only bool copy."""
        return self.ctx.migrating[np.asarray(block_ids, dtype=np.int64)].copy()

    def default_session(self):
        """The driver's default :class:`repro.api.LeapSession` (lazily built).

        The session (and its handles/facade) is the supported public surface;
        the legacy ``request()``/``drain()`` methods delegate here.
        """
        if self._default_session is None:
            from repro_torch.api import LeapSession  # deferred: api sits above core

            self._default_session = LeapSession(self)
        return self._default_session

    def request(self, block_ids, dst_region: int) -> int:
        """Deprecated shim: ``default_session().leap(...)`` without the handle.

        Returns the number of blocks actually enqueued, exactly as before.
        Prefer :meth:`repro.api.LeapSession.leap`, which returns a
        :class:`repro.api.LeapHandle` future with progress/cancellation.
        """
        warnings.warn(
            "MigrationDriver.request() is deprecated; use "
            "LeapSession.leap() which returns a LeapHandle",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.default_session().leap(block_ids, dst_region).requested

    @property
    def done(self) -> bool:
        ctx = self.ctx
        return not (ctx.queue or ctx.active or ctx.pending)

    @property
    def pending_blocks(self) -> int:
        ctx = self.ctx
        n = sum(len(a) for a in ctx.queue) + sum(len(a) for a in ctx.active)
        n += sum(len(a) for batch in ctx.pending for a in batch.areas)
        return int(n)

    # -- the migration loop --------------------------------------------------

    def tick(self) -> None:
        """One asynchronous migration slice: spend the per-tick block budget.

        A tick (i) harvests any commit verdicts that are already on the host
        (verdict stage), (ii) dispatches commits for areas whose copy
        completed in an earlier tick, (iii) advances copies of open epochs
        and opens new epochs within the budget stage's grants (dispatch
        stage).  By default the whole tick is ONE fused device program (the
        megastep, DESIGN.md §12; <=3 programs under batched dispatch);
        dispatches are async either way — interleave application steps
        between ticks for concurrency.
        """
        ctx = self.ctx
        ctx.stats.ticks += 1
        ctx.telemetry.begin_tick(ctx.stats.ticks)
        misses_before = ctx.stats.jit_cache_misses
        with ctx.telemetry.stage("tick"):
            self._verdict.harvest(block=False)
            self._dispatch.commit_ready()
            self._dispatch.run_tick(self._budget.open_tick())
            if ctx.cfg.promote_per_tick and ctx.tiers is not None:
                for g in self.promote_candidates(ctx.cfg.promote_per_tick):
                    self.promote_group(g)
            ctx.stats.jit_cache_misses = (
                migrator.program_cache_size() - self._cache_baseline
            )
        if ctx.telemetry.enabled and ctx.stats.jit_cache_misses != misses_before:
            # attribute compilation stalls to the tick that paid for them
            ctx.telemetry.event(
                "jit", "jit_miss", n=ctx.stats.jit_cache_misses - misses_before
            )

    def poll(self, block: bool = False) -> None:
        """Harvest commit verdicts: opportunistically, or blocking until all
        pending verdicts are on the host (``block=True``).  Public so the
        session layer can drive the migration loop without driver privates.
        """
        self._verdict.harvest(block=block)

    def drain(self, max_ticks: int = 100_000) -> bool:
        """Deprecated shim over ``default_session().drain(...)``.

        Runs ticks until all requested blocks migrated (or the tick budget
        ends); returns True on full migration.  With write-through escalation
        this terminates for any write workload (beyond-paper guarantee); the
        tick cap is the analogue of the paper's 10s timeout.
        """
        warnings.warn(
            "MigrationDriver.drain() is deprecated; use "
            "default_session().drain() or LeapHandle.wait()",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.default_session().drain(max_ticks)

    # -- tier transitions (two-tier pool; dispatch-stage compaction) ---------

    def promote_candidates(self, limit: int | None = None) -> list[int]:
        """Groups currently eligible for promotion (aligned, resident, cold)."""
        return self._dispatch.promote_candidates(limit)

    def promote_group(self, g: int) -> bool:
        """Coalesce group ``g``'s G small blocks into one huge block."""
        return self._dispatch.promote_group(g)

    def adopt_huge(self, group_ids) -> int:
        """Zero-copy promotion of already-aligned resident runs."""
        return self._dispatch.adopt_huge(group_ids)

    # -- live reconfiguration ------------------------------------------------

    def set_topology(self, topology) -> None:
        """Swap the live :class:`repro.topology.NumaTopology` (or ``None``).

        The budget and routing stages consult ``ctx.topology`` every tick, so
        the swap takes effect at the next ``tick()`` — this is how link
        degradation/congestion is injected under load (the machine changed;
        in-flight epochs finish under the schedule they were granted).
        ``PoolConfig`` is frozen, so the pool's static config keeps its
        construction-time topology; the context holds the live one.
        """
        if topology is not None and topology.n_regions != self.ctx.pool_cfg.n_regions:
            raise ValueError(
                f"topology has {topology.n_regions} regions, pool has "
                f"{self.ctx.pool_cfg.n_regions}"
            )
        self.ctx.topology = topology

    # -- introspection ---------------------------------------------------------

    def introspect(self):
        """Read-only :class:`~repro.core.pipeline.PipelineSnapshot` of the
        host bookkeeping: free/resident/reserved/quarantined slots, every
        in-pipeline area, the mirrors.  Everything is copied — safe to hand
        to external validators (the chaos invariant checker)."""
        from repro_torch.core.pipeline.introspect import snapshot  # local: avoid cycle

        return snapshot(self.ctx, self._dispatch.quarantined_slots())

    def host_placement(self) -> np.ndarray:
        return self.ctx.table[:, REGION].copy()

    def heat_snapshot(self) -> np.ndarray:
        """Per-block access heat ``[n_blocks]`` (all zeros when tiering is off).

        A host copy of the device heat plane; samples noted since the last
        tick's dispatch are not yet folded in.  This is the tiering policy's
        decision input — one transfer per epoch, off the tick path.
        """
        n = self.ctx.state.n_blocks
        if self.ctx.heat is None:
            return np.zeros(n, np.float32)
        return self.ctx.heat[:n].cpu().numpy().copy()

    def host_table(self) -> np.ndarray:
        """Copy of the exact host table mirror ``[n_blocks, (region, slot)]``."""
        return self.ctx.table.copy()

    def regions_of(self, block_ids) -> np.ndarray:
        """Current regions of just ``block_ids`` (fancy-indexed copy — O(k),
        not a full-table copy; the facade's hot-path accessor)."""
        return self.ctx.table[np.asarray(block_ids, dtype=np.int64), REGION]

    def slots_of(self, block_ids) -> np.ndarray:
        """Current slots of just ``block_ids`` (fancy-indexed copy)."""
        return self.ctx.table[np.asarray(block_ids, dtype=np.int64), SLOT]

    def free_slots(self, region: int) -> int:
        """Number of free pooled slots on ``region`` right now."""
        return len(self.ctx.free[region])

    def debug_free_list(self, region: int):
        """The region's live allocator (FreeList or BuddyAllocator).

        Mutable, and shared with the driver — for tests and the in-core
        baselines only (e.g. to fabricate fragmentation).  Everything else
        should go through :meth:`free_slots` / the read-only facade.
        """
        return self.ctx.free[region]

    def verify_mirror(self) -> bool:
        """Debug: host table mirror must match device table exactly."""
        return bool(np.array_equal(self.ctx.table, self.ctx.state.table.cpu().numpy()))

    def verify_tiers(self) -> bool:
        """Debug: level-1 table consistent with the flat mirror, and every
        region's buddy allocator satisfies its invariants."""
        if self.ctx.tiers is None:
            return True
        self.ctx.tiers.check_consistent(self.ctx.table)
        for f in self.ctx.free:
            f.check()
        return True
