"""Shared mutable state of the staged migration pipeline.

Every stage (admission → routing → budget → dispatch → verdict →
accounting) operates on one :class:`PipelineContext`: the device state, the
exact host mirrors, the work queues, and the accounting records.  The
context also owns the two host-mirror primitives every stage agrees on —
slot allocation and the remap mirror — so the "free old source, point the
table at the new home, clear the open mark" invariant lives in exactly one
place.

The driver builds the context once and shares it with the stages; nothing
here dispatches device programs (that is dispatch.py's job).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.adaptive import Area
from repro_torch.core.config import LeapConfig
from repro_torch.core.queues import AreaQueue, CommitBatch
from repro_torch.core.state import REGION, SLOT, LeapState, PoolConfig
from repro_torch.core.stats import MigrationStats, RequestState
from repro_torch.obs import NULL_RECORDER


@dataclasses.dataclass
class PipelineContext:
    """Everything the pipeline stages share (one instance per driver)."""

    state: LeapState  # device-resident data plane (reassigned per dispatch)
    pool_cfg: PoolConfig
    cfg: LeapConfig
    mesh: Any = None  # RegionMesh (launch/mesh.py) the state is placed on, or None
    topology: Any = None  # NumaTopology, or None (uniform links)
    scheduler: Any = None  # SchedulerPolicy (set by the driver)
    stats: MigrationStats = dataclasses.field(default_factory=MigrationStats)
    telemetry: Any = NULL_RECORDER  # TelemetryRecorder | NullRecorder
    # Host mirrors (the driver performs every allocation/remap, so these
    # stay exact without device round-trips).
    table: np.ndarray | None = None  # [n_blocks, (region, slot)] exact mirror
    free: list = dataclasses.field(default_factory=list)  # per-region allocator
    migrating: np.ndarray | None = None  # [n_blocks] bool: open requests
    # Two-tier pool (None / unused on a small-only pool):
    tiers: Any = None  # TwoLevelTable
    promotion: Any = None  # PromotionPolicy
    last_write: np.ndarray | None = None  # write recency (promotion coldness)
    # Closed-loop tiering (DESIGN.md §13; heat is None when cfg.tiering off):
    heat: Any = None  # device [padded_heat_len] f32 per-block access heat
    heat_pending: list = dataclasses.field(default_factory=list)  # (ids, weight)
    last_migrated: np.ndarray | None = None  # tick of each block's last remap
    # Work queues:
    queue: AreaQueue = dataclasses.field(default_factory=AreaQueue)
    active: list[Area] = dataclasses.field(default_factory=list)
    pending: list[CommitBatch] = dataclasses.field(default_factory=list)
    # Request registry: rid -> accounting record shared with LeapHandles.
    # Holds LIVE requests only; terminal ones are pruned when their
    # callbacks fire (handles keep their own reference).
    requests: dict[int, RequestState] = dataclasses.field(default_factory=dict)
    next_rid: int = 0

    def count(self, name: str, n: int = 1, **args) -> None:
        """Increment ``stats.<name>`` and mirror it into the telemetry log.

        The single write path for pipeline counters: stages never touch
        ``stats`` and the recorder separately, so the event log and the
        accounting cannot drift (tested property: replayed telemetry totals
        equal ``MigrationStats`` on every scenario).
        """
        setattr(self.stats, name, getattr(self.stats, name) + n)
        self.telemetry.count(name, n, **args)

    # -- host-mirror primitives (shared by dispatch and verdict) -----------

    def alloc(self, region: int, n: int) -> np.ndarray | None:
        """Reserve ``n`` destination slots on ``region`` (None = not enough)."""
        return self.free[region].take(n)

    def remap_host(self, ids: np.ndarray, dst_region: int, dst_slots: np.ndarray) -> None:
        """Mirror a device remap: free old sources, point ids at (dst, slots)."""
        if len(ids) == 0:
            return
        old = self.table[ids].copy()
        for r in np.unique(old[:, REGION]):
            self.free[r].put(old[old[:, REGION] == r, SLOT])
        self.table[ids, REGION] = dst_region
        self.table[ids, SLOT] = dst_slots
        self.migrating[ids] = False
        self.note_migrated(ids)

    def note_writes(self, block_ids) -> None:
        """Stamp write recency (promotion coldness gate on the tiered pool)
        and queue a heat sample (closed-loop tiering)."""
        ids = np.asarray(block_ids)
        if self.tiers is not None:
            self.last_write[ids] = self.stats.ticks
        if self.heat is not None and ids.size:
            self.heat_pending.append(
                (ids.astype(np.int32).ravel(), self.cfg.tier_write_weight)
            )

    def note_reads(self, block_ids) -> None:
        """Queue a read heat sample (no-op unless cfg.tiering is on).

        Samples accumulate host-side and fold into the heat plane at the
        tick's dispatch — under megastep as the single program's trailing
        phase, so observing reads never adds a device dispatch.
        """
        if self.heat is None:
            return
        ids = np.asarray(block_ids, dtype=np.int32).ravel()
        if ids.size:
            self.heat_pending.append((ids, 1.0))

    def note_migrated(self, ids) -> None:
        """Stamp migration recency; count re-migrations as ping-pongs.

        Engine-level (called on every successful remap, whatever policy
        requested it): a block migrated again within
        ``cfg.tier_pingpong_window`` ticks of its previous move counts one
        ``ping_pong_migrations`` — the churn the tiering policy's hysteresis
        exists to suppress, charged on the same meter for every baseline.
        """
        if self.last_migrated is None:
            return
        ids = np.asarray(ids)
        if ids.size == 0:
            return
        now = self.stats.ticks
        n = int(((now - self.last_migrated[ids]) <= self.cfg.tier_pingpong_window).sum())
        if n:
            self.count("ping_pong_migrations", n)
        self.last_migrated[ids] = now

    def demote_group(self, g: int) -> None:
        """Split a huge block into G small blocks (host metadata; bytes stay).

        Shared by the verdict stage (write-pressure demotion, §4.2), the
        dispatch stage (fragmented-destination demotion), and admission
        (escalated move_pages()-style requests split huge mappings, like a
        THP split on migration).
        """
        region, start = (int(x) for x in self.tiers.huge_loc[g])
        self.free[region].split_allocated(start)
        self.tiers.demote(g)
        self.count("demotions", 1, group=g)
