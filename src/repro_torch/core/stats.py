"""Migration accounting records: engine-wide stats and per-request state.

Extracted from ``core/driver.py`` when the driver decomposed into the staged
pipeline; ``from repro.core.driver import MigrationStats, RequestState``
keeps working through the driver's re-export shims.  Inside the pipeline,
:class:`repro.core.pipeline.accounting.AccountingStage` is the only writer
of :class:`RequestState` credit.
"""

from __future__ import annotations

import copy
import dataclasses


@dataclasses.dataclass
class MigrationStats:
    blocks_requested: int = 0
    blocks_migrated: int = 0
    blocks_forced: int = 0
    blocks_cancelled: int = 0  # dropped by cancel_request before committing
    bytes_copied: int = 0  # includes retry traffic (Table 2 accounting)
    dirty_rejections: int = 0
    splits: int = 0
    # Device programs issued.  One fused megastep counts as ONE dispatch
    # (the whole point of the single-dispatch tick), not one per fused
    # phase; the batched generation counts each of its <=3 programs.
    dispatches: int = 0
    ticks: int = 0
    jit_cache_misses: int = 0  # migration-program compiles since driver init
    # per-tier counters (two-tier pool; all zero on a small-only pool)
    huge_areas_committed: int = 0  # huge blocks remapped atomically as one run
    demotions: int = 0  # huge blocks split to small under write pressure/fragmentation
    promotions: int = 0  # aligned cold runs coalesced into huge blocks
    bytes_copied_huge: int = 0  # copy traffic moved via contiguous-run programs
    # closed-loop tiering counters (repro.tiering; DESIGN.md §13)
    tier_promotions: int = 0  # blocks the tiering policy moved toward the near tier
    tier_demotions: int = 0  # blocks the tiering policy pushed to the far tier
    # re-migrations within cfg.tier_pingpong_window ticks of the previous
    # move — counted engine-side (any scheduler/policy), so baselines without
    # hysteresis are charged on the same meter as the tiering policy
    ping_pong_migrations: int = 0
    # per-link counters (topology-aware scheduling; bytes_per_link is tracked
    # on every driver so benchmarks can model link costs post-hoc)
    bytes_per_link: dict = dataclasses.field(default_factory=dict)  # (src, dst) -> bytes
    deferred_congested: int = 0  # area-ticks deferred because a link budget ran dry
    multi_hop_areas: int = 0  # first-hop areas routed via an intermediate region

    def extra_bytes(self, block_bytes: int) -> int:
        useful = (self.blocks_migrated + self.blocks_forced) * block_bytes
        return max(0, self.bytes_copied - useful)

    @property
    def dispatches_per_tick(self) -> float:
        """Device programs issued per migration tick (control-path cost).

        ~1.0 under megastep dispatch (idle ticks dispatch nothing, so a
        drain's warm steady state sits at or just under 1.0), <= 3 under
        batched dispatch, O(areas + chunks) on the legacy path.
        """
        return self.dispatches / self.ticks if self.ticks else 0.0

    def snapshot(self) -> "MigrationStats":
        """Fully independent copy — what the sealed facade hands out, so
        observers can't mutate live accounting.  A deep copy, not a
        field-by-field one: any container field added later is covered
        automatically instead of silently aliasing the live object."""
        return copy.deepcopy(self)


@dataclasses.dataclass
class RequestState:
    """Per-request accounting: the driver-side half of a ``LeapHandle``.

    Every block a request enqueued ends in exactly one of three buckets —
    ``committed`` (clean commit remapped it), ``forced`` (write-through
    escalation moved it), or ``cancelled`` (dropped by
    :meth:`MigrationDriver.cancel_request` before it could commit) — so
    ``committed + forced + cancelled == requested`` holds at termination.
    """

    rid: int
    dst_region: int
    priority: int = 0
    requested: int = 0
    committed: int = 0
    forced: int = 0
    cancelled: int = 0
    cancel_requested: bool = False
    callbacks: list = dataclasses.field(default_factory=list)

    @property
    def remaining(self) -> int:
        return self.requested - self.committed - self.forced - self.cancelled

    @property
    def done(self) -> bool:
        return self.remaining == 0
