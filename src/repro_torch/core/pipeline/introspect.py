"""Read-only pipeline introspection: a coherent snapshot for validators.

External auditors — the chaos harness's ``InvariantChecker`` first among
them — need one consistent picture of the pipeline's host bookkeeping:
which slots are free, which are resident in the table, which are reserved
by open or pending epochs, and which are quarantined by this tick's forced
escalations.  Reaching into stage privates for that would couple every
validator to stage internals and risk perturbing live state, so
:func:`snapshot` assembles the picture from plain *copied* numpy data:
nothing returned aliases the live pipeline.

The snapshot is taken between driver operations (no device round-trip), so
it is exact by the same argument the host mirrors are exact: the driver
performs every allocation and remap itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.pipeline.context import PipelineContext

QUEUED = "queued"
ACTIVE = "active"
PENDING = "pending"


@dataclasses.dataclass(frozen=True)
class AreaView:
    """Immutable copy of one in-pipeline :class:`~repro.core.adaptive.Area`."""

    stage: str  # QUEUED (no epoch yet) | ACTIVE (epoch open) | PENDING (verdict)
    block_ids: np.ndarray  # int32 copy
    src_region: int
    dst_region: int
    final_dst: int  # -1 when dst_region is the true destination
    request_id: int
    priority: int
    huge: bool
    attempts: int
    copied: int
    dst_slots: np.ndarray | None  # reserved destination slots (copy), or None

    def __len__(self) -> int:
        return len(self.block_ids)


@dataclasses.dataclass(frozen=True)
class PipelineSnapshot:
    """Copied host bookkeeping of one driver at one instant."""

    n_blocks: int
    n_regions: int
    slots_per_region: int
    table: np.ndarray  # [n_blocks, (region, slot)] mirror copy
    migrating: np.ndarray  # [n_blocks] bool copy
    free_slots: dict[int, np.ndarray]  # region -> free slot ids (sorted copy)
    quarantined: np.ndarray  # [k, (region, slot)] force-freed, unreleased slots
    areas: tuple[AreaView, ...]  # queued + active + pending, in stage order

    def areas_of(self, request_id: int) -> list[AreaView]:
        return [a for a in self.areas if a.request_id == request_id]

    def reserved_slots(self, region: int) -> np.ndarray:
        """Destination slots reserved on ``region`` by open/pending epochs."""
        held = [
            a.dst_slots
            for a in self.areas
            if a.dst_slots is not None and a.dst_region == region
        ]
        if not held:
            return np.zeros(0, dtype=np.int32)
        return np.concatenate(held).astype(np.int32)


def _view(area, stage: str) -> AreaView:
    return AreaView(
        stage=stage,
        block_ids=np.asarray(area.block_ids, dtype=np.int32).copy(),
        src_region=int(area.src_region),
        dst_region=int(area.dst_region),
        final_dst=int(area.final_dst),
        request_id=int(area.request_id),
        priority=int(area.priority),
        huge=bool(area.huge),
        attempts=int(area.attempts),
        copied=int(area.copied),
        dst_slots=(
            None
            if area.dst_slots is None
            else np.asarray(area.dst_slots, dtype=np.int32).copy()
        ),
    )


def snapshot(ctx: PipelineContext, quarantined: np.ndarray) -> PipelineSnapshot:
    """Assemble a read-only snapshot from the shared pipeline context.

    ``quarantined`` is the dispatch stage's current quarantine (``(region,
    slot)`` rows of source slots freed by forced escalations but not yet
    released for reallocation) — empty between ticks, possibly non-empty
    when snapshotting from inside a tick hook.
    """
    areas = (
        [_view(a, QUEUED) for a in ctx.queue]
        + [_view(a, ACTIVE) for a in ctx.active]
        + [_view(a, PENDING) for batch in ctx.pending for a in batch.areas]
    )
    free = {
        r: np.asarray(sorted(ctx.free[r]), dtype=np.int32)
        for r in range(ctx.pool_cfg.n_regions)
    }
    return PipelineSnapshot(
        n_blocks=int(ctx.state.n_blocks),
        n_regions=int(ctx.pool_cfg.n_regions),
        slots_per_region=int(ctx.pool_cfg.slots_per_region),
        table=ctx.table.copy(),
        migrating=ctx.migrating.copy(),
        free_slots=free,
        quarantined=np.asarray(quarantined, dtype=np.int32).reshape(-1, 2),
        areas=tuple(areas),
    )
