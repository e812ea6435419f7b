"""Adaptive area sizing (paper §4.2) and dispatch-shape bucketing.

The user picks only an *initial* area size.  When an area's commit is
rejected because blocks became dirty, the driver requeues the dirty blocks as
``reduction_factor`` smaller sub-areas, halving (by default) the exposure
window per retry.  Skewed write pressure therefore shrinks granularity only
where the pressure is (clean sub-ranges of a rejected area are *not*
requeued — they already migrated at commit).

Adaptive splitting produces a storm of distinct batch lengths, and every
distinct length is a fresh XLA trace/compile.  ``bucket_size`` /
``pad_to_bucket`` round every device batch up to a geometric bucket so the
jit cache stabilizes at O(log n) entries (DESIGN.md §3).  Padding replicates
lane 0, which makes every batched program idempotent under the duplicate
lanes — no validity masks or out-of-bounds sentinels needed.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(eq=False)  # identity equality: mutable work item,
# and the generated __eq__ would compare ndarray fields (ambiguous truth)
class Area:
    """A unit of migration: a set of logical blocks headed to one region.

    Block ids need not be contiguous (unlike virtual areas in the paper, a
    block table has no prefetch reason to keep them adjacent), but areas
    produced by :func:`decompose_request` are contiguous runs, matching the
    paper's splitting behaviour.
    """

    block_ids: np.ndarray  # int32 [k]
    src_region: int
    dst_region: int
    attempts: int = 0
    huge: bool = False  # one huge block: G aligned members, run copy, all-or-nothing commit
    # Request plumbing: every area belongs to exactly one submitted request
    # (a LeapHandle); splits and demotions inherit both fields so per-handle
    # accounting and cancellation survive arbitrary re-fragmentation.
    request_id: int = -1
    priority: int = 0
    # Multi-hop routing (topology-aware scheduling): the request's true
    # destination when ``dst_region`` is only an intermediate relay, or -1
    # when ``dst_region`` is final.  Splits/demotions inherit it; the request
    # is credited only when its blocks commit at the final destination.
    final_dst: int = -1
    # Admission stamp (SchedulerPolicy seam): zero-fill the reserved
    # destination slots before the copy/force lands — the page-fault
    # analogue the move_pages()/autonuma-style schedulers pay.  Splits and
    # demotions inherit it (a retried fragment still lands in fresh memory).
    fresh_alloc: bool = False
    # Filled by the driver when the area's epoch opens:
    dst_slots: np.ndarray | None = None
    copied: int = 0  # number of blocks already copied this epoch

    def __len__(self) -> int:
        return len(self.block_ids)

    @property
    def final_destination(self) -> int:
        return self.final_dst if self.final_dst >= 0 else self.dst_region


def decompose_request(
    block_ids: np.ndarray,
    src_region: int,
    dst_region: int,
    initial_area_blocks: int,
    request_id: int = -1,
    priority: int = 0,
    final_dst: int = -1,
    fresh_alloc: bool = False,
) -> list[Area]:
    """Chop a migration request into areas of at most the initial size."""
    out = []
    for start in range(0, len(block_ids), initial_area_blocks):
        ids = np.asarray(block_ids[start : start + initial_area_blocks], dtype=np.int32)
        out.append(
            Area(
                block_ids=ids,
                src_region=src_region,
                dst_region=dst_region,
                request_id=request_id,
                priority=priority,
                final_dst=final_dst,
                fresh_alloc=fresh_alloc,
            )
        )
    return out


def area_blocks_for_distance(
    initial_area_blocks: int, distance: int, reference_distance: int, min_blocks: int = 1
) -> int:
    """Scale the initial area size down on slow links (granularity ∝ link cost).

    A copy epoch across a link that is k× the reference (fastest inter-region)
    distance stays open ~k× longer, so the window in which a concurrent write
    can dirty the area grows with link cost.  Shrinking the initial area by
    the distance ratio (rounded down to a power of two, so bucketed dispatch
    shapes are reused) keeps the per-area exposure window roughly constant
    across links — the §4.2 adaptive-splitting logic then only has to handle
    genuine write pressure, not link latency.
    """
    ratio = max(1.0, distance / max(reference_distance, 1))
    shrink = 1
    while shrink * 2 <= ratio:
        shrink *= 2
    return max(min_blocks, initial_area_blocks // shrink, 1)


def bucket_size(n: int, growth: int = 4) -> int:
    """Smallest power of ``growth`` >= n (the padded dispatch length).

    With growth 4 and a per-tick budget of 64 blocks, copy batches compile at
    most the shapes {1, 4, 16, 64} — four variants instead of one per unique
    length the adaptive splitter happens to produce.
    """
    if n < 1:
        raise ValueError(f"bucket_size needs n >= 1, got {n}")
    if growth < 2:
        raise ValueError(f"bucket_size needs growth >= 2, got {growth}")
    b = 1
    while b < n:
        b *= growth
    return b


def pad_to_bucket(bucket: int, *arrays: np.ndarray) -> tuple[np.ndarray, ...]:
    """Pad equal-length int32 arrays to ``bucket`` lanes by replicating lane 0.

    Replication (rather than a sentinel) keeps every batched device program
    correct without a validity mask: duplicate lanes re-apply lane 0's update
    with identical values, which is idempotent for all migration programs
    (flag sets, table flips, and pool copies all write the same bytes).
    """
    out = []
    for a in arrays:
        a = np.asarray(a, dtype=np.int32)
        if len(a) == 0 or len(a) > bucket:
            raise ValueError(f"cannot pad length {len(a)} to bucket {bucket}")
        out.append(np.concatenate([a, np.full(bucket - len(a), a[0], np.int32)]))
    return tuple(out)


def split_area(
    area: Area, dirty_mask: np.ndarray, reduction_factor: int, min_area_blocks: int
) -> list[Area]:
    """Requeue the dirty blocks of a rejected area as smaller sub-areas.

    Only dirty blocks are retried (clean ones committed).  The sub-area size
    is ``max(len(area)//reduction_factor, min_area_blocks)``.
    """
    dirty_ids = area.block_ids[dirty_mask]
    if len(dirty_ids) == 0:
        return []
    target = max(len(area) // reduction_factor, min_area_blocks)
    target = max(target, 1)
    out = []
    for start in range(0, len(dirty_ids), target):
        out.append(
            Area(
                block_ids=np.asarray(dirty_ids[start : start + target], dtype=np.int32),
                src_region=area.src_region,
                dst_region=area.dst_region,
                attempts=area.attempts + 1,
                request_id=area.request_id,
                priority=area.priority,
                final_dst=area.final_dst,
                fresh_alloc=area.fresh_alloc,
            )
        )
    return out


def demote_area(
    area: Area, reduction_factor: int, min_area_blocks: int
) -> list[Area]:
    """Paper §4.2 demotion: retry a rejected huge area at small granularity.

    The huge block could not commit atomically (every rejection means *some*
    member kept being written during the run's copy epoch), so the whole run
    is requeued as small areas: clean members now commit independently while
    the write-hot ones keep splitting down — exactly the small-page behaviour
    the huge mapping was suppressing.  Attempts carry over so write-through
    escalation still bounds the total retry count.
    """
    if not area.huge:
        raise ValueError("demote_area expects a huge area")
    target = max(len(area) // reduction_factor, min_area_blocks, 1)
    out = []
    for start in range(0, len(area), target):
        out.append(
            Area(
                block_ids=np.asarray(
                    area.block_ids[start : start + target], dtype=np.int32
                ),
                src_region=area.src_region,
                dst_region=area.dst_region,
                attempts=area.attempts,
                huge=False,
                request_id=area.request_id,
                priority=area.priority,
                final_dst=area.final_dst,
                fresh_alloc=area.fresh_alloc,
            )
        )
    return out
