"""Two-tier pooled memory: huge-block tier over the small-slot pool.

A *huge block* is ``G`` physically-contiguous, G-aligned small slots in one
region (``G = PoolConfig.huge_factor``), mirroring the paper's huge pages:
one level-1 table entry maps ``G`` logical blocks at once, and a huge block
migrates as a single area through one contiguous-run copy.  The pieces:

  * :mod:`repro.pool.buddy`  — per-region buddy allocator (split/coalesce)
    that also speaks the small-slot ``FreeList`` API the driver/baselines use;
  * :mod:`repro.pool.table`  — the host-side two-level block table (which
    aligned groups are huge, and where each huge block starts);
  * :mod:`repro.pool.policy` — promotion eligibility (aligned, fully
    resident, cold) and the demotion bookkeeping rule (paper §4.2).

Consumers: the staged pipeline's :class:`~repro.core.pipeline.context.
PipelineContext` holds the per-region allocators and the level-1 table;
promotion/adoption compaction runs in the dispatch stage
(``DispatchStage.promote_group``/``adopt_huge``) and demotion in the
verdict stage (``VerdictStage.demote_group``) — see DESIGN.md §5/§8 for
the invariants.
"""

from repro_torch.pool.buddy import BuddyAllocator
from repro_torch.pool.table import TwoLevelTable
from repro_torch.pool.policy import PromotionPolicy

__all__ = ["BuddyAllocator", "TwoLevelTable", "PromotionPolicy"]
