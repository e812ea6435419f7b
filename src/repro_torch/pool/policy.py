"""Tier-transition policy: when a group may promote to a huge block.

Promotion requires an **aligned, fully-resident, cold** run of small blocks:

  * *aligned* — only group ``g``'s ids ``[g*G, (g+1)*G)`` can share a level-1
    entry (a huge entry maps an aligned logical range, like a huge-page PTE);
  * *fully resident in one region* — the huge block is one physical run, so
    all members must already live on the same region (the promotion copy is
    intra-region compaction, never a disguised migration);
  * *cold* — no member written within ``cold_ticks`` driver ticks, and no
    member under an open migration: promoting a write-hot group would
    immediately re-create the huge-commit-rejection pressure that demotion
    exists to relieve (paper §4.2 run in reverse).

Demotion is the opposite rule and is driven by the migration driver, not by
this policy: a huge-area commit rejected ``demote_after_attempts`` times
under write pressure (or a destination too fragmented to hold a run) splits
the huge block into ``G`` small blocks and retries at small granularity.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.pool.table import REGION, TwoLevelTable


@dataclasses.dataclass
class PromotionPolicy:
    cold_ticks: int = 0  # 0 => structural checks only (no recency gate)

    def eligible(
        self,
        g: int,
        tiers: TwoLevelTable,
        flat_table: np.ndarray,
        migrating: np.ndarray,
        last_write: np.ndarray,
        clock: int,
    ) -> bool:
        if g < 0 or g >= tiers.n_groups or tiers.tier[g]:
            return False
        m = tiers.members(g)
        if migrating[m].any():
            return False
        if not (flat_table[m, REGION] == flat_table[m[0], REGION]).all():
            return False
        if self.cold_ticks > 0 and clock - int(last_write[m].max()) < self.cold_ticks:
            return False
        return True

    def candidates(
        self,
        tiers: TwoLevelTable,
        flat_table: np.ndarray,
        migrating: np.ndarray,
        last_write: np.ndarray,
        clock: int,
    ) -> list[int]:
        return [
            g
            for g in range(tiers.n_groups)
            if self.eligible(g, tiers, flat_table, migrating, last_write, clock)
        ]
