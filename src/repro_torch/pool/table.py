"""Host-side two-level block table: which aligned logical groups are huge.

Logical blocks come in aligned groups of ``G``: group ``g`` covers ids
``[g*G, (g+1)*G)``.  A level-1 (huge) entry maps all ``G`` logical blocks of
a group at once to one physical run ``(region, start..start+G)``, mirroring
the paper's huge-page PTEs; everything else resolves through the flat
per-block level-2 table (``LeapState.table`` and the driver's host mirror).

The flat table stays the *expanded* authority on device — a huge group's
member ``i`` always holds the entry ``(region, start + i)`` — so every
existing read/write/decode path works unchanged on both tiers; this object
records which groups are huge and where their runs start, and is checked
against the flat mirror by :meth:`check_consistent`.
"""

from __future__ import annotations

import numpy as np

# Column indices of the flat block table (mirrors repro.core.state.REGION/
# SLOT; duplicated here so repro.pool stays import-cycle-free of repro.core,
# which imports this package from the driver).
REGION = 0
SLOT = 1


class TwoLevelTable:
    def __init__(self, n_blocks: int, huge: int):
        if huge < 1 or (huge & (huge - 1)) != 0:
            raise ValueError(f"huge factor must be a power of two, got {huge}")
        self.G = huge
        self.n_blocks = n_blocks
        self.n_groups = n_blocks // huge  # only the aligned prefix can be huge
        self.tier = np.zeros(self.n_groups, dtype=bool)  # True => huge
        self.huge_loc = np.full((self.n_groups, 2), -1, dtype=np.int32)

    def group_of(self, block_ids) -> np.ndarray:
        return np.asarray(block_ids, dtype=np.int64) // self.G

    def members(self, g: int) -> np.ndarray:
        return np.arange(g * self.G, (g + 1) * self.G, dtype=np.int32)

    def is_huge(self, block_ids) -> np.ndarray:
        """Per-block mask: does this block currently live in a huge block?"""
        gids = self.group_of(block_ids)
        ok = gids < self.n_groups
        out = np.zeros(len(gids), dtype=bool)
        out[ok] = self.tier[gids[ok]]
        return out

    def huge_groups(self) -> np.ndarray:
        return np.nonzero(self.tier)[0].astype(np.int64)

    def promote(self, g: int, region: int, start: int) -> None:
        if self.tier[g]:
            raise ValueError(f"group {g} is already huge")
        if start % self.G != 0:
            raise ValueError(f"huge start {start} not {self.G}-aligned")
        self.tier[g] = True
        self.huge_loc[g] = (region, start)

    def demote(self, g: int) -> None:
        if not self.tier[g]:
            raise ValueError(f"group {g} is not huge")
        self.tier[g] = False
        self.huge_loc[g] = (-1, -1)

    def relocate(self, g: int, region: int, start: int) -> None:
        """A huge block migrated: its level-1 entry follows the run."""
        if not self.tier[g]:
            raise ValueError(f"group {g} is not huge")
        self.huge_loc[g] = (region, start)

    def check_consistent(self, flat_table: np.ndarray) -> bool:
        """Every huge group's members must expand to its contiguous run."""
        for g in np.nonzero(self.tier)[0]:
            r, s0 = self.huge_loc[g]
            m = self.members(int(g))
            assert s0 >= 0 and s0 % self.G == 0, (g, r, s0)
            assert (flat_table[m, REGION] == r).all(), (g, flat_table[m])
            assert (flat_table[m, SLOT] == s0 + np.arange(self.G)).all(), (
                g,
                flat_table[m],
            )
        return True
