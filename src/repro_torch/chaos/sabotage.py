"""Deliberate invariant breakage: re-introduce known-fixed bugs live.

A checker nobody has seen fail is dead code, so the harness can wound a
driver on purpose and assert the :class:`InvariantChecker` draws blood.
This module is the ONE place in the chaos package allowed to reach into
pipeline privates (exempted from the source scan in tests/test_torch_chaos.py): fault
injection has to touch the mechanism it breaks — everything else in the
harness observes through the public introspection seam.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import MigrationDriver
from repro_torch.core.state import REGION, SLOT

SABOTAGES = ("skip_quarantine",)


def apply_sabotage(driver: MigrationDriver, name: str) -> None:
    """Deliberately break a standing invariant inside a live driver.

    ``skip_quarantine`` re-introduces the historical same-tick slot-reuse bug:
    source slots freed by a forced escalation are released immediately
    instead of quarantined until the tick's device batches dispatch, so a
    later open in the same tick can hand the still-unread slot out as a
    zero/force/copy destination — silent payload corruption the structural
    invariants cannot see.
    """
    if name not in SABOTAGES:
        raise ValueError(f"unknown sabotage {name!r}; known: {SABOTAGES}")
    dispatch = driver._dispatch
    orig = dispatch._finalize_success

    def finalize_and_release(area):
        orig(area)
        ctx = dispatch.ctx
        for old in dispatch._freed:
            for r in np.unique(old[:, REGION]):
                ctx.free[r].put(old[old[:, REGION] == r, SLOT])
        dispatch._freed = []

    dispatch._finalize_success = finalize_and_release
