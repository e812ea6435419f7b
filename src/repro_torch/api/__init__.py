"""Public `page_leap()` surface: sessions, request futures, a sealed facade.

This package is the supported way to drive migration (DESIGN.md §6):

    session = LeapSession(driver)          # or driver.default_session()
    handle  = session.leap(block_ids, dst_region, priority=2, on_done=cb)
    handle.status / handle.progress()      # QUEUED/COPYING/.../per-block counts
    handle.wait(max_ticks) / handle.cancel()
    session.facade.placement()             # read-only observation, no privates
    session.apply(policy)                  # pluggable PlacementPolicy -> handles

It deliberately imports nothing from :mod:`repro.core` at module scope, so
core (which shims its legacy ``request()``/``drain()`` through a default
session) can import it without a cycle.
"""

from repro_torch.api.facade import PoolFacade
from repro_torch.api.handle import HandleStatus, LeapHandle, Progress
from repro_torch.api.policy import Move, PlacementPolicy
from repro_torch.api.session import LeapSession

__all__ = [
    "HandleStatus",
    "LeapHandle",
    "LeapSession",
    "Move",
    "PlacementPolicy",
    "PoolFacade",
    "Progress",
]
