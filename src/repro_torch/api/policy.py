"""Pluggable placement policy: who decides *where* blocks should live.

The mechanism (copy, dirty-check, atomic remap) belongs to the driver; the
*policy* — which blocks to move where, with what urgency — is injected
through this protocol, following the user-level-memory-scheduler split of
policy from mechanism.  A policy observes the pool through the sealed
:class:`repro.api.PoolFacade` and returns :class:`Move` s; the session turns
each move into one tracked request (`session.apply`).

Implementations in-tree:

* ``repro.core.baselines.AutoBalancer.decide`` — access-counter heuristics
  (the auto-NUMA-balancing analogue, now expressible through the same API
  the explicit path uses);
* ``repro.serving.engine.PagedEngine.decide`` — sequence affinity: every
  live sequence's KV pages follow its declared home region.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence, runtime_checkable

import numpy as np


@dataclasses.dataclass(frozen=True)
class Move:
    """One placement decision: put ``block_ids`` on ``dst_region``.

    ``priority=None`` means "no opinion" — the session's ``apply(...,
    priority=...)`` default is used; an explicit ``priority=0`` is honored
    as genuine background-class urgency.
    """

    block_ids: np.ndarray
    dst_region: int
    priority: int | None = None
    tag: object = None  # opaque caller label, copied onto the handle


MoveLike = Move | tuple  # policies may return bare (block_ids, dst_region[, priority]) tuples


def as_move(m: MoveLike) -> Move:
    if isinstance(m, Move):
        return m
    block_ids, dst_region, *rest = m
    return Move(
        np.asarray(block_ids, dtype=np.int32),
        int(dst_region),
        int(rest[0]) if rest else None,
    )


@runtime_checkable
class PlacementPolicy(Protocol):
    """Anything with a ``decide(facade) -> moves`` method places blocks."""

    def decide(self, facade) -> Sequence[MoveLike]:
        """Return the moves this policy wants, given a read-only pool view."""
        ...
