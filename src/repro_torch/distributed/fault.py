"""Fault tolerance & elasticity: region drain and spread plans.

Region-resident leap state (KV pages, morsels) survives the loss of a
region logically: the drain plan leap-migrates every block off the failed
or leaving region, and elastic grow is the spread plan in reverse.  This
module computes those plans on the host and drives them through a
:class:`~repro_torch.core.MigrationDriver`, whose device does the moving.
(Checkpoint restore on a new mesh, the JAX package's other half of this
story, lives outside the port so far.)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import MigrationDriver, make_scheduler

# Evacuations outrank routine placement traffic in the priority queue.
DRAIN_PRIORITY = 10


def drain_plan(driver: MigrationDriver, failed_region: int) -> dict[int, np.ndarray]:
    """Blocks to evacuate from ``failed_region``, spread over surviving regions.

    Without a topology: capacity-aware round-robin (fills the freest regions
    first).  With one (``driver.topology``): distance-tiered — victims spread
    round-robin across the *nearest* surviving tier until its capacity is
    exhausted, then the next tier, so an evacuation prefers fast local links
    and only touches far (e.g. CXL) regions when the near ones are full.

    Blocks already claimed by a live request (queued, copying, or awaiting a
    verdict) are not victims: admission would deduplicate them anyway, but
    planning for them would consume surviving capacity they do not need —
    enough, when the evacuation is already in flight, to spuriously exhaust
    the plan.  Excluding them makes :func:`drain_region` idempotent: a
    second call (or a call on an empty/already-draining region) plans only
    the blocks that still genuinely sit on the failed region unclaimed.
    """
    placement = driver.host_placement()
    victims = np.nonzero(placement == failed_region)[0].astype(np.int32)
    if len(victims):
        victims = victims[~driver.in_migration(victims)]
    n_regions = driver.pool_cfg.n_regions
    survivors = [r for r in range(n_regions) if r != failed_region]
    free = {r: driver.free_slots(r) for r in survivors}
    plan: dict[int, list[int]] = {r: [] for r in survivors}
    topo = driver.topology
    if topo is None:
        tiers = [sorted(survivors, key=lambda r: -free[r])]
    else:
        by_dist: dict[int, list[int]] = {}
        for r in survivors:
            by_dist.setdefault(topo.link_cost(failed_region, r), []).append(r)
        tiers = [
            sorted(by_dist[d], key=lambda r: -free[r]) for d in sorted(by_dist)
        ]
    ti, i = 0, 0
    for b in victims:
        placed = False
        while ti < len(tiers) and not placed:
            order = tiers[ti]
            for _ in range(len(order)):
                r = order[i % len(order)]
                i += 1
                if free[r] > len(plan[r]):
                    plan[r].append(int(b))
                    placed = True
                    break
            else:
                ti, i = ti + 1, 0  # tier full: fall through to the next one
        if not placed:
            raise RuntimeError("not enough surviving capacity to drain region")
    return {r: np.asarray(v, np.int32) for r, v in plan.items() if v}


def drain_region(
    driver: MigrationDriver, failed_region: int, scheduler=None
) -> int:
    """Request evacuation of every block on ``failed_region``; returns count.

    Evacuations are submitted at :data:`DRAIN_PRIORITY` so they overtake any
    routine migration traffic already queued.  ``scheduler`` selects the
    migration policy for the evacuation itself (the
    :class:`repro_torch.core.pipeline.SchedulerPolicy` seam): None inherits the
    driver's policy (reliable async epochs by default); ``"sync"`` — for a
    region that is about to go away *now* — escalates every area straight to
    the atomic force program, trading copy pacing for the shortest possible
    evacuation.
    """
    session = driver.default_session()
    ticket = None
    if scheduler is not None:
        ticket = make_scheduler(scheduler).admission_ticket()
        # An evacuation must move EVERY block: never skip busy ones (the
        # sync policy's EBUSY semantics would strand them on a dying region).
        # And never zero-fill: survivors' destinations are pre-faulted pooled
        # slots, so the move_pages() fresh-allocation pass would only add a
        # pointless device write per block to an evacuation we want short.
        ticket = dataclasses.replace(ticket, skip_busy=False, fresh_alloc=False)
    plan = drain_plan(driver, failed_region)
    n = 0
    for dst, ids in plan.items():
        n += session.leap(
            ids, dst, priority=DRAIN_PRIORITY, ticket=ticket
        ).requested
    return n


def spread_plan(driver: MigrationDriver, new_region: int, frac: float | None = None):
    """On grow: move a fair share of blocks onto the new region."""
    placement = driver.host_placement()
    n_regions = driver.pool_cfg.n_regions
    frac = frac if frac is not None else 1.0 / n_regions
    take = []
    for r in range(n_regions):
        if r == new_region:
            continue
        mine = np.nonzero(placement == r)[0]
        k = int(len(mine) * frac)
        take.extend(mine[:k].tolist())
    return np.asarray(take, np.int32)


def rebalance_even(driver: MigrationDriver) -> int:
    """Even out block counts across regions (straggler mitigation helper)."""
    session = driver.default_session()
    placement = driver.host_placement()
    n_regions = driver.pool_cfg.n_regions
    counts = np.bincount(placement, minlength=n_regions)
    target = int(np.ceil(counts.sum() / n_regions))
    moved = 0
    for src in np.argsort(-counts):
        excess = counts[src] - target
        if excess <= 0:
            continue
        victims = np.nonzero(placement == src)[0][:excess]
        for dst in np.argsort(counts):
            if counts[dst] >= target or dst == src:
                continue
            room = target - counts[dst]
            ids = victims[:room]
            victims = victims[room:]
            moved += session.leap(ids.astype(np.int32), int(dst)).requested
            counts[dst] += len(ids)
            counts[src] -= len(ids)
            if len(victims) == 0:
                break
    return moved
