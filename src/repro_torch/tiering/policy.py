"""Closed-loop hot/cold tiering policy over the access-heat plane.

The missing piece between the engine's sampling plane and its migration
machinery: the device-maintained per-block heat
(``MigrationDriver.heat_snapshot``, which the ``heat_scan`` kernel updates
as the megastep's trailing phase, or as its own program under the batched
and legacy generations) feeds an epoch-driven :class:`TieringPolicy` that

* **promotes** hot blocks resident on the far (CXL-pooled) tier toward the
  compute-near regions, and
* **demotes** cold blocks — on a two-tier pool, only whole G-aligned *runs*
  whose every member is cold, so a demoted huge block stays promotable —
  out to the far tier,

with per-block hysteresis: a block only moves when its heat crosses the
high/low watermark AND its cooldown window since the last policy move has
expired.  Ping-ponging blocks (heat oscillating around a watermark) are
therefore pinned for ``cooldown_ticks`` instead of bouncing across the
expander link every epoch — the failure mode
``MigrationStats.ping_pong_migrations`` meters.

The policy is a plain :class:`repro_torch.api.PlacementPolicy`: each epoch,
``session.apply(policy)`` turns its decisions into tracked leap requests
(with topology-aware capacity spill), and the engine's normal copy/commit/
verdict pipeline — including the huge-run programs for G-aligned demotions —
does the moving.

Reading the heat plane is the one host sync of an epoch (a copy of the
plane to the host, once every ``epoch_ticks``); the ticks in between never
wait for the device on the policy's account.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.api.policy import Move


def split_tiers(
    topology, near=None, far=None
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Partition a topology's regions into (near, far) tiers.

    Explicit ``near``/``far`` sequences win.  Otherwise a region is *far*
    when even its cheapest link costs more than the machine's fastest
    inter-region link (``min_link_distance``) — on
    :meth:`NumaTopology.cxl_pooled` exactly the expander-attached regions.
    A uniform mesh has no far tier (everything is near).
    """
    if near is not None or far is not None:
        near = tuple(near or ())
        far = tuple(far or ())
        if not near:
            near = tuple(r for r in range(topology.n_regions) if r not in set(far))
        if not far:
            far = tuple(r for r in range(topology.n_regions) if r not in set(near))
        return near, far
    r = topology.n_regions
    ref = topology.min_link_distance
    off = ~np.eye(r, dtype=bool)
    far = tuple(
        int(i) for i in range(r) if int(topology.distance[i][off[i]].min()) > ref
    )
    near = tuple(i for i in range(r) if i not in set(far))
    return near, far


@dataclasses.dataclass(frozen=True)
class TieringConfig:
    """Watermarks and hysteresis of the closed-loop tiering policy."""

    hot_watermark: float = 2.0  # promote far blocks whose heat >= this
    cold_watermark: float = 0.25  # demote near blocks whose heat <= this
    # Hysteresis: a block the policy moved is pinned for this many ticks —
    # the knob that separates closed-loop tiering from the autonuma-style
    # samplers on ping-pong churn.
    cooldown_ticks: int = 32
    epoch_ticks: int = 8  # decide() cadence via maybe_apply()
    max_promotions: int = 16  # blocks promoted per epoch
    max_demotions: int = 16  # move units (blocks, or G-runs) demoted per epoch
    # Explicit tier override (defaults: derived from the topology).
    near: tuple | None = None
    far: tuple | None = None


class TieringPolicy:
    """Epoch-driven promotion/demotion over the device heat plane."""

    name = "tiering"

    def __init__(self, driver, cfg: TieringConfig | None = None):
        self.driver = driver
        self.cfg = cfg or TieringConfig()
        n = driver.state.n_blocks
        self._last_moved = np.full(n, -(1 << 40), dtype=np.int64)
        # First epoch fires one full epoch after construction: the policy
        # observes heat before acting (a zero-heat plane reads as uniformly
        # cold, and demoting on it would exile the live working set).
        self._last_epoch = driver.stats.ticks

    # -- PlacementPolicy ---------------------------------------------------

    def decide(self, facade) -> list[Move]:
        topo = facade.topology
        if topo is None:
            return []
        near, far = split_tiers(topo, self.cfg.near, self.cfg.far)
        if not near or not far:
            return []
        cfg = self.cfg
        drv = self.driver
        heat = drv.heat_snapshot()
        placement = facade.placement()
        now = drv.stats.ticks
        n = len(placement)
        movable = ~drv.in_migration(np.arange(n))
        movable &= (now - self._last_moved) >= cfg.cooldown_ticks

        moves: list[Move] = []
        moved: list[np.ndarray] = []

        # -- promotion: hottest far-resident blocks toward the near tier ---
        in_far = np.isin(placement, far)
        cand = np.nonzero(in_far & movable & (heat >= cfg.hot_watermark))[0]
        if len(cand) > cfg.max_promotions:
            cand = cand[np.argsort(-heat[cand], kind="stable")[: cfg.max_promotions]]
        if len(cand):
            by_dst: dict[int, list[int]] = {}
            for b in cand:
                src = int(placement[b])
                dst = next(r for r in topo.nearest(src) if r in near)
                by_dst.setdefault(dst, []).append(int(b))
            for dst, ids in sorted(by_dst.items()):
                ids = np.asarray(ids, np.int32)
                moves.append(Move(ids, dst, tag="tier-promote"))
                moved.append(ids)
            drv.ctx.count("tier_promotions", len(cand))

        # -- demotion: coldest near-resident blocks (aligned runs) out -----
        in_near = np.isin(placement, near)
        cold = in_near & movable & (heat <= cfg.cold_watermark)
        demote_ids = self._demotion_units(cold, facade)
        if len(demote_ids):
            dst = max(far, key=facade.free_slots)
            ids = np.asarray(demote_ids, np.int32)
            moves.append(Move(ids, int(dst), tag="tier-demote"))
            moved.append(ids)
            drv.ctx.count("tier_demotions", len(ids))

        if moved:
            self._last_moved[np.concatenate(moved)] = now
        return moves

    def _demotion_units(self, cold: np.ndarray, facade) -> list[int]:
        """Pick the blocks to demote this epoch.

        On a two-tier pool (``huge_factor`` G > 1) only whole G-aligned
        groups whose EVERY member is cold demote — the run moves through the
        contiguous-run copy path and stays alignable/promotable at the far
        tier; a half-hot group keeps all members near.  Small-only pools
        demote per block.
        """
        g = facade.pool_cfg.huge_factor
        cap = self.cfg.max_demotions
        if g <= 1:
            return [int(b) for b in np.nonzero(cold)[0][:cap]]
        groups = np.nonzero(cold.reshape(-1, g).all(axis=1))[0][:cap]
        return [int(b) for grp in groups for b in range(grp * g, (grp + 1) * g)]

    # -- epoch driving -----------------------------------------------------

    def maybe_apply(self, session, priority: int = 0) -> list:
        """Run one tiering epoch if ``epoch_ticks`` have elapsed.

        Call once per tick from the application loop; returns the epoch's
        handles (empty off-epoch).  ``session.apply`` routes the moves with
        topology-aware capacity spill, so a full near region degrades to
        the next-nearest region instead of stalling.
        """
        now = self.driver.stats.ticks
        if now - self._last_epoch < self.cfg.epoch_ticks:
            return []
        self._last_epoch = now
        return session.apply(self, priority=priority)


def residency_extra(driver):
    """Telemetry hook: per-tier resident-byte gauges for one driver.

    Returns an ``extra_fn`` for :meth:`repro_torch.obs.TelemetryView.with_extra`
    that sets ``tier_resident_bytes{tier=near|far}`` (plus per-tier block
    counts) from the live placement.  With no topology attached the driver
    has no tiers and the hook adds nothing.
    """

    def extra(reg) -> None:
        topo = driver.topology
        if topo is None:
            return
        near, far = split_tiers(topo)
        placement = driver.host_placement()
        bb = driver.pool_cfg.block_bytes
        n_near = int(np.isin(placement, near).sum())
        n_far = int(np.isin(placement, far).sum())
        reg.gauge("tier_resident_bytes", n_near * bb, labels={"tier": "near"})
        reg.gauge("tier_resident_bytes", n_far * bb, labels={"tier": "far"})
        reg.gauge("tier_resident_blocks", n_near, labels={"tier": "near"})
        reg.gauge("tier_resident_blocks", n_far, labels={"tier": "far"})

    return extra
