"""Sealed read-only view of a migration driver.

Everything a caller outside :mod:`repro.core` may observe lives here:
placement, per-region free capacity, and statistics — all returned as copies
or scalars, never as live driver structures.  The facade is *sealed*:
instances reject attribute assignment, and there is deliberately no way to
reach the mutable mirrors (``benchmarks``/``examples`` are tested to import
no ``_``-prefixed driver attributes).
"""

from __future__ import annotations

import numpy as np


class PoolFacade:
    """Read-only observation surface over a :class:`MigrationDriver`."""

    __slots__ = ("_driver",)

    def __init__(self, driver):
        object.__setattr__(self, "_driver", driver)

    def __setattr__(self, name, value):
        raise AttributeError("PoolFacade is sealed (read-only)")

    def __delattr__(self, name):
        raise AttributeError("PoolFacade is sealed (read-only)")

    # -- placement ---------------------------------------------------------

    def placement(self) -> np.ndarray:
        """Region of every logical block (copy of the exact host mirror)."""
        return self._driver.host_placement()

    def table(self) -> np.ndarray:
        """Copy of the block table ``[n_blocks, (region, slot)]``."""
        return self._driver.host_table()

    def region_of(self, block_ids) -> np.ndarray | int:
        """Current region of ``block_ids`` (scalar in, scalar out; O(k))."""
        if np.isscalar(block_ids):
            return int(self._driver.regions_of([int(block_ids)])[0])
        return self._driver.regions_of(block_ids)

    def slot_of(self, block_ids) -> np.ndarray | int:
        """Current slot of ``block_ids`` (scalar in, scalar out; O(k))."""
        if np.isscalar(block_ids):
            return int(self._driver.slots_of([int(block_ids)])[0])
        return self._driver.slots_of(block_ids)

    # -- capacity ----------------------------------------------------------

    def free_slots(self, region: int) -> int:
        """Free pooled slots on ``region`` right now."""
        return self._driver.free_slots(region)

    @property
    def n_blocks(self) -> int:
        return self._driver.state.n_blocks

    @property
    def n_regions(self) -> int:
        return self._driver.pool_cfg.n_regions

    @property
    def pool_cfg(self):
        """The pool's static description (a frozen dataclass — safe to share)."""
        return self._driver.pool_cfg

    @property
    def topology(self):
        """The pool's :class:`repro.topology.NumaTopology`, or None (uniform).

        Placement policies read this to prefer cheap links when choosing
        destinations (distance-aware ``decide()``).
        """
        return self._driver.topology

    # -- migration state ---------------------------------------------------

    @property
    def done(self) -> bool:
        return self._driver.done

    @property
    def pending_blocks(self) -> int:
        return self._driver.pending_blocks

    def heat(self) -> np.ndarray:
        """Per-block access heat (copy; all zeros when ``cfg.tiering`` off)."""
        return self._driver.heat_snapshot()

    def snapshot_stats(self):
        """Copy of the driver's :class:`MigrationStats` at this instant
        (deep enough that the per-link dict is independent too)."""
        return self._driver.stats.snapshot()

    def telemetry(self):
        """Read-only :class:`repro.obs.TelemetryView` over the driver's
        recorder.  Everything it returns is a copy or fresh rendering, so
        the facade stays a pure observation surface.  On a pool with a
        topology the view carries the ``tier_resident_bytes{tier=near|far}``
        residency gauges (extras stack, so callers may add their own)."""
        from repro_torch.obs import TelemetryView  # deferred: keep facade import-light

        view = TelemetryView(
            self._driver.telemetry, lambda: self._driver.stats.snapshot()
        )
        if self._driver.topology is not None:
            from repro_torch.tiering import residency_extra

            view = view.with_extra(residency_extra(self._driver))
        return view

    # -- debug invariants (read-only checks; safe to expose) ---------------

    def verify_mirror(self) -> bool:
        return self._driver.verify_mirror()

    def verify_tiers(self) -> bool:
        return self._driver.verify_tiers()
