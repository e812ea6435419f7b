"""Standing invariants of the migration engine, checked as one unit.

Every suite used to assert its own ad-hoc subset of these (slot counts
here, mirror equality there, payload equality somewhere else); the checker
centralizes the full set so the chaos harness, the property suites, and
the baseline tests all enforce the same conservation/integrity rules:

  slots       Per region, the free list, the table-resident slots, the
              destination slots reserved by open/pending epochs, and the
              force-freed quarantine *partition* ``[0, slots_per_region)``
              — conservation and no-double-allocation in one check.
  accounting  Per live request, ``committed + forced + cancelled +
              remaining == requested`` with ``remaining`` equal to the
              blocks the request still has in the pipeline; one area per
              block; the ``migrating`` mask is exactly the union of
              in-pipeline areas; globally, ``migrated + forced + cancelled
              + in-pipeline == requested``.
  mirrors     Host table mirror == device table; two-level (huge) table
              consistent with the flat mirror; every buddy allocator's
              internal invariants; device ``in_flight`` only on blocks the
              host tracks as migrating.
  payload     Every block reads back exactly the shadow copy (updated in
              lockstep with ``driver.write``; compared on the pool's
              device) — the check that catches
              *silent* corruption the structural invariants cannot see
              (e.g. the pre-quarantine same-tick slot-reuse bug, where the
              mirrors stayed exact while payloads read back as zeros).
  tiering_hysteresis
              (:class:`HysteresisMonitor`, armed by scenarios where the
              tiering policy is the only migration source) No block changes
              region more than ``max_moves`` times inside any ``window``-
              tick span without an intervening *phase shift* — a hot-set
              rotation or a fault event, both of which legitimately re-tier
              blocks and reset the history.  Catches a broken cooldown: the
              ping-pong churn :class:`TieringConfig.cooldown_ticks` exists
              to prevent.

Violations raise :class:`InvariantViolation` (an ``AssertionError``
subclass, so plain pytest suites can use the checker directly).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import REGION, SLOT


class InvariantViolation(AssertionError):
    """A standing invariant does not hold.  ``invariant`` names which."""

    def __init__(self, invariant: str, message: str):
        self.invariant = invariant
        super().__init__(f"[{invariant}] {message}")


class HysteresisMonitor:
    """Standing ``tiering_hysteresis`` invariant over observed placement.

    Feed it the live placement once per tick (:meth:`observe` diffs against
    the previous tick to detect migrations) and call :meth:`phase_shift`
    whenever the workload legitimately re-tiers blocks — a hot-set rotation
    or a fault event — which clears the per-block move history.  Between
    phase shifts, a block accumulating more than ``max_moves`` moves within
    the trailing ``window`` ticks is ping-ponging: the policy's cooldown
    bounds moves to ``(window - 1) // cooldown_ticks + 1``, so callers set
    ``max_moves`` to that bound plus slack for one in-flight fault landing.
    """

    def __init__(self, placement: np.ndarray, window: int = 32, max_moves: int = 4):
        self.window = int(window)
        self.max_moves = int(max_moves)
        self._prev = np.asarray(placement).copy()
        self._moves: dict[int, list[int]] = {}

    def phase_shift(self) -> None:
        self._moves.clear()

    def observe(self, tick: int, placement: np.ndarray) -> None:
        placement = np.asarray(placement)
        moved = np.nonzero(placement != self._prev)[0]
        self._prev = placement.copy()
        for b in moved:
            ticks = self._moves.setdefault(int(b), [])
            ticks.append(int(tick))
            while ticks and ticks[0] <= tick - self.window:
                ticks.pop(0)
            if len(ticks) > self.max_moves:
                raise InvariantViolation(
                    "tiering_hysteresis",
                    f"block {int(b)} migrated {len(ticks)} times within "
                    f"{self.window} ticks (at {ticks}) with no intervening "
                    f"phase shift — cooldown hysteresis is not holding",
                )


class InvariantChecker:
    """Checks the standing invariants of one :class:`MigrationDriver`.

    ``shadow`` is the optional ground-truth payload ``[n_blocks,
    *block_shape]``, a numpy array or a tensor (on the pool's device, the
    payload check never copies it); callers who route writes through the
    checker's driver must update it in lockstep (the chaos driver does).
    Without a shadow, :meth:`check_payload` accepts an explicit ``expected``
    array instead.
    """

    def __init__(self, driver, shadow=None):
        self.driver = driver
        self.shadow = shadow
        self.checks_run = 0

    # -- slot conservation -------------------------------------------------

    def check_slots(self) -> None:
        """Free + resident + reserved + quarantined partition every region."""
        snap = self.driver.introspect()
        per_region: dict[int, list[np.ndarray]] = {
            r: [snap.free_slots[r]] for r in range(snap.n_regions)
        }
        for r in range(snap.n_regions):
            resident = snap.table[snap.table[:, REGION] == r, SLOT]
            per_region[r].append(resident.astype(np.int32))
            per_region[r].append(snap.reserved_slots(r))
        for region, slot in snap.quarantined:
            per_region[int(region)].append(np.asarray([slot], np.int32))
        for r in range(snap.n_regions):
            occupancy = np.sort(np.concatenate(per_region[r]))
            want = np.arange(snap.slots_per_region, dtype=occupancy.dtype)
            if occupancy.shape == want.shape and (occupancy == want).all():
                continue
            counts = np.bincount(occupancy, minlength=snap.slots_per_region)
            dup = np.nonzero(counts > 1)[0]
            missing = np.nonzero(counts[: snap.slots_per_region] == 0)[0]
            raise InvariantViolation(
                "slots",
                f"region {r}: free+resident+reserved+quarantined must "
                f"partition [0, {snap.slots_per_region}); "
                f"double-allocated={dup.tolist()} leaked={missing.tolist()}",
            )

    # -- request accounting ------------------------------------------------

    def check_accounting(self, require_closed: bool = False) -> None:
        snap = self.driver.introspect()
        # One area per block: no block may be claimed twice.
        claimed = np.zeros(snap.n_blocks, dtype=bool)
        in_pipeline: dict[int, int] = {}
        for area in snap.areas:
            if claimed[area.block_ids].any():
                twice = area.block_ids[claimed[area.block_ids]]
                raise InvariantViolation(
                    "accounting", f"blocks {twice.tolist()} appear in two areas"
                )
            claimed[area.block_ids] = True
            in_pipeline[area.request_id] = in_pipeline.get(area.request_id, 0) + len(area)
        # The open-request mask is exactly the union of in-pipeline areas.
        if not np.array_equal(claimed, snap.migrating):
            diff = np.nonzero(claimed != snap.migrating)[0]
            raise InvariantViolation(
                "accounting",
                f"migrating mask disagrees with in-pipeline areas at blocks "
                f"{diff.tolist()}",
            )
        # Per live request: every enqueued block is credited or in-pipeline.
        for rid, req in self.driver.requests.items():
            if req.committed + req.forced + req.cancelled + req.remaining != req.requested:
                raise InvariantViolation(
                    "accounting",
                    f"request {rid}: committed {req.committed} + forced "
                    f"{req.forced} + cancelled {req.cancelled} + remaining "
                    f"{req.remaining} != requested {req.requested}",
                )
            if req.remaining < 0:
                raise InvariantViolation(
                    "accounting", f"request {rid}: negative remaining {req.remaining}"
                )
            if req.remaining != in_pipeline.get(rid, 0):
                raise InvariantViolation(
                    "accounting",
                    f"request {rid}: remaining {req.remaining} but "
                    f"{in_pipeline.get(rid, 0)} blocks in pipeline",
                )
        # Global closure: every requested block is resolved or in-pipeline.
        s = self.driver.stats
        open_blocks = int(snap.migrating.sum())
        if s.blocks_migrated + s.blocks_forced + s.blocks_cancelled + open_blocks != s.blocks_requested:
            raise InvariantViolation(
                "accounting",
                f"global: migrated {s.blocks_migrated} + forced "
                f"{s.blocks_forced} + cancelled {s.blocks_cancelled} + open "
                f"{open_blocks} != requested {s.blocks_requested}",
            )
        if require_closed and open_blocks:
            raise InvariantViolation(
                "accounting", f"{open_blocks} blocks still open after drain"
            )

    # -- table-mirror consistency -------------------------------------------

    def check_mirrors(self) -> None:
        """Reads the device table and ``in_flight`` once each: two small
        device-to-host copies a call, whatever the outcome."""
        drv = self.driver
        host = drv.host_table()
        dev = drv.state.table.cpu().numpy()
        if not np.array_equal(host, dev):
            diff = np.nonzero((host != dev).any(axis=1))[0]
            raise InvariantViolation(
                "mirror", f"host table mirror != device table at blocks {diff.tolist()}"
            )
        drv.verify_tiers()  # raises on two-level-table / buddy rot
        # Device epoch flags: a block in flight on device must be host-tracked
        # (the converse is legal — queued areas have no open epoch yet, and
        # committed-but-unharvested batches already cleared the device flag).
        in_flight = drv.state.in_flight.cpu().numpy()
        untracked = np.nonzero(in_flight & ~drv.ctx.migrating)[0]
        if len(untracked):
            raise InvariantViolation(
                "mirror",
                f"device in_flight set on blocks {untracked.tolist()} that "
                f"belong to no live request",
            )

    # -- payload integrity ---------------------------------------------------

    def check_payload(self, expected=None) -> None:
        """Every block against ``expected`` (numpy or a tensor; the chaos
        driver keeps its shadow on the pool's device).  The comparison runs
        where the pool lives; only the ids of mismatching blocks come back
        to the host."""
        expected = self.shadow if expected is None else expected
        if expected is None:
            raise ValueError("check_payload needs a shadow copy or an expected array")
        state = self.driver.state
        n = int(state.n_blocks)
        # note=False: a whole-pool integrity scan is not workload access —
        # letting it feed the heat plane would flatten the very signal the
        # tiering scenarios drive on.
        actual = self.driver.read(np.arange(n), note=False).reshape(n, -1)
        want = torch.as_tensor(expected).to(state.device).reshape(n, -1)
        bad = torch.nonzero((actual != want).any(dim=1)).flatten().cpu().numpy()
        if len(bad):
            raise InvariantViolation(
                "payload",
                f"blocks {bad.tolist()} read back differently from the host "
                f"shadow copy (silent corruption)",
            )

    # -- composites ----------------------------------------------------------

    def check_all(self, expected=None, payload: bool = True) -> None:
        """Every standing invariant; ``payload=False`` skips the (device
        round-trip) payload read for cheap per-tick cadence control."""
        self.checks_run += 1
        self.check_slots()
        self.check_accounting()
        self.check_mirrors()
        if payload and (expected is not None or self.shadow is not None):
            self.check_payload(expected)

    def check_final(self, expected=None) -> None:
        """End-state variant: additionally requires accounting closure
        (no open blocks) — call after a successful drain."""
        self.checks_run += 1
        self.check_slots()
        self.check_accounting(require_closed=True)
        self.check_mirrors()
        if expected is not None or self.shadow is not None:
            self.check_payload(expected)
