"""`LeapSession`: the handle-based public API over a migration driver.

The paper's `page_leap()` contract — *returns control immediately and
guarantees eventual migration* — needs a caller-visible object per request:
something to observe (status/progress), to wait on, and to cancel.  The
session is the factory for those :class:`LeapHandle` futures, the host of
the sealed read-only :class:`PoolFacade`, and the injection point for
pluggable :class:`PlacementPolicy` objects (`apply`).

One driver, many possible sessions: handles are backed by the driver's own
request registry, so every session over the same driver sees a consistent
world.  ``MigrationDriver.default_session()`` returns a cached one.
"""

from __future__ import annotations

import numpy as np

from repro_torch.api.facade import PoolFacade
from repro_torch.api.handle import LeapHandle
from repro_torch.api.policy import Move, MoveLike, PlacementPolicy, as_move
from repro_torch.obs import TelemetryView
from repro_torch.topology import spill_assignments


class LeapSession:
    """Handle-based migration API: request futures over one driver."""

    def __init__(self, driver):
        self.driver = driver
        self.facade = PoolFacade(driver)
        self._handles: list[LeapHandle] = []

    # -- requests ----------------------------------------------------------

    def leap(
        self,
        block_ids,
        dst_region: int,
        priority: int = 0,
        on_done=None,
        tag=None,
        ticket=None,
    ) -> LeapHandle:
        """Asynchronously migrate ``block_ids`` to ``dst_region``.

        Returns immediately with a :class:`LeapHandle`.  Blocks already at
        the destination or already claimed by an earlier live request are
        deduplicated away — the handle accounts only for blocks it enqueued
        (``handle.requested``), and a fully-deduplicated request completes
        instantly.  Higher ``priority`` requests drain strictly first.
        ``on_done(handle)`` fires when the request resolves.  ``ticket`` (a
        :class:`repro.core.pipeline.AdmissionTicket`) overrides the driver
        scheduler-policy's admission stamp for this one request — e.g. an
        urgent evacuation escalates straight to the atomic force program.
        """
        req = self.driver.submit(
            block_ids, dst_region, priority=priority, ticket=ticket
        )
        handle = LeapHandle(self.driver, req, tag=tag)
        if on_done is not None:
            handle.on_done(on_done)
        # Track live handles only (callers hold their own references), so a
        # long-running session does not accumulate one entry per request.
        self._handles = [h for h in self._handles if not h.done]
        if not handle.done:
            self._handles.append(handle)
        return handle

    def apply(
        self, policy: PlacementPolicy, priority: int = 0, reroute: bool = True
    ) -> list[LeapHandle]:
        """Run a placement policy: one tracked request per returned move.

        ``priority`` is the default for moves whose own priority is None
        (an explicit 0 on a move is honored).  When the pool has a
        :class:`repro.topology.NumaTopology` attached and ``reroute`` is on,
        moves whose destination lacks free capacity spill their overflow to
        the nearest regions (by distance from the intended destination) that
        still have room, instead of stalling behind a full region — so one
        move may fan out into SEVERAL handles (every sub-move inherits the
        move's ``tag``, which is the stable join key back to the policy's
        decision; a fully-satisfied move still yields one instantly-complete
        handle).  Without a topology, handles map 1:1 onto moves.
        """
        moves = [as_move(m) for m in policy.decide(self.facade)]
        if reroute and self.facade.topology is not None:
            moves = self._reroute_moves(moves)
        handles = []
        for move in moves:
            handles.append(
                self.leap(
                    move.block_ids,
                    move.dst_region,
                    priority=priority if move.priority is None else move.priority,
                    tag=move.tag,
                )
            )
        return handles

    def _reroute_moves(self, moves: list[Move]) -> list[Move]:
        """Topology-aware capacity spill: keep each move's intent, divert the
        blocks its destination cannot hold to the nearest region with room
        (never to one farther from the destination than where a block
        already sits — see :func:`repro.topology.spill_assignments`)."""
        topo = self.facade.topology
        spare = {
            r: self.facade.free_slots(r) for r in range(self.facade.n_regions)
        }
        out: list[Move] = []
        for move in moves:
            ids = np.asarray(move.block_ids, dtype=np.int32)
            regions = (
                np.asarray(self.facade.region_of(ids))
                if len(ids)
                else np.zeros(0, np.int32)
            )
            away = regions != move.dst_region
            assigned, leftover = spill_assignments(
                topo, ids[away], regions[away], move.dst_region, spare
            )
            # The primary move keeps everything meant for the destination:
            # the capacity grant, blocks already home (vacuous to the driver
            # but observed by the handle), and leftovers no region improves
            # on — those wait for capacity via the driver's blocked-area
            # logic.  Spills become sibling moves sharing the move's tag.
            primary = np.concatenate(
                [ids[~away], leftover]
                + [s for s, r in assigned if r == move.dst_region]
            ).astype(np.int32)
            spills = [(s, r) for s, r in assigned if r != move.dst_region]
            if len(primary) or not spills:
                out.append(_submove(move, primary, move.dst_region))
            for sub_ids, region in spills:
                out.append(_submove(move, sub_ids, region))
        return out

    def submit_moves(
        self, moves: list[MoveLike], priority: int = 0, reroute: bool = True
    ) -> list[LeapHandle]:
        """Like :meth:`apply` for an explicit move list.  ``reroute=False``
        pins every move to its stated destination (wait for capacity there
        instead of spilling to near regions)."""
        return self.apply(_StaticPolicy(moves), priority=priority, reroute=reroute)

    # -- driving the migration loop ---------------------------------------

    def tick(self) -> None:
        """One asynchronous migration slice (see ``MigrationDriver.tick``)."""
        self.driver.tick()

    def poll(self, block: bool = False) -> None:
        """Harvest commit verdicts that are ready (or all, if ``block``)."""
        self.driver.poll(block=block)

    def drain(self, max_ticks: int = 100_000) -> bool:
        """Run ticks until every live request resolved (or budget ends)."""
        ticks = 0
        while not self.driver.done and ticks < max_ticks:
            self.driver.tick()
            self.driver.poll(block=True)
            ticks += 1
        return self.driver.done

    # -- introspection -----------------------------------------------------

    def telemetry(self) -> TelemetryView:
        """Telemetry accessor for this session's driver: buffered events,
        exact counters, request spans, metrics (JSON / Prometheus text),
        Chrome trace export.  Always usable — with ``LeapConfig.telemetry``
        off it reports ``enabled=False`` and empty data.  Delegates to the
        facade, which attaches the tier-residency gauges when the pool has
        a topology."""
        return self.facade.telemetry()

    @property
    def done(self) -> bool:
        return self.driver.done

    @property
    def handles(self) -> tuple[LeapHandle, ...]:
        """This session's handles that were live at last issue (newest last);
        terminal handles are pruned — keep your own reference to a handle
        you want to consult after completion."""
        return tuple(self._handles)

    def live_handles(self) -> list[LeapHandle]:
        return [h for h in self._handles if not h.done]


def _submove(move: Move, block_ids, dst_region: int) -> Move:
    """A copy of ``move`` with new block ids / destination (tag and priority
    preserved, so spilled sub-moves stay attributable to their origin)."""
    return Move(
        np.asarray(block_ids, dtype=np.int32),
        int(dst_region),
        priority=move.priority,
        tag=move.tag,
    )


class _StaticPolicy:
    """Adapter: a fixed move list as a PlacementPolicy."""

    def __init__(self, moves):
        self._moves = list(moves)

    def decide(self, facade):
        return self._moves
