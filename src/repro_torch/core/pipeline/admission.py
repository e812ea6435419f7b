"""Admission stage: request decomposition, dedup, huge grouping, cancel.

The pipeline's front door.  ``submit`` turns a caller's block list into
queued areas: deduplicates blocks already home or already claimed by a live
request, groups members of huge blocks into whole-run areas (the level-1
entry is the migration unit, like a huge page), and applies the
:class:`repro.core.pipeline.scheduler.AdmissionTicket` stamps of the active
``SchedulerPolicy`` — the seam where the paper's contenders diverge.
``cancel`` drops a request's not-yet-opened areas slot-leak-free.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.adaptive import Area
from repro_torch.core.pipeline.accounting import AccountingStage
from repro_torch.core.pipeline.context import PipelineContext
from repro_torch.core.pipeline.routing import RoutingStage
from repro_torch.core.pipeline.scheduler import AdmissionTicket
from repro_torch.core.state import REGION, LeapState, as_index
from repro_torch.core.stats import RequestState


def busy_mask(state: LeapState, block_ids) -> torch.Tensor:
    """Device-truth busy check: dirty or under an open copy epoch."""
    ids = as_index(block_ids, state.device)
    return state.dirty[ids] | state.in_flight[ids]


class AdmissionStage:
    def __init__(
        self,
        ctx: PipelineContext,
        routing: RoutingStage,
        accounting: AccountingStage,
    ):
        self.ctx = ctx
        self.routing = routing
        self.accounting = accounting

    # -- submit ------------------------------------------------------------

    def submit(
        self,
        block_ids,
        dst_region: int,
        priority: int = 0,
        callbacks=(),
        ticket: AdmissionTicket | None = None,
    ) -> RequestState:
        """Enqueue migration of ``block_ids`` to ``dst_region`` as one request.

        Blocks already at the destination or already under migration are
        skipped (duplicates within one call are deduplicated — the request
        only accounts for blocks it actually enqueued).  On a tiered pool, a
        request touching any member of a huge block migrates the whole block
        as ONE huge area.  Higher ``priority`` requests drain strictly
        before lower ones.  ``ticket`` overrides the scheduler's default
        admission stamp (escalation / fresh-alloc / skip-busy).
        """
        with self.ctx.telemetry.stage("admission.submit"):
            return self._submit(block_ids, dst_region, priority, callbacks, ticket)

    def _submit(self, block_ids, dst_region, priority, callbacks, ticket) -> RequestState:
        ctx = self.ctx
        if ticket is None:
            ticket = ctx.scheduler.admission_ticket()
        req = self.accounting.register(dst_region, priority, callbacks)
        block_ids = np.unique(np.asarray(block_ids, dtype=np.int32))
        if ticket.skip_busy and len(block_ids):
            busy = busy_mask(ctx.state, block_ids).cpu().numpy()
            block_ids = block_ids[~busy]
        enqueued = 0
        if ctx.tiers is not None:
            hmask = ctx.tiers.is_huge(block_ids)
            if ticket.escalate:
                # Escalated (move_pages()-style) requests split huge mappings
                # first — the kernel's THP-split-on-migration behavior — so
                # every block then takes the small force path with the full
                # ticket semantics (atomic force, zero-fill).  Groups already
                # resident at the destination keep their huge mapping (the
                # request is a no-op for them — nothing to split); groups
                # with a member under migration stay huge too, their members
                # skipped below like any other in-flight block.
                for g in np.unique(ctx.tiers.group_of(block_ids[hmask])):
                    members = ctx.tiers.members(int(g))
                    if int(ctx.table[members[0], REGION]) == dst_region:
                        continue
                    if not ctx.migrating[members].any():
                        ctx.demote_group(int(g))
            else:
                for g in np.unique(ctx.tiers.group_of(block_ids[hmask])):
                    enqueued += self._submit_huge(int(g), dst_region, req.rid, priority)
                block_ids = block_ids[~hmask]
        mask = (ctx.table[block_ids, REGION] != dst_region) & ~ctx.migrating[block_ids]
        block_ids = block_ids[mask]
        if len(block_ids):
            ctx.migrating[block_ids] = True
            ctx.count("blocks_requested", len(block_ids), rid=req.rid)
            # Group by current source region (areas are single-source so the
            # ppermute backend has static endpoints).
            srcs = ctx.table[block_ids, REGION]
            for src in np.unique(srcs):
                ids = block_ids[srcs == src]
                self.routing.enqueue(
                    ids,
                    int(src),
                    dst_region,
                    req.rid,
                    priority,
                    escalate=ticket.escalate,
                    fresh_alloc=ticket.fresh_alloc,
                )
        req.requested = enqueued + len(block_ids)
        ctx.telemetry.request_phase(req.rid, "ADMITTED", n=req.requested)
        self.accounting.finish_if_done(req)
        return req

    def _submit_huge(self, g: int, dst_region: int, rid: int, priority: int) -> int:
        ctx = self.ctx
        members = ctx.tiers.members(g)
        src = int(ctx.table[members[0], REGION])
        if src == dst_region or ctx.migrating[members].any():
            return 0
        ctx.migrating[members] = True
        ctx.count("blocks_requested", len(members), rid=rid, huge=True)
        ctx.queue.append(
            Area(members, src, dst_region, huge=True, request_id=rid, priority=priority)
        )
        ctx.telemetry.request_phase(rid, "ROUTED", n=1, src=src, dst=dst_region, huge=True)
        return len(members)

    # -- cancel ------------------------------------------------------------

    def cancel(self, rid: int) -> int:
        """Cancel request ``rid``: drop its not-yet-opened areas immediately.

        Queued areas hold no destination slots (those are reserved when an
        epoch opens and returned before any requeue), so dropping them only
        clears the open-request marks — ``verify_mirror()`` stays true.
        Areas with an open epoch finish their current copy and commit
        verdict: clean blocks still commit, dirty blocks are dropped instead
        of requeued.  A relay's queued second hop is dropped here too (its
        blocks stay at the intermediate region).  Returns the number of
        blocks dropped right away.
        """
        ctx = self.ctx
        req = ctx.requests.get(rid)
        if req is None or req.cancel_requested:
            return 0  # unknown, already terminal (pruned), or already cancelled
        req.cancel_requested = True
        n = 0
        with ctx.telemetry.stage("admission.cancel", rid=rid):
            for area in ctx.queue.remove_request(rid):
                ctx.migrating[area.block_ids] = False
                n += len(area)
            self.accounting.drop_queued(req, n)
        return n
