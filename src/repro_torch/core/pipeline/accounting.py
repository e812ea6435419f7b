"""Accounting stage: per-request credit, cancellation state, callbacks.

The single writer of :class:`repro.core.stats.RequestState` records.  Every
block a request enqueued terminates in exactly one bucket — committed,
forced, or cancelled — and the invariant ``committed + forced + cancelled
== requested`` is enforced here by construction: dispatch and verdict report
outcomes, this stage credits them and fires completion callbacks (which is
what :class:`repro.api.LeapHandle` futures observe).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.adaptive import Area
from repro_torch.core.pipeline.context import PipelineContext
from repro_torch.core.stats import RequestState


class AccountingStage:
    def __init__(self, ctx: PipelineContext):
        self.ctx = ctx

    # -- registry ----------------------------------------------------------

    def register(self, dst_region: int, priority: int = 0, callbacks=()) -> RequestState:
        """Mint the accounting record for a new request."""
        ctx = self.ctx
        rid = ctx.next_rid
        ctx.next_rid += 1
        req = RequestState(rid=rid, dst_region=dst_region, priority=priority)
        req.callbacks.extend(callbacks)
        ctx.requests[rid] = req
        ctx.telemetry.request_submitted(rid, dst_region, priority)
        return req

    def get(self, rid: int) -> RequestState | None:
        return self.ctx.requests.get(rid)

    # -- outcome credit ----------------------------------------------------

    def credit(self, area: Area, committed: int = 0, forced: int = 0) -> None:
        req = self.ctx.requests.get(area.request_id)
        if req is None:
            return
        req.committed += committed
        req.forced += forced
        if req.done:
            self.fire_callbacks(req)

    def cancelled(self, area: Area) -> bool:
        """True when the area's owning request asked to cancel."""
        req = self.ctx.requests.get(area.request_id)
        return req is not None and req.cancel_requested

    def drop_blocks(self, area: Area, ids: np.ndarray) -> None:
        """Abandon blocks of a cancelled request mid-flight: their reserved
        destination slots are already returned by the caller; clear the open
        marks and account them as cancelled."""
        ctx = self.ctx
        ctx.migrating[ids] = False
        ctx.count("blocks_cancelled", len(ids), rid=area.request_id)
        req = ctx.requests.get(area.request_id)
        if req is None:
            return
        req.cancelled += len(ids)
        if req.done:
            self.fire_callbacks(req)

    def drop_queued(self, req: RequestState, n: int) -> None:
        """Account ``n`` blocks dropped straight out of the queue (cancel)."""
        if n:
            req.cancelled += n
            self.ctx.count("blocks_cancelled", n, rid=req.rid)
        if req.done:
            self.fire_callbacks(req)

    # -- completion --------------------------------------------------------

    def finish_if_done(self, req: RequestState) -> None:
        if req.done:
            self.fire_callbacks(req)

    def fire_callbacks(self, req: RequestState) -> None:
        # The request is terminal: fire callbacks and prune it from the
        # registry so a long-running server does not accumulate one record
        # per request forever.  Handles keep working — they hold the
        # RequestState object itself, not the registry entry.
        self.ctx.telemetry.request_resolved(
            req.rid, req.committed, req.forced, req.cancelled, req.requested
        )
        callbacks, req.callbacks = list(req.callbacks), []
        for cb in callbacks:
            cb(req)
        self.ctx.requests.pop(req.rid, None)
