"""Verdict stage: harvest commit verdicts, split/demote/credit outcomes.

This stage is the pipeline's ONLY device→host synchronization point.
The commit phase of the megastep returns packed dirty vectors, wrapped in
:class:`~repro_torch.core.queues.VerdictFuture` s inside ``CommitBatch``
records on ``ctx.pending``.  Harvest materializes them opportunistically
(``is_ready()`` first, so a tick never stalls on an unfinished verdict)
or blocking at drain, always at least one tick after the commit was
dispatched: the copy→remap race window of §2 closes asynchronously, off
the tick's critical path.  Everything downstream of the fetch is host-side
bookkeeping over exact mirrors — no further device round-trips.

Per area, the packed vector resolves as: clean blocks remap in the host
mirror and credit their request (or continue to a relay's second hop),
dirty blocks free their reserved slots and requeue smaller (paper §4.2
adaptive splitting), a rejected huge run retries whole or demotes to
small granularity, and cancelled requests drop their dirty remainders
instead of retrying.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.adaptive import Area, demote_area, split_area
from repro_torch.core.pipeline.accounting import AccountingStage
from repro_torch.core.pipeline.context import PipelineContext
from repro_torch.core.pipeline.routing import RoutingStage
from repro_torch.core.state import REGION, SLOT


class VerdictStage:
    def __init__(
        self,
        ctx: PipelineContext,
        routing: RoutingStage,
        accounting: AccountingStage,
    ):
        self.ctx = ctx
        self.routing = routing
        self.accounting = accounting

    # -- harvest -----------------------------------------------------------

    def harvest(self, block: bool) -> None:
        """Process every pending commit verdict already on the host (or all
        of them, synchronizing, when ``block``)."""
        ctx = self.ctx
        if not ctx.pending:
            return
        with ctx.telemetry.stage("verdict.harvest", blocking=block):
            still = []
            for batch in ctx.pending:
                if not (block or batch.verdict.is_ready()):
                    still.append(batch)
                    continue
                # Sync point: materializing the verdict blocks until the
                # device produced it (opportunistic harvests already saw
                # is_ready(), so only block=True pays a real wait here).
                with ctx.telemetry.stage("verdict.sync", blocking=block):
                    packed = batch.verdict.result()
                for area, start, end in zip(batch.areas, batch.offsets, batch.offsets[1:]):
                    self._process(area, packed[start:end])
            ctx.pending = still

    # -- per-area resolution -----------------------------------------------

    def _process(self, area: Area, dirty: np.ndarray) -> None:
        ctx = self.ctx
        if area.huge:
            self._process_huge(area, bool(dirty[0]))
            return
        clean = ~dirty
        ctx.telemetry.request_phase(
            area.request_id, "VERDICT", n=len(area), dirty=int(dirty.sum())
        )
        # Clean blocks: the remap took effect on device; mirror it.
        clean_ids = area.block_ids[clean]
        ctx.remap_host(clean_ids, area.dst_region, area.dst_slots[clean])
        if area.final_dst >= 0 and area.final_dst != area.dst_region:
            # Relay hop committed: the blocks now sit at the intermediate
            # region; queue the (direct) second hop.  The request is only
            # credited when they arrive at the final destination.
            if len(clean_ids) and self.accounting.cancelled(area):
                self.accounting.drop_blocks(area, clean_ids)
            else:
                self.routing.relay_onward(area, clean_ids)
        else:
            ctx.count("blocks_migrated", int(clean.sum()), rid=area.request_id)
            self.accounting.credit(area, committed=int(clean.sum()))
        # Dirty blocks: stale copies; free reserved slots and requeue smaller —
        # unless the owning request was cancelled, in which case the in-flight
        # epoch ends here: drop the dirty remainder instead of retrying.
        n_dirty = int(dirty.sum())
        if n_dirty:
            ctx.count("dirty_rejections", n_dirty, rid=area.request_id)
            ctx.telemetry.request_phase(area.request_id, "RETRY", n=n_dirty)
            ctx.free[area.dst_region].put(area.dst_slots[dirty])
            if self.accounting.cancelled(area):
                self.accounting.drop_blocks(area, area.block_ids[dirty])
                return
            subs = split_area(area, dirty, ctx.cfg.reduction_factor, ctx.cfg.min_area_blocks)
            ctx.count("splits", max(0, len(subs) - 1))
            ctx.queue.extend(subs)

    def _process_huge(self, area: Area, is_dirty: bool) -> None:
        """Huge commits are all-or-nothing: remap the run, or retry/demote."""
        ctx = self.ctx
        G = ctx.pool_cfg.huge_factor
        g = int(area.block_ids[0]) // G
        ctx.telemetry.request_phase(
            area.request_id, "VERDICT", n=G, dirty=G if is_dirty else 0, huge=True
        )
        if not is_dirty:
            ids = area.block_ids
            old_region = int(ctx.table[ids[0], REGION])
            old_start = int(ctx.table[ids[0], SLOT])
            ctx.free[old_region].free_run(old_start)
            ctx.table[ids, REGION] = area.dst_region
            ctx.table[ids, SLOT] = area.dst_slots
            ctx.migrating[ids] = False
            ctx.tiers.relocate(g, area.dst_region, int(area.dst_slots[0]))
            ctx.count("blocks_migrated", G, rid=area.request_id, huge=True)
            ctx.count("huge_areas_committed", 1, group=g)
            self.accounting.credit(area, committed=G)
            return
        # Rejected: a member was written during the run's copy epoch.  Free
        # the reserved destination run and either retry the run whole or —
        # after demote_after_attempts rejections (sustained write pressure) —
        # split the huge block and retry at small granularity (paper §4.2).
        ctx.count("dirty_rejections", G, rid=area.request_id, huge=True)
        ctx.telemetry.request_phase(area.request_id, "RETRY", n=G, huge=True)
        ctx.free[area.dst_region].free_run(int(area.dst_slots[0]))
        area.attempts += 1
        area.dst_slots = None
        if self.accounting.cancelled(area):
            self.accounting.drop_blocks(area, area.block_ids)
            return
        if area.attempts >= ctx.cfg.demote_after_attempts:
            ctx.demote_group(g)
            subs = demote_area(area, ctx.cfg.reduction_factor, ctx.cfg.min_area_blocks)
            ctx.count("splits", max(0, len(subs) - 1))
            ctx.queue.extend(subs)
        else:
            ctx.queue.append(area)


