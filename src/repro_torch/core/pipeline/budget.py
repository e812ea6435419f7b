"""Budget stage: per-tick pacing and per-link byte/dispatch budgets.

A tick opens one :class:`TickBudget` — the scheduler-policy block budget
plus (with a topology attached) fresh per-link budgets — and the dispatch
stage spends it through the granting methods here.  Congestion deferral is
a budget decision: a grant of 0 tells dispatch to set the area aside and
keep scheduling traffic that crosses other links.  Link *accounting*
(``stats.bytes_per_link``) also lives here and is tracked on every driver,
topology or not, so benchmarks can model link costs post-hoc.

The per-link budgets are backed by one contiguous ``[n_links, 3]`` int32
array (``TickBudget.link_array``); the ``links`` dict maps ``(src, dst)``
to row *views* of it, so the granting methods above mutate the array in
place and :meth:`TickBudget.device_grants` can ship the remaining grants to
the device as a single host->device transfer — the megastep dispatch
generation consumes budgets as precomputed arrays rather than per-grant
host calls (DESIGN.md §12).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.adaptive import Area
from repro_torch.core.pipeline.context import PipelineContext


@dataclasses.dataclass
class TickBudget:
    """One tick's spendable budget: global blocks + per-link [bytes, opens].

    ``links`` maps ``(src, dst)`` to ``[blocks_left, opens_left, cap]`` rows
    that are views into ``link_array`` (one ``[n_links, 3]`` int32 array,
    row order given by ``link_keys``); ``device_grants()`` snapshots the
    remaining grants as a device array.
    """

    blocks: int  # global per-tick block budget left
    links: dict | None  # (src, dst) -> [blocks_left, opens_left, cap] row views
    link_array: np.ndarray | None = None  # [n_links, 3] backing store
    link_keys: tuple = ()  # row i of link_array budgets link link_keys[i]
    device: torch.device | None = None  # where device_grants() lands

    def link(self, src: int, dst: int):
        if self.links is None:
            return None
        return self.links.get((src, dst))

    def device_grants(self) -> torch.Tensor | None:
        """Remaining per-link grants as ONE device tensor (or None when link
        scheduling is off): row i is ``[blocks_left, opens_left]`` for
        ``link_keys[i]``.  A single transfer of the whole budget state —
        device-side consumers never trigger per-grant host round-trips."""
        if self.link_array is None:
            return None
        return torch.from_numpy(self.link_array[:, :2].copy()).to(self.device)


class BudgetStage:
    def __init__(self, ctx: PipelineContext):
        self.ctx = ctx

    # -- opening a tick ----------------------------------------------------

    def open_tick(self) -> TickBudget:
        with self.ctx.telemetry.stage("budget.open_tick"):
            links, arr, keys = self._link_budgets()
            return TickBudget(
                blocks=self.ctx.scheduler.tick_budget(self.ctx.cfg),
                links=links,
                link_array=arr,
                link_keys=keys,
                device=self.ctx.state.device,
            )

    def _link_budgets(self):
        """Fresh per-tick link budgets, array-backed.

        Returns ``(links, arr, keys)``: ``arr`` is one ``[n_links, 3]``
        int32 array of ``[blocks_left, opens_left, cap]`` rows (cap = the
        untouched per-tick block budget, so the huge path can recognize a
        link nothing else used this tick); ``links`` maps ``(src, dst)`` to
        row views of it; ``keys`` fixes the row order.  ``(None, None, ())``
        when link scheduling is off (no topology / disabled).
        """
        topo = self.ctx.topology
        cfg = self.ctx.cfg
        if topo is None or not cfg.link_schedule:
            return None, None, ()
        unit = cfg.link_blocks_per_tick
        if unit is None:
            unit = cfg.budget_blocks_per_tick
        # SchedulerPolicy hook (optional): a deadline-aware policy scales the
        # per-link unit tick by tick, yielding link bandwidth to application
        # traffic when SLO slack shrinks (see SloScheduler.link_unit).
        link_unit = getattr(self.ctx.scheduler, "link_unit", None)
        if link_unit is not None:
            unit = link_unit(cfg, unit)
        n = self.ctx.pool_cfg.n_regions
        keys = tuple((s, d) for s in range(n) for d in range(n) if s != d)
        arr = np.zeros((len(keys), 3), dtype=np.int32)
        budgets: dict[tuple[int, int], np.ndarray] = {}
        for i, (s, d) in enumerate(keys):
            cap = topo.link_blocks(s, d, unit)
            arr[i] = (cap, int(topo.concurrency[s, d]), cap)
            budgets[(s, d)] = arr[i]  # row VIEW: grants mutate arr in place
        return budgets, arr, keys

    # -- grants (0 = congestion-defer; dispatch sets the area aside) -------

    def grant_copy(self, tb: TickBudget, area: Area, want: int) -> int:
        """Grant up to ``want`` copy blocks on the area's link; 0 = defer."""
        link = tb.link(area.src_region, area.dst_region)
        n = want
        if link is not None:
            # Charge the copy against the link's byte budget; a dry link
            # defers the area's remainder to a later tick, and the loop
            # moves on to areas crossing other links.
            n = min(n, link[0])
            if n == 0:
                self.ctx.count(
                    "deferred_congested", 1, src=area.src_region, dst=area.dst_region
                )
                return 0
            link[0] -= n
        self.charge_link(area.src_region, area.dst_region, n)
        return n

    def grant_huge(self, tb: TickBudget, area: Area, need: int) -> int:
        """Grant a huge block's whole contiguous run, or 0 to defer it whole.

        A huge block copies as ONE contiguous-run move — never chunked,
        whatever the budget has left (it was admitted); a link that cannot
        absorb the whole run defers it whole.  Exception: a run bigger than
        the link's entire per-tick budget may monopolize an untouched link —
        deferring it would starve it forever (the budget resets every tick
        and never reaches the run size); sending it just stretches that tick
        in the hardware model instead.
        """
        link = tb.link(area.src_region, area.dst_region)
        if link is not None and link[0] < need:
            if link[0] == link[2] and need > link[2]:
                link[0] = 0  # whole-tick monopoly of this link
            else:
                self.ctx.count(
                    "deferred_congested", 1, src=area.src_region, dst=area.dst_region
                )
                return 0
        elif link is not None:
            link[0] -= need
        self.charge_link(area.src_region, area.dst_region, need)
        return need

    def may_open(self, tb: TickBudget, area: Area) -> bool:
        """Whether the area's link can absorb a new epoch this tick.

        Opening an epoch on a saturated link would only stretch the
        copy→commit race window; the caller holds the area aside and keeps
        scheduling traffic that crosses other links.
        """
        link = tb.link(area.src_region, area.dst_region)
        if link is not None and (link[0] <= 0 or link[1] <= 0):
            self.ctx.count(
                "deferred_congested", 1, src=area.src_region, dst=area.dst_region
            )
            return False
        return True

    def charge_open(self, tb: TickBudget, area: Area) -> None:
        """Charge the per-link epoch-open budget for a real epoch open (the
        out-of-slots halving path requeues without opening, and forced
        escalations are budget-exempt — callers skip the charge there)."""
        link = tb.link(area.src_region, area.dst_region)
        if link is not None:
            link[1] -= 1

    # -- link accounting (stats only; budgets are charged above) -----------

    def charge_link(self, src: int, dst: int, n_blocks: int) -> None:
        """Account copy traffic to its (src, dst) link."""
        key = (int(src), int(dst))
        stats = self.ctx.stats
        stats.bytes_per_link[key] = (
            stats.bytes_per_link.get(key, 0)
            + n_blocks * self.ctx.pool_cfg.block_bytes
        )
