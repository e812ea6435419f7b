"""Autoscaler-style drain/fill placement over a serving pool.

:class:`RegionAutoscaler` is the consolidation loop a deployment runs
above the engine: when the SLO scheduler reports comfortable slack it
drains sequences off the most-loaded region toward the least-loaded one
(packing load so a region could be released), and when slack collapses it
stops issuing drains entirely — rebalance copy traffic is exactly what is
stretching token latency, so the drain yields.  Policy only: every move
goes through :meth:`PagedEngine.rebalance`, i.e. the same admission/
budget/dispatch pipeline as any other migration.
"""

from __future__ import annotations


class RegionAutoscaler:
    """Slack-gated drain/fill: consolidate when healthy, yield when not."""

    def __init__(self, engine, scheduler=None, max_moves_per_tick: int = 1,
                 min_slack: float = 0.25, min_imbalance: int = 2):
        self.engine = engine
        self.scheduler = scheduler  # anything with min_slack() (SloScheduler)
        self.max_moves_per_tick = max_moves_per_tick
        self.min_slack = min_slack
        self.min_imbalance = min_imbalance
        self.moves_issued = 0
        self.yields = 0  # ticks where slack vetoed a wanted drain

    def _load(self) -> dict[int, int]:
        load = {r: 0 for r in range(self.engine.pcfg.n_regions)}
        for seq in self.engine.seqs.values():
            load[seq.region] += 1
        return load

    def step(self) -> list:
        """Issue up to ``max_moves_per_tick`` drains; returns [(sid, dst)]."""
        load = self._load()
        src = max(load, key=lambda r: load[r])
        dst = min(load, key=lambda r: load[r])
        if load[src] - load[dst] < self.min_imbalance:
            return []
        if self.scheduler is not None and hasattr(self.scheduler, "min_slack"):
            if self.scheduler.min_slack() < self.min_slack:
                self.yields += 1
                return []
        moved = []
        for sid in sorted(self.engine.seqs):
            if len(moved) >= self.max_moves_per_tick:
                break
            if self.engine.seqs[sid].region != src:
                continue
            self.engine.rebalance(sid, dst)
            moved.append((sid, dst))
            load[src] -= 1
            load[dst] += 1
            if load[src] - load[dst] < self.min_imbalance:
                break
        self.moves_issued += len(moved)
        return moved
