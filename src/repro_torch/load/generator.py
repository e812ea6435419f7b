"""Open-loop load generator driving a PagedEngine tick by tick.

The generator owns the serving loop the benchmarks and chaos scenarios
replay: per tick it (1) enqueues the spec's arrivals, (2) admits from a
priority queue under page-reservation backpressure, (3) decodes every
running sequence in power-of-two chunks (the JAX package's batch shapes:
the port compiles nothing, but the chunks fix the decode order and batch
composition), (4) runs the engine's migration tick, then (5) advances a
*modeled* clock via :class:`ServingTimeModel` and attributes the tick's
latency to every token emitted in it.

Two deliberate design points:

* **Modeled time, not wall time.**  Gateable p50/p99 must reproduce across
  machines; the model prices a tick from what happened in it (running
  sequences, admissions, migrated blocks) so the percentile surface is a
  pure function of the spec seed.  Migration pressure shows up as token
  latency exactly the way the paper's remote-access/copy interference does.

* **Reservation backpressure.**  A request is admitted only when the pool
  can hold its *entire* lifetime page footprint on top of every live
  sequence's outstanding reservation — so decode can never hit the pool's
  ``KV pool exhausted`` mid-flight; pressure surfaces as queue delay and
  (past ``max_queue``) drops, never as a crash.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.load.workload import ArrivalStream, Request, WorkloadSpec


@dataclasses.dataclass(frozen=True)
class ServingTimeModel:
    """Prices one tick of serving in modeled time units.

    ``tick_time = decode_base + per_seq * n_running + per_prefill *
    n_admitted + per_migrated_block * blocks_copied`` — the last term is the
    interference channel: migration copy traffic stretches the tick for
    every in-flight token, which is what an SLO-aware scheduler trades
    against migration throughput.
    """

    decode_base: float = 1.0
    per_seq: float = 0.02
    per_prefill: float = 0.25
    per_migrated_block: float = 0.25

    def tick_time(self, n_running: int, n_admitted: int, blocks_copied: int) -> float:
        return (
            self.decode_base
            + self.per_seq * n_running
            + self.per_prefill * n_admitted
            + self.per_migrated_block * blocks_copied
        )


def pow2_chunks(n: int) -> list[int]:
    """Split a batch of ``n`` into descending power-of-two chunk sizes."""
    out = []
    while n > 0:
        c = 1 << (n.bit_length() - 1)
        out.append(c)
        n -= c
    return out


class LoadGenerator:
    """Replays a :class:`WorkloadSpec` against one engine."""

    def __init__(self, engine, spec: WorkloadSpec, model=None, scheduler=None):
        spec.validate()
        self.engine = engine
        self.spec = spec
        self.model = model or ServingTimeModel()
        # Optional deadline-aware SchedulerPolicy (e.g. SloScheduler): the
        # generator registers the tenants and feeds it the same per-token
        # latencies it records, closing the pacing loop.
        self.scheduler = scheduler
        if scheduler is not None and hasattr(scheduler, "register_tenant"):
            for t in spec.tenants:
                scheduler.register_tenant(t.name, t.slo_latency, t.priority)
        self.stream = ArrivalStream(spec)
        self.now = 0.0
        self.tick_index = 0
        self._next_rid = 0
        self._queue: list = []  # heap of (-priority, rid, Request)
        self.live: dict[int, Request] = {}  # sid -> Request
        self.done: list[Request] = []
        self.dropped = 0
        self.blocks_copied = 0
        self.tick_log: list[dict] = []
        # (tick_index, latency) per tenant — report() can skip warmup ticks
        self._lat: dict[str, list] = {t.name: [] for t in spec.tenants}
        self._churn_cursor = 0

    # -- capacity ----------------------------------------------------------

    def _pages_for(self, req: Request) -> int:
        """Worst-case lifetime page footprint of one request."""
        blk = self.engine.pcfg.block_tokens
        total = req.prompt_tokens + req.decode_tokens
        pages = -(-total // blk) + 1  # +1: append-frontier crossing slack
        # A tiered pool hands out pages in aligned groups of G, so one
        # logical page can consume a whole fresh group.
        return pages * self.engine.pcfg.huge_factor

    def _reserved(self) -> int:
        """Pages the live set may still allocate (lifetime minus held)."""
        total = 0
        for sid, req in self.live.items():
            held = len(self.engine.seqs[sid].block_ids)
            total += max(0, self._pages_for(req) - held)
        return total

    def can_admit(self, req: Request) -> bool:
        return self.engine.free_pages() - self._reserved() >= self._pages_for(req)

    # -- one tick ----------------------------------------------------------

    def step(self) -> dict:
        spec = self.spec
        tick = self.tick_index
        # 1. open-loop arrivals (bounded queue; overflow drops, never blocks)
        for _, tspec in self.stream.arrivals(tick):
            req = Request(
                rid=self._next_rid,
                tenant=tspec.name,
                priority=tspec.priority,
                region=tspec.region,
                prompt_tokens=tspec.prompt_tokens,
                decode_tokens=tspec.decode_tokens,
                arrival_tick=tick,
                arrival_time=self.now,
            )
            self._next_rid += 1
            if len(self._queue) >= spec.max_queue:
                self.dropped += 1
                continue
            heapq.heappush(self._queue, (-req.priority, req.rid, req))
        # 2. admission under reservation backpressure (priority order, FIFO
        #    within a priority level; head-of-line blocking is deliberate —
        #    skipping past a starved high-priority request would invert SLOs)
        admitted = 0
        while self._queue and self.can_admit(self._queue[0][2]):
            _, _, req = heapq.heappop(self._queue)
            prompt = np.arange(req.prompt_tokens) % self.engine.cfg.vocab_size
            req.sid = self.engine.admit(prompt, region=req.region, tenant=req.tenant)
            req.admit_time = self.now
            self.live[req.sid] = req
            admitted += 1
        # 3. background churn: periodic rebalances = sustained migration load
        churned = 0
        if spec.churn_every and tick and tick % spec.churn_every == 0:
            sids = sorted(self.live)
            n_regions = self.engine.pcfg.n_regions
            for _ in range(min(spec.churn_count, len(sids))):
                sid = sids[self._churn_cursor % len(sids)]
                self._churn_cursor += 1
                dst = (self.engine.seqs[sid].region + 1) % n_regions
                self.engine.rebalance(sid, dst)
                churned += 1
        # 4. decode everything running, in pow2 chunks (the JAX package's
        #    batch shapes, kept so that the decode order is the same)
        sids = sorted(self.live)
        i = 0
        for c in pow2_chunks(len(sids)):
            self.engine.decode(sids[i : i + c])
            i += c
        for sid in sids:
            self.live[sid].tokens_done += 1
        # 5. migration tick; measure the copy traffic it actually moved
        #    (bytes_per_link is a host counter: reading it never syncs)
        stats = self.engine.driver.stats
        before = sum(stats.bytes_per_link.values())
        self.engine.tick()
        copied = (sum(stats.bytes_per_link.values()) - before) // max(
            1, self.engine.pool_cfg.block_bytes
        )
        self.blocks_copied += copied
        # 6. modeled clock: this tick's cost is every emitted token's latency
        dt = self.model.tick_time(len(sids), admitted, copied)
        self.now += dt
        per_tenant: dict[str, int] = {}
        for sid in sids:
            t = self.live[sid].tenant
            per_tenant[t] = per_tenant.get(t, 0) + 1
            self._lat[t].append((tick, dt))
        for t, n in per_tenant.items():
            self.engine.observe_tokens(t, [dt] * n)
            if self.scheduler is not None and hasattr(self.scheduler, "observe_tokens"):
                self.scheduler.observe_tokens(t, [dt] * n)
        # 7. completions release their pages (and ease backpressure)
        for sid in sids:
            req = self.live[sid]
            if req.tokens_done >= req.decode_tokens:
                req.done_time = self.now
                self.engine.release(sid)
                self.done.append(self.live.pop(sid))
        self.tick_index += 1
        entry = {
            "tick": tick,
            "dt": dt,
            "n_running": len(sids),
            "admitted": admitted,
            "copied": int(copied),
            "churned": churned,
            "queued": len(self._queue),
        }
        self.tick_log.append(entry)
        return entry

    def run(self) -> dict:
        for _ in range(self.spec.ticks):
            self.step()
        return self.report()

    # -- results -----------------------------------------------------------

    def report(self, warmup: int = 0) -> dict:
        """Latency/throughput summary; ``warmup`` drops the first N ticks
        from the percentile surface (pacing loops need a window to engage)."""
        tenants: dict[str, dict] = {}
        all_lat: list[float] = []
        for tspec in self.spec.tenants:
            lat = [v for (tk, v) in self._lat[tspec.name] if tk >= warmup]
            all_lat.extend(lat)
            arr = np.asarray(lat) if lat else np.zeros(1)
            tenants[tspec.name] = {
                "tokens": len(lat),
                "p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99)),
                "slo_latency": tspec.slo_latency,
                "slo_met": bool(float(np.percentile(arr, 99)) <= tspec.slo_latency),
            }
        arr = np.asarray(all_lat) if all_lat else np.zeros(1)
        measured = sum(
            e["dt"] for e in self.tick_log if e["tick"] >= warmup
        ) or 1.0
        copied = sum(e["copied"] for e in self.tick_log if e["tick"] >= warmup)
        return {
            "ticks": self.tick_index,
            "modeled_time": self.now,
            "tokens": len(all_lat),
            "p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99)),
            "mig_rate": copied / measured,  # blocks moved per modeled unit
            "blocks_copied": int(self.blocks_copied),
            "completed": len(self.done),
            "running": len(self.live),
            "queued": len(self._queue),
            "dropped": self.dropped,
            "tenants": tenants,
        }

    def verify_accounting(self) -> None:
        """Per-tenant page-closure check (chaos invariant hook).

        Every pool page is exactly one of {held, reserved spare, free}, and
        the engine's per-tenant held-page attribution matches the
        generator's live-request view.  Raises AssertionError on breach.
        """
        acc = self.engine.page_accounting()
        total = acc["used"] + acc["spare"] + acc["free"]
        assert total == acc["total"], (
            f"page closure broken: used {acc['used']} + spare {acc['spare']}"
            f" + free {acc['free']} = {total} != total {acc['total']}"
        )
        mine: dict[str, int] = {}
        for sid, req in self.live.items():
            mine[req.tenant] = mine.get(req.tenant, 0) + len(
                self.engine.seqs[sid].block_ids
            )
        assert mine == acc["per_tenant"], (
            f"tenant page attribution diverged: generator {mine}"
            f" vs engine {acc['per_tenant']}"
        )
