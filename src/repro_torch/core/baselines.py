"""Baseline migration mechanisms the paper compares against.

``SyncResharder``  — the ``move_pages()`` analogue: synchronous (blocks the
caller until done), migrates into *freshly allocated* memory (pays an extra
zero-fill pass over the destination — the page-fault analogue), and is
*unreliable*: blocks that are busy (dirty/in-flight at call time) are skipped
and reported as failed, with no retry.

``AutoBalancer``  — the Linux auto-NUMA-balancing analogue: a periodic scan
over access counters; migrates a bounded number of "hot remote" blocks per
scan, but only when observed write pressure is low (the kernel heuristic the
paper shows "waits for times of little load ... which might never come").
No completion guarantee, no user control.

Both are **pipeline configurations**, not separate migration loops: they
submit through :class:`repro_torch.core.MigrationDriver` with the
:class:`~repro_torch.core.pipeline.SyncScheduler` /
:class:`~repro_torch.core.pipeline.SamplingScheduler` admission stamps
(escalate to the atomic force program, zero-fill fresh destinations, skip
busy), so the contenders differ from ``page_leap()`` only in *policy* over
one shared dispatch/verdict engine.  They run on the device of the driver's
state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pipeline import SamplingConfig, SamplingScheduler, SyncScheduler, busy_mask
from repro_torch.core.state import PoolConfig
from repro_torch.topology import spill_assignments


@dataclasses.dataclass
class SyncReshardResult:
    migrated: np.ndarray  # block ids that moved
    failed: np.ndarray  # busy blocks that were skipped (paper: EBUSY)
    bytes_copied: int
    bytes_touched: int  # includes the fresh-allocation zero pass


class SyncResharder:
    """``move_pages()`` analogue over a leap pool.

    A :class:`~repro_torch.core.pipeline.SyncScheduler` configuration of the
    shared pipeline: busy blocks are skipped (EBUSY, no retry), the rest are
    escalated straight to the atomic force program with a zero-fill pass
    over their freshly "allocated" destination slots, and the call blocks
    until the whole request resolved — exactly the syscall's contract.
    """

    def __init__(self, pool_cfg: PoolConfig, fresh_alloc: bool = True):
        self.pool_cfg = pool_cfg
        self.fresh_alloc = fresh_alloc
        self.scheduler = SyncScheduler(fresh_alloc=fresh_alloc)

    def migrate_driver(self, driver, block_ids, dst_region: int) -> SyncReshardResult:
        """Synchronously migrate ``block_ids``; the call blocks until done,
        the device included.

        The sanctioned entry point: routes the request through the driver's
        staged pipeline (same dispatch/verdict engine as ``page_leap()``),
        differing only in the admission ticket.
        """
        block_ids = np.unique(np.asarray(block_ids, dtype=np.int32))
        block_ids = block_ids[driver.regions_of(block_ids) != dst_region]
        empty = np.zeros(0, np.int32)
        if len(block_ids) == 0:
            return SyncReshardResult(empty, empty, 0, 0)
        # The syscall's EBUSY set: dirty/in-flight on device, or claimed by a
        # live leap request.  Reported as failed, never retried.
        busy = busy_mask(driver.state, block_ids).cpu().numpy()
        busy = busy | driver.in_migration(block_ids)
        failed = block_ids[busy]
        todo = block_ids[~busy]
        if len(todo) == 0:
            return SyncReshardResult(empty, failed, 0, 0)
        if driver.free_slots(dst_region) < len(todo):
            raise RuntimeError("destination region out of slots")
        # skip_busy already applied above (to report the EBUSY ids); don't
        # pay admission's device busy-check a second time on filtered ids.
        ticket = dataclasses.replace(
            self.scheduler.admission_ticket(), skip_busy=False
        )
        handle = driver.default_session().leap(todo, dst_region, ticket=ticket)
        ok = handle.wait()
        for device in driver.state.devices:
            if device.type == "cuda":  # synchronous, like the syscall
                torch.cuda.synchronize(device)
        if not ok:  # pragma: no cover - force path always terminates
            raise RuntimeError("sync reshard did not terminate")
        nbytes = len(todo) * self.pool_cfg.block_bytes
        touched = 2 * nbytes if self.fresh_alloc else nbytes
        return SyncReshardResult(todo, failed, nbytes, touched)


class AutoBalancer:
    """Access-pattern-driven implicit migration (no guarantees, no control).

    The sampling heuristic (remote-access counters, the defer-under-write-
    pressure gate, per-scan budget) lives in the
    :class:`~repro_torch.core.pipeline.SamplingScheduler`; this wrapper turns
    its hot picks into placement decisions and — via :meth:`scan_driver` —
    unconditional kernel-style moves through the shared pipeline.
    """

    def __init__(
        self,
        pool_cfg: PoolConfig,
        n_blocks: int,
        cfg: SamplingConfig | None = None,
    ):
        self.pool_cfg = pool_cfg
        self.scheduler = SamplingScheduler(n_blocks, cfg)
        self.blocks_migrated = 0
        self.bytes_copied = 0

    # -- counter views -------------------------------------------------------

    @property
    def cfg(self) -> SamplingConfig:
        return self.scheduler.cfg

    @property
    def remote_counts(self) -> np.ndarray:
        return self.scheduler.remote_counts

    @property
    def preferred_region(self) -> np.ndarray:
        return self.scheduler.preferred_region

    # -- observation ---------------------------------------------------------

    def observe_reads(self, block_ids, reader_region: int, table_host: np.ndarray) -> None:
        block_ids = np.asarray(block_ids)
        self.scheduler.observe_reads(
            block_ids, reader_region, table_host[block_ids, 0]
        )

    def observe_writes(self, n_writes: int) -> None:
        self.scheduler.observe_writes(n_writes)

    def observe_driver(self, driver, block_ids, reader_region: int) -> None:
        """Record reads against a driver's live placement."""
        block_ids = np.asarray(block_ids)
        self.scheduler.observe_reads(
            block_ids, reader_region, driver.regions_of(block_ids)
        )

    # -- decisions -----------------------------------------------------------

    def decide(self, facade) -> list[tuple[np.ndarray, int]]:
        """:class:`repro_torch.api.PlacementPolicy`: the balancer's counters
        as moves.

        Same hot/pressure heuristics as :meth:`scan_driver`, but instead of
        forcing the copies it hands ``(block_ids, dst_region)`` decisions to
        a :class:`repro_torch.api.LeapSession` (``session.apply(balancer)``),
        which migrates them *reliably* through the leap protocol — the
        heuristic trigger with the explicit mechanism underneath.

        Distance-aware when the facade exposes a topology: hot blocks that
        don't fit on their preferred region spill to the nearest region (by
        link distance from the preferred one) with free capacity — near the
        reader still beats staying put, and cheap links beat far ones.  The
        cheapest moves (shortest source→destination link) are emitted first
        so the driver's per-link budgets fill fast links before slow ones.
        """
        sched = self.scheduler
        hot = sched.select_hot()
        if len(hot) == 0:
            return []
        topo = getattr(facade, "topology", None)
        spare = {r: facade.free_slots(r) for r in range(facade.n_regions)}
        moves: list[tuple[np.ndarray, int]] = []
        moved_ids: list[np.ndarray] = []
        for dst in np.unique(sched.preferred_region[hot]):
            if dst < 0:
                continue
            dst = int(dst)
            ids = hot[sched.preferred_region[hot] == dst]
            if topo is None:
                # uniform: take what fits; overflow waits for a later scan
                take = min(len(ids), max(0, spare[dst]))
                ids = ids[:take]
                if take:
                    moves.append((ids.astype(np.int32), dst))
                    spare[dst] -= take
                    moved_ids.append(ids)
                continue
            assigned, _ = spill_assignments(
                topo, ids, facade.region_of(ids.astype(np.int64)), dst, spare
            )
            for sub_ids, region in assigned:
                moves.append((sub_ids.astype(np.int32), int(region)))
                moved_ids.append(sub_ids)
        sched.settle(np.concatenate(moved_ids) if moved_ids else [])
        if topo is not None:
            # cheapest links first (mean source→destination distance over the
            # move's blocks) so per-link budgets fill fast links before slow
            moves.sort(
                key=lambda m: float(
                    topo.distance[
                        np.asarray(facade.region_of(m[0].astype(np.int64))), m[1]
                    ].mean()
                )
            )
        return moves

    # -- the kernel-style scan (unconditional moves, shared engine) ----------

    def scan_driver(self, driver) -> int:
        """One balancing scan over a driver-managed pool; returns blocks moved.

        The decisions come from :meth:`decide`; execution is the pipeline's
        force path with the sampling policy's admission stamp (fresh
        zero-filled destinations, atomic copy+flip — what the kernel's
        migrate-on-fault does), drained synchronously like the kernel's scan.
        """
        session = driver.default_session()
        moves = self.decide(session.facade)
        if not moves:
            return 0
        ticket = self.scheduler.admission_ticket()
        handles = [
            session.leap(ids, dst, ticket=ticket) for ids, dst in moves
        ]
        # Wait for THIS scan's moves only — a balancing scan must not turn
        # into a full drain of whatever unrelated leap requests are queued.
        ticks = 0
        while any(not h.done for h in handles) and ticks < 100_000:
            session.tick()
            session.poll(block=True)
            ticks += 1
        moved = sum(h.progress().requested for h in handles)
        self.blocks_migrated += moved
        self.bytes_copied += moved * self.pool_cfg.block_bytes
        return moved


# The balancer's config under the name the JAX package also exports.
AutoBalanceConfig = SamplingConfig
