"""Dispatch stage: epoch opens and per-tick device dispatch.

Owns the per-tick scheduling loop (``run_tick``): advances copies of open
epochs, opens new epochs off the priority queue, and hands the tick's work
to the device in one of three dispatch generations
(``LeapConfig.dispatch_mode``):

  * ``"megastep"`` (default) — the whole tick as ONE megastep
    (:func:`repro_torch.core.migrator.megastep`): the previous epoch's
    commits, then begin/zero/force/copy/runs/heat, over the pool in place.
  * ``"batched"`` — one program per tick phase: ``commit_areas``/
    ``commit_groups`` (from :meth:`commit_ready`), then ``begin_areas``,
    ``zero_fill`` (one per destination region), ``force_areas``, the copy
    (``fused_copy``, or one ``fused_copy_ppermute`` per (src, dst) region
    pair under the ppermute backend), ``fused_copy_runs`` and
    ``heat_update``.  The ppermute backend runs this generation unless
    legacy is asked for.
  * ``"legacy"`` — per-chunk/per-area dispatch (the benchmark baseline):
    ``begin_area``/``force_migrate``/``zero_fill`` as each epoch opens,
    one ``copy_chunk`` (or ``copy_chunk_ppermute``) per ``chunk_blocks``
    chunk, one ``commit_area`` per area, huge areas through
    ``fused_copy_runs``/``commit_groups`` one area at a time, and the
    tick's ``heat_update``.  Its programs are plain tensor indexing, as in
    the JAX package; only the force, the huge-run copy and the heat pass
    launch kernels.

The host side of this stage is pure *plan assembly*: it gathers numpy id
vectors, checks each copy plan against the copy kernel's contract, pads
them, and hands them to the program as host tensors, which the program
moves to the device in one transfer per dtype.  The dirty verdict never
crosses back here — it travels in the
:class:`~repro_torch.core.queues.VerdictFuture` of a ``CommitBatch``,
harvested by the verdict stage off the tick critical path.

Every program is a variant cache (``migrator.PROGRAMS``; one captured
CUDA graph a variant on the card), and its operands are padded where the
JAX package pads them.  The megastep's: every nonempty phase to one
budget-floored bucket shared by commit, begin, zero, force and copy, huge
groups and runs to their own floor (budget / G), heat to its own bucket,
so that after warm-up one variant serves a whole drain; ``warm_dispatch``
captures the steady-state variants when the driver is built.  The batched
programs' and the legacy ``zero_fill``: to ``bucket_size(n)`` (a huge
commit by lane 0's whole group); the standalone heat pass: to the
budget-floored bucket.  Where the reference pads with out-of-bounds
sentinels, which XLA drops, the port replicates lane 0 (an out-of-bounds
index would device-assert), which every program applies idempotently; pad
heat lanes carry weight 0.  The other legacy programs and the promotions'
``force_areas`` run at their real lengths, as in the reference.  An empty
phase dispatches nothing.

Budget decisions (how much a link grants, congestion deferral) come from
the budget stage; dirty verdicts are harvested later by the verdict stage.
Tier transitions (promotion/adoption) live here too: a promotion is just a
compaction dispatch through the atomic force program.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import migrator
from repro_torch.core.adaptive import Area, bucket_size, demote_area, pad_to_bucket
from repro_torch.core.pipeline.accounting import AccountingStage
from repro_torch.core.pipeline.budget import BudgetStage, TickBudget
from repro_torch.core.pipeline.context import PipelineContext
from repro_torch.core.queues import CommitBatch, VerdictFuture
from repro_torch.core.state import REGION, SLOT
from repro_torch.kernels.leap_copy import check_copy_plan


def _cat(parts: list) -> np.ndarray:
    """Concatenated int64 ids; an empty list gives an empty array."""
    return np.concatenate(parts).astype(np.int64) if parts else np.zeros(0, np.int64)


def _entries(areas: list[Area]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-block operands of a commit or force: ids, destination regions, slots."""
    return (
        _cat([a.block_ids for a in areas]),
        _cat([np.full(len(a), a.dst_region) for a in areas]),
        _cat([a.dst_slots for a in areas]),
    )


def _group_entries(areas: list[Area]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Operands of a huge-area commit: member ids (group-major), one
    destination region and one run start per area."""
    return (
        _cat([a.block_ids for a in areas]),
        _cat([[a.dst_region] for a in areas]),
        _cat([a.dst_slots[:1] for a in areas]),
    )


def _pad_groups(bucket: int, group: int, members: np.ndarray, regions: np.ndarray,
                starts: np.ndarray) -> tuple[np.ndarray, ...]:
    """A huge commit's operands padded to ``bucket`` groups: a group pads as
    a whole, with lane 0's ``group`` members, region and start."""
    k = len(regions)
    members = members.reshape(k, group)
    members = np.concatenate([members, np.repeat(members[:1], bucket - k, 0)])
    return (members.reshape(-1), *pad_to_bucket(bucket, regions, starts))


def _pad(bucket: int, *arrays: np.ndarray) -> tuple[np.ndarray, ...]:
    """Equal-length arrays padded to ``bucket`` lanes with copies of lane 0
    (:func:`pad_to_bucket`); an empty phase's arrays stay empty."""
    return pad_to_bucket(bucket, *arrays) if len(arrays[0]) else arrays


def _host(*arrays: np.ndarray) -> list[torch.Tensor]:
    """Int arrays as int64 host tensors: a program's operands, which it moves
    to the state's device in one transfer per dtype."""
    return [torch.from_numpy(np.asarray(a, np.int64)) for a in arrays]


class DispatchStage:
    def __init__(
        self,
        ctx: PipelineContext,
        budget: BudgetStage,
        accounting: AccountingStage,
    ):
        self.ctx = ctx
        self.budget = budget
        self.accounting = accounting
        # Dispatch generation, resolved once ("legacy"|"batched"|"megastep").
        # cfg.fused_dispatch is a bool-or-string knob and the string "legacy"
        # is truthy, so every branch below compares modes, never truthiness.
        self._mode = ctx.cfg.dispatch_mode
        self._fused = self._mode != "legacy"
        # Source slots freed by this tick's forced escalations, quarantined
        # until the tick's device programs are dispatched (see run_tick).
        self._freed: list[np.ndarray] = []
        # Commit-ready areas staged by commit_ready() for the tick's single
        # dispatch (they stay in ctx.active until it fires).
        self._staged_small: list[Area] = []
        self._staged_huge: list[Area] = []
        if self._mode == "megastep" and ctx.cfg.warm_dispatch:
            self._warm_megastep()

    # -- the per-tick scheduling loop --------------------------------------

    def commit_ready(self) -> None:
        """Commit areas whose copy completed in an earlier tick: staged for
        the megastep, or dispatched now under batched (one program a kind)
        and legacy (one program an area).  Deferring the commit
        by one tick keeps the copy->remap window open across at least one
        application step, faithfully reproducing the paper's race (its
        footnote 1: a write can land after the copy but before the remap)."""
        ctx = self.ctx
        with ctx.telemetry.stage("dispatch.commit_ready"):
            ready = [a for a in ctx.active if a.copied == len(a)]
            if self._mode == "megastep":
                # No dispatch here: the commits ride this tick's megastep.
                # Ready areas stay in ctx.active until it fires, so emptiness
                # checks (huge stall detection, done()) see them as live.
                self._staged_small = [a for a in ready if not a.huge]
                self._staged_huge = [a for a in ready if a.huge]
            elif self._mode == "batched":
                self._dispatch_commit_batch([a for a in ready if not a.huge])
                self._dispatch_commit_groups([a for a in ready if a.huge])
            else:
                for area in ready:
                    if area.huge:
                        self._dispatch_commit_groups([area])
                    else:
                        self._dispatch_commit(area)

    def run_tick(self, tb: TickBudget) -> None:
        """Spend the tick budget: advance open epochs, open new ones."""
        with self.ctx.telemetry.stage("dispatch.run_tick"):
            self._run_tick(tb)

    def _run_tick(self, tb: TickBudget) -> None:
        ctx = self.ctx
        fused = self._fused
        skipped: set[int] = set()  # active areas deferred this tick (link dry)
        opened: list[Area] = []  # epochs opened this tick (fused: batch begin)
        forced: list[Area] = []  # escalations this tick (fused: batch force)
        blocked: list[Area] = []  # areas whose destination is out of slots
        congested: list[Area] = []  # queued areas whose link budget ran dry
        zeros: list[Area] = []  # fresh-alloc epochs (fused: batch zero-fill)
        plan: list[tuple[Area, np.ndarray, np.ndarray]] = []  # copy chunks
        run_plan: list[Area] = []  # huge areas copied as whole contiguous runs
        while tb.blocks > 0:
            area = self._next_copyable(skipped)
            if area is not None:
                if area.huge:
                    need = len(area) - area.copied
                    if self.budget.grant_huge(tb, area, need) == 0:
                        skipped.add(id(area))
                        continue
                    if fused:
                        run_plan.append(area)
                    else:
                        self._dispatch_copy_runs([area])
                    tb.blocks -= need
                    area.copied = len(area)
                    continue
                per_area = len(area) - area.copied if fused else ctx.cfg.chunk_blocks
                want = min(per_area, len(area) - area.copied, tb.blocks)
                n = self.budget.grant_copy(tb, area, want)
                if n == 0:
                    skipped.add(id(area))
                    continue
                ids = area.block_ids[area.copied : area.copied + n]
                slots = area.dst_slots[area.copied : area.copied + n]
                if fused:
                    plan.append((area, ids, slots))
                else:
                    self._dispatch_copy(area, ids, slots)
                area.copied += n
                tb.blocks -= n
                continue
            if ctx.queue:
                area = ctx.queue.popleft()
                if not self.budget.may_open(tb, area):
                    congested.append(area)
                    continue
                if not self._open_epoch(area, opened, forced, zeros):
                    # Destination out of slots.  A relayed first hop falls
                    # back to the direct link (stalling behind a full relay
                    # region would trade congestion for a livelock); anything
                    # else is set aside (it goes back to the head of its
                    # priority class below) while we keep trying lower-
                    # priority areas: one of THEIR commits may be what frees
                    # the blocked destination — breaking here would let a
                    # high-priority request to a full region starve the very
                    # migrations that could unblock it (livelock).
                    if area.final_dst >= 0 and area.final_dst != area.dst_region:
                        area.dst_region = area.final_dst
                        area.final_dst = -1
                        ctx.queue.appendleft(area)
                    else:
                        blocked.append(area)
                    continue
                if ctx.active and ctx.active[-1] is area:
                    # Charge the per-link epoch-open budget only for a real
                    # open: the out-of-slots halving path requeues without
                    # opening, and forced escalations are budget-exempt.
                    self.budget.charge_open(tb, area)
                continue
            break
        for area in reversed(congested):
            ctx.queue.appendleft(area)
        for area in reversed(blocked):
            ctx.queue.appendleft(area)
        # Device order matters under the fused generations: begin before copy
        # (epoch flags gate dirty tracking), zero-fill before force AND copy
        # (a fresh area's zero pass must land before its own payload), force
        # before copy.  It is only sound because slots freed by this tick's
        # forces are QUARANTINED until the flush below: no open in this tick
        # can hand a force's still-unread source slot to another area as a
        # zero/force/copy destination.  Legacy dispatched each program as
        # its epoch opened or its chunk was granted, in that order.
        if self._mode == "megastep":
            # The whole tick — staged commits, begins, zeros, forces,
            # copies, heat — goes to the device as ONE megastep.
            with ctx.telemetry.stage(
                "dispatch.device",
                opened=len(opened),
                forced=len(forced),
                copy_chunks=len(plan),
                huge_runs=len(run_plan),
                committed=len(self._staged_small) + len(self._staged_huge),
            ):
                self._dispatch_megastep(opened, zeros, forced, plan, run_plan)
        elif fused:
            with ctx.telemetry.stage(
                "dispatch.device",
                opened=len(opened),
                forced=len(forced),
                copy_chunks=len(plan),
                huge_runs=len(run_plan),
            ):
                self._dispatch_begin_batch(opened)
                self._dispatch_zero_batch(zeros)
                self._dispatch_force_batch(forced)
                self._dispatch_copy_batch(plan)
                self._dispatch_copy_runs(run_plan)
        if self._mode != "megastep":
            # Batched/legacy: the tick's access-heat samples flush as their
            # own program (the megastep folds them into its single dispatch).
            self._flush_heat()
        # End of tick: every program that reads a forced area's old source
        # slots is dispatched; release them for the next tick's allocations.
        for old in self._freed:
            for r in np.unique(old[:, REGION]):
                ctx.free[r].put(old[old[:, REGION] == r, SLOT])
        self._freed = []

    def quarantined_slots(self) -> np.ndarray:
        """Copy of the current force-freed slot quarantine: ``(region, slot)``
        rows held back until this tick's device programs dispatch.  Empty
        between ticks; exposed (read-only) for pipeline introspection."""
        if not self._freed:
            return np.zeros((0, 2), dtype=np.int32)
        return np.concatenate([f.copy() for f in self._freed]).astype(np.int32)

    def _next_copyable(self, skipped: set | None = None) -> Area | None:
        for a in self.ctx.active:
            if a.copied < len(a) and (skipped is None or id(a) not in skipped):
                return a
        return None

    # -- epoch open --------------------------------------------------------

    def _open_epoch(
        self,
        area: Area,
        opened: list[Area],
        forced: list[Area],
        zeros: list[Area],
    ) -> bool:
        ctx = self.ctx
        cfg = ctx.cfg
        if area.huge:
            return self._open_epoch_huge(area, opened)
        if (
            area.attempts >= cfg.max_attempts_before_force
            and area.final_dst >= 0
            and area.final_dst != area.dst_region
        ):
            # Escalation overrides routing: the atomic force program has no
            # race window for the relay to shrink, so the second copy would
            # be pure waste — and a force to the relay could share the tick's
            # force phase with its own re-queued second hop (duplicate
            # scatter lanes, undefined table order).  Force straight to the
            # final destination instead.
            area.dst_region = area.final_dst
            area.final_dst = -1
        slots = ctx.alloc(area.dst_region, len(area))
        if slots is None:
            # Not enough pooled slots for the whole area right now.  If the
            # destination has *some* space, split and make progress with the
            # smaller half; otherwise wait for commits to free slots.
            if len(area) > 1 and len(ctx.free[area.dst_region]) > 0:
                mid = len(area) // 2
                a = Area(
                    area.block_ids[:mid],
                    area.src_region,
                    area.dst_region,
                    area.attempts,
                    request_id=area.request_id,
                    priority=area.priority,
                    final_dst=area.final_dst,
                    fresh_alloc=area.fresh_alloc,
                )
                b = Area(
                    area.block_ids[mid:],
                    area.src_region,
                    area.dst_region,
                    area.attempts,
                    request_id=area.request_id,
                    priority=area.priority,
                    final_dst=area.final_dst,
                    fresh_alloc=area.fresh_alloc,
                )
                ctx.queue.appendleft(b)
                ctx.queue.appendleft(a)
                return True
            return False  # caller re-queues (tick sets it aside, tries others)
        area.dst_slots = slots
        area.copied = 0
        if area.fresh_alloc:
            # Fresh-destination policies (move_pages()/autonuma analogues)
            # pay the kernel's zero-fill pass before their copy/force lands.
            # Fused: the tick's zero phase, sequenced before force and copy;
            # legacy: immediate, in open order.
            if self._fused:
                zeros.append(area)
            else:
                self._dispatch_zero_fill(area)
        if area.attempts >= cfg.max_attempts_before_force:
            # Write-through escalation: fused copy+flip, cannot be dirtied.
            # Deliberately exempt from the per-link budgets (escalation must
            # terminate), but its traffic is still accounted to the link.
            # (Never a relay hop here — escalation converted it to direct
            # above — so the per-block count is exact, not doubled.)
            ctx.count("bytes_copied", len(area) * ctx.pool_cfg.block_bytes)
            ctx.count("blocks_forced", len(area), rid=area.request_id)
            self.budget.charge_link(area.src_region, area.dst_region, len(area))
            ctx.telemetry.request_phase(
                area.request_id,
                "EPOCH_OPEN",
                n=len(area),
                attempts=area.attempts,
                forced=True,
            )
            if self._fused:
                forced.append(area)  # the tick's force phase, end of tick
            else:
                ctx.state = migrator.force_migrate(
                    ctx.state, *_host(area.block_ids, area.dst_slots), int(area.dst_region)
                )
                ctx.count("dispatches", 1, program="force_migrate")
            self._finalize_success(area)
            return True
        ctx.telemetry.request_phase(
            area.request_id, "EPOCH_OPEN", n=len(area), attempts=area.attempts
        )
        if self._fused:
            opened.append(area)  # the tick's begin phase, before copies
        else:
            self._dispatch_begin(area)
        ctx.active.append(area)
        return True

    def _open_epoch_huge(self, area: Area, opened: list[Area]) -> bool:
        """Open a huge area's epoch: reserve one aligned run at the destination.

        If the destination has >= G free slots but no contiguous run
        (fragmentation), or the pipeline is empty and can never free one, the
        huge block demotes and retries at small granularity — the second half
        of the paper's §4.2 rule.
        """
        ctx = self.ctx
        g = int(area.block_ids[0]) // ctx.pool_cfg.huge_factor
        start = ctx.free[area.dst_region].take_run()
        if start is None:
            fragmented = len(ctx.free[area.dst_region]) >= ctx.pool_cfg.huge_factor
            stalled = not ctx.active and not ctx.pending
            if fragmented or stalled:
                ctx.demote_group(g)
                ctx.queue.extend(
                    demote_area(area, ctx.cfg.reduction_factor, ctx.cfg.min_area_blocks)
                )
                return True
            return False  # caller re-queues (tick sets it aside, tries others)
        area.dst_slots = start + np.arange(ctx.pool_cfg.huge_factor, dtype=np.int32)
        area.copied = 0
        ctx.telemetry.request_phase(
            area.request_id, "EPOCH_OPEN", n=len(area), attempts=area.attempts, huge=True
        )
        if self._fused:
            opened.append(area)  # members share the tick's begin phase
        else:
            self._dispatch_begin(area)
        ctx.active.append(area)
        return True

    def _finalize_success(self, area: Area) -> None:
        # Force path: all blocks flipped on device; mirror and free sources.
        # Never a relay hop (escalation forces direct to the final
        # destination), so the credit is always terminal.  Fused, the force
        # phase itself runs at end of tick, so the freed source slots are
        # quarantined (self._freed) instead of released: handing one out to a
        # later open this tick would let that area's zero/force/copy write
        # the slot before this force has read it.  Legacy already dispatched
        # the force, so its sources free at once.
        ctx = self.ctx
        if self._fused:
            ids = area.block_ids
            self._freed.append(ctx.table[ids].copy())
            ctx.table[ids, REGION] = area.dst_region
            ctx.table[ids, SLOT] = area.dst_slots
            ctx.migrating[ids] = False
            ctx.note_migrated(ids)
        else:
            ctx.remap_host(area.block_ids, area.dst_region, area.dst_slots)
        self.accounting.credit(area, forced=len(area))

    # -- access-heat plane (closed-loop tiering) ----------------------------

    def _pop_heat(self) -> tuple[np.ndarray, np.ndarray]:
        """Pop and flatten the tick's pending heat samples (ids, weights)."""
        ctx = self.ctx
        if ctx.heat is None or not ctx.heat_pending:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        samples, ctx.heat_pending = ctx.heat_pending, []
        ids = np.concatenate([s for s, _ in samples]).astype(np.int64)
        w = np.concatenate(
            [np.full(len(s), wt, np.float32) for s, wt in samples]
        )
        return ids, w

    def _flush_heat(self) -> None:
        """Batched/legacy: fold the tick's heat samples as their own program,
        padded to the budget-floored bucket (pad lanes: lane 0, weight 0)."""
        ctx = self.ctx
        ids, w = self._pop_heat()
        if not len(ids):
            return
        ids, w = self._pad_heat(ids, w)
        ctx.heat = migrator.heat_update(
            ctx.heat,
            *_host(ids),
            torch.from_numpy(w),
            ctx.cfg.tier_heat_decay,
            impl=ctx.cfg.copy_impl,
        )
        ctx.count("dispatches", 1, program="heat_update")

    # -- megastep dispatch (one program per tick) ---------------------------

    def _warm_megastep(self) -> None:
        """Compile the steady-state megastep variants ahead of time.

        The budget-floored shared bucket fixes every steady-state operand
        shape before any workload runs, so the drain-loop signatures —
        ``(begin, copy)`` on opening ticks, ``(commit, begin, copy)`` at
        steady state, ``(commit,)`` on the tail, each with the heat phase
        under tiering, and the run-copy and group-commit shapes of a
        two-tier pool — are captured when the driver is built, the same
        signatures the JAX package compiles.  A capture runs nothing, so no
        operand needs a value.  Runs before the driver's jit-miss baseline,
        so warmed variants never count as misses.
        """
        ctx = self.ctx
        G = ctx.pool_cfg.huge_factor
        B = self._megastep_bucket(0)
        gb = self._huge_bucket(0)
        signatures = [("commit",), ("begin", "copy"), ("commit", "begin", "copy")]
        if ctx.heat is not None:
            signatures += [("heat",), ("commit", "heat"), ("begin", "copy", "heat"),
                           ("commit", "begin", "copy", "heat")]
        if G > 1:
            signatures += [("groups",), ("begin", "runs"), ("groups", "begin", "runs"),
                           ("groups", "begin", "copy")]
        lanes = {"commit": (B,) * 3, "groups": (gb * G, gb, gb), "begin": (B,), "zero": (0,),
                 "force": (0,) * 3, "copy": (B,) * 2, "runs": (gb,) * 2, "heat": (B,)}
        for sig in signatures:
            lengths = [n if phase in sig else 0 for phase, ns in lanes.items() for n in ns]
            operands = [torch.zeros(n, dtype=torch.int64) for n in lengths]
            operands.append(torch.zeros(lengths[-1], dtype=torch.float32))
            heat = ctx.heat if "heat" in sig else torch.zeros(0, dtype=torch.float32)
            migrator.warm_megastep(ctx.state, *operands, heat=heat, group=G,
                                   impl=ctx.cfg.copy_impl, heat_decay=ctx.cfg.tier_heat_decay)

    def _pad_heat(self, ids: np.ndarray, w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Heat samples padded to the budget-floored bucket: pad lanes repeat
        lane 0's id with weight 0, where the reference's hold an
        out-of-bounds id."""
        hb = self._megastep_bucket(len(ids))
        (ids,) = pad_to_bucket(hb, ids)
        return ids, np.concatenate([w, np.zeros(hb - len(w), np.float32)])

    def _megastep_bucket(self, *lengths: int) -> int:
        """Shared bucket for every per-block megastep operand.

        Floored at the steady-state tick budget so a drain's every tick —
        and every retry-storm tick, whose fragmented batches are no longer
        than the budget — rounds up to the SAME bucket: after warmup one
        variant serves the whole run.
        """
        ctx = self.ctx
        floor = max(1, min(ctx.cfg.budget_blocks_per_tick, len(ctx.table)))
        return bucket_size(max(max(lengths), floor), ctx.cfg.bucket_growth)

    def _huge_bucket(self, n: int) -> int:
        """Bucket of the huge-tier operands (group commits, run copies),
        floored at the tick's huge capacity, budget / G groups."""
        ctx = self.ctx
        floor = max(1, ctx.cfg.budget_blocks_per_tick // ctx.pool_cfg.huge_factor)
        return bucket_size(max(n, floor), ctx.cfg.bucket_growth)

    def _dispatch_megastep(
        self,
        opened: list[Area],
        zeros: list[Area],
        forced: list[Area],
        plan: list[tuple[Area, np.ndarray, np.ndarray]],
        run_plan: list[Area],
    ) -> None:
        """Assemble and fire the tick's single device program.

        An EMPTY phase ships a shape-``(0,)`` operand and is left out of the
        program.  A NONEMPTY phase pads to its bucket by replicating lane 0
        (see the module docstring); the host slices verdicts by their real
        offsets.  An idle tick — nothing staged, nothing scheduled —
        dispatches nothing at all.
        """
        ctx = self.ctx
        small, huge = self._staged_small, self._staged_huge
        self._staged_small, self._staged_huge = [], []
        heat_ids, heat_w = self._pop_heat()
        if not (
            small
            or huge
            or opened
            or zeros
            or forced
            or plan
            or run_plan
            or len(heat_ids)
        ):
            return
        S = ctx.pool_cfg.slots_per_region
        G = ctx.pool_cfg.huge_factor
        offsets = np.cumsum([0] + [len(a) for a in small])
        commit, force, copy = _entries(small), _entries(forced), self._copy_flat(plan)
        begin = (_cat([a.block_ids for a in opened]),)
        zero = (_cat([a.dst_region * S + a.dst_slots.astype(np.int64) for a in zeros]),)
        B = self._megastep_bucket(*(len(p[0]) for p in (commit, begin, zero, force, copy)))
        commit, begin, zero, force, copy = (_pad(B, *p) for p in (commit, begin, zero, force, copy))
        groups = _group_entries(huge)
        if huge:
            groups = _pad_groups(self._huge_bucket(len(huge)), G, *groups)
        runs = _pad(self._huge_bucket(len(run_plan)), *self._run_flat(run_plan))
        if len(heat_ids):
            (heat_ids, heat_w), heat_in = self._pad_heat(heat_ids, heat_w), ctx.heat
        else:
            heat_in = torch.zeros(0, dtype=torch.float32)
        operands = [
            torch.from_numpy(np.asarray(a, np.int64))
            for a in (*commit, *groups, *begin, *zero, *force, *copy, *runs, heat_ids)
        ]
        ctx.state, verdict_small, verdict_groups, _ = migrator.megastep(
            ctx.state,
            *operands[:15],
            heat_in,
            operands[15],
            torch.from_numpy(heat_w),
            group=G,
            impl=ctx.cfg.copy_impl,
            heat_decay=ctx.cfg.tier_heat_decay,
        )
        ctx.count("dispatches", 1, program="megastep")
        for a in small + huge:
            ctx.active.remove(a)
        if small:
            ctx.pending.append(CommitBatch(small, offsets, VerdictFuture(verdict_small)))
        if huge:
            ctx.pending.append(
                CommitBatch(huge, np.arange(len(huge) + 1), VerdictFuture(verdict_groups))
            )

    # -- copy plans (shared by both generations) -----------------------------

    def _copy_flat(self, plan: list[tuple[Area, np.ndarray, np.ndarray]]):
        """The tick's chunk plan as flat slot ids ``(src, dst)``, checked
        against the copy kernel's contract; counts the bytes it moves.

        Sources come from the exact host mirror: table entries of in-flight
        blocks cannot change until their commit, which this driver issues
        (and this tick's commits target disjoint blocks).
        """
        ctx = self.ctx
        pc = ctx.pool_cfg
        S = pc.slots_per_region
        ids = _cat([ids for _, ids, _ in plan])
        dst_regions = _cat([np.full(len(c), a.dst_region) for a, c, _ in plan])
        src = ctx.table[ids, REGION].astype(np.int64) * S + ctx.table[ids, SLOT]
        dst = dst_regions * S + _cat([s for _, _, s in plan])
        check_copy_plan(src, dst, pc.n_regions * S)
        if len(ids):
            ctx.count("bytes_copied", len(ids) * pc.block_bytes)
        return src, dst

    def _run_flat(self, run_plan: list[Area]):
        """Flat first slots ``(src, dst)`` of the huge blocks copied as whole
        runs this tick, checked; counts the bytes they move."""
        ctx = self.ctx
        pc = ctx.pool_cfg
        S, G = pc.slots_per_region, pc.huge_factor
        firsts = _cat([a.block_ids[:1] for a in run_plan])
        src = ctx.table[firsts, REGION].astype(np.int64) * S + ctx.table[firsts, SLOT]
        dst = _cat([a.dst_region * S + a.dst_slots[:1].astype(np.int64) for a in run_plan])
        check_copy_plan(src, dst, pc.n_regions * S, run=G)
        if run_plan:
            nbytes = len(run_plan) * G * pc.block_bytes
            ctx.count("bytes_copied", nbytes)
            ctx.count("bytes_copied_huge", nbytes)
        return src, dst

    # -- batched dispatch (one program per phase) ---------------------------

    def _bucketed(self, *arrays: np.ndarray) -> tuple[np.ndarray, ...]:
        """Equal-length arrays padded to ``bucket_size(n)`` with copies of
        lane 0, as the reference pads its batched programs."""
        return pad_to_bucket(bucket_size(len(arrays[0]), self.ctx.cfg.bucket_growth), *arrays)

    def _dispatch_zero_batch(self, zeros: list[Area]) -> None:
        """One zero-fill program per destination region covers every
        fresh-destination area opened this tick, escalated and epoch alike."""
        if not zeros:
            return
        ctx = self.ctx
        by_region: dict[int, list[np.ndarray]] = {}
        for a in zeros:
            by_region.setdefault(int(a.dst_region), []).append(a.dst_slots)
        for region, slot_lists in by_region.items():
            ctx.state = migrator.zero_fill(ctx.state, *_host(*self._bucketed(_cat(slot_lists))),
                                           region)
            ctx.count("dispatches", 1, program="zero_fill")

    def _dispatch_begin_batch(self, opened: list[Area]) -> None:
        if not opened:
            return
        ctx = self.ctx
        ids = _cat([a.block_ids for a in opened])
        ctx.state = migrator.begin_areas(ctx.state, *_host(*self._bucketed(ids)))
        ctx.count("dispatches", 1, program="begin_areas")

    def _dispatch_force_batch(self, forced: list[Area]) -> None:
        if not forced:
            return
        ctx = self.ctx
        ctx.state = migrator.force_areas(ctx.state, *_host(*self._bucketed(*_entries(forced))))
        ctx.count("dispatches", 1, program="force_areas")

    def _dispatch_copy_batch(self, plan: list[tuple[Area, np.ndarray, np.ndarray]]) -> None:
        if not plan:
            return
        ctx = self.ctx
        if ctx.cfg.backend == "ppermute":
            self._dispatch_copy_batch_ppermute(plan)
            return
        ctx.state = migrator.fused_copy(
            ctx.state, *_host(*self._bucketed(*self._copy_flat(plan))), impl=ctx.cfg.copy_impl
        )
        ctx.count("dispatches", 1, program="fused_copy")

    def _dispatch_copy_batch_ppermute(
        self, plan: list[tuple[Area, np.ndarray, np.ndarray]]
    ) -> None:
        ctx = self.ctx
        n_blocks = sum(len(ids) for _, ids, _ in plan)
        ctx.count("bytes_copied", n_blocks * ctx.pool_cfg.block_bytes)
        if ctx.mesh is None or ctx.cfg.axis_name is None:
            raise ValueError("ppermute backend requires mesh and axis_name")
        S = ctx.pool_cfg.slots_per_region
        # One point-to-point program per (src, dst) region pair this tick;
        # areas are single-source so chunks group cleanly.
        pairs: dict[tuple[int, int], list[tuple[np.ndarray, np.ndarray]]] = {}
        for area, ids, slots in plan:
            pairs.setdefault((area.src_region, area.dst_region), []).append(
                (ctx.table[ids, SLOT], slots)
            )
        for (src, dst), chunks in pairs.items():
            src_slots = _cat([c[0] for c in chunks])
            dst_slots = _cat([c[1] for c in chunks])
            # The gather and the scatter see one region's shard each; as flat
            # ids the pair's plan must meet the in-pool copy's contract.
            check_copy_plan(src * S + src_slots, dst * S + dst_slots, ctx.pool_cfg.n_regions * S)
            ctx.state = migrator.fused_copy_ppermute(
                ctx.state,
                *_host(*self._bucketed(src_slots, dst_slots)),
                int(src),
                int(dst),
                ctx.mesh,
                impl=ctx.cfg.copy_impl,
            )
            ctx.count("dispatches", 1, program="fused_copy_ppermute")

    def _dispatch_commit_batch(self, ready: list[Area]) -> None:
        if not ready:
            return
        ctx = self.ctx
        offsets = np.cumsum([0] + [len(a) for a in ready])
        ctx.state, verdict = migrator.commit_areas(
            ctx.state, *_host(*self._bucketed(*_entries(ready)))
        )
        ctx.count("dispatches", 1, program="commit_areas")
        for a in ready:
            ctx.active.remove(a)
        # the verdict is the replayed graph's own tensor: the future copies it now
        ctx.pending.append(CommitBatch(ready, offsets, VerdictFuture(verdict)))

    def _dispatch_copy_runs(self, run_plan: list[Area]) -> None:
        """One program copies every huge block scheduled this tick, each as a
        single contiguous-run move, not G per-slot copies."""
        if not run_plan:
            return
        ctx = self.ctx
        ctx.state = migrator.fused_copy_runs(
            ctx.state,
            *_host(*self._bucketed(*self._run_flat(run_plan))),
            ctx.pool_cfg.huge_factor,
            impl=ctx.cfg.copy_impl,
        )
        ctx.count("dispatches", 1, program="fused_copy_runs")

    def _dispatch_commit_groups(self, ready: list[Area]) -> None:
        """All-or-nothing commit of every copy-complete huge area (one
        program, one verdict lane per huge block), padded by lane 0's whole
        group."""
        if not ready:
            return
        ctx = self.ctx
        G = ctx.pool_cfg.huge_factor
        bucket = bucket_size(len(ready), ctx.cfg.bucket_growth)
        ctx.state, verdict = migrator.commit_groups(
            ctx.state, *_host(*_pad_groups(bucket, G, *_group_entries(ready))), group=G
        )
        ctx.count("dispatches", 1, program="commit_groups")
        for a in ready:
            ctx.active.remove(a)
        ctx.pending.append(CommitBatch(ready, np.arange(len(ready) + 1), VerdictFuture(verdict)))

    # -- legacy per-area dispatch (fused_dispatch=False baseline) ----------

    def _dispatch_begin(self, area: Area) -> None:
        ctx = self.ctx
        ctx.state = migrator.begin_area(ctx.state, *_host(area.block_ids))
        ctx.count("dispatches", 1, program="begin_area")

    def _dispatch_zero_fill(self, area: Area) -> None:
        ctx = self.ctx
        ctx.state = migrator.zero_fill(ctx.state, *_host(*self._bucketed(area.dst_slots)),
                                       int(area.dst_region))
        ctx.count("dispatches", 1, program="zero_fill")

    def _dispatch_copy(self, area: Area, ids: np.ndarray, slots: np.ndarray) -> None:
        ctx = self.ctx
        operands = _host(ids, slots)
        if ctx.cfg.backend == "ppermute":
            if ctx.mesh is None or ctx.cfg.axis_name is None:
                raise ValueError("ppermute backend requires mesh and axis_name")
            ctx.state = migrator.copy_chunk_ppermute(
                ctx.state, *operands, int(area.src_region), int(area.dst_region), ctx.mesh
            )
        else:
            ctx.state = migrator.copy_chunk(ctx.state, *operands, int(area.dst_region))
        ctx.count("dispatches", 1, program="copy_chunk")
        ctx.count("bytes_copied", len(ids) * ctx.pool_cfg.block_bytes)

    def _dispatch_commit(self, area: Area) -> None:
        ctx = self.ctx
        ctx.state, verdict = migrator.commit_area(
            ctx.state, *_host(area.block_ids, area.dst_slots), int(area.dst_region)
        )
        ctx.count("dispatches", 1, program="commit_area")
        ctx.active.remove(area)
        # the verdict is the replayed graph's own tensor: the future copies it now
        ctx.pending.append(
            CommitBatch([area], np.asarray([0, len(area)]), VerdictFuture(verdict))
        )

    # -- tier transitions (two-tier pool) ----------------------------------

    def promote_candidates(self, limit: int | None = None) -> list[int]:
        """Groups currently eligible for promotion (aligned, resident, cold)."""
        ctx = self.ctx
        if ctx.tiers is None:
            return []
        out = ctx.promotion.candidates(
            ctx.tiers, ctx.table, ctx.migrating, ctx.last_write, ctx.stats.ticks
        )
        return out[:limit] if limit is not None else out

    def promote_group(self, g: int) -> bool:
        """Coalesce group ``g``'s G small blocks into one huge block.

        Requires the policy's aligned/fully-resident/cold checks and a free
        run in the group's region; the compaction copy+remap goes through the
        atomic force program, so no epoch (and no race window) is needed.
        Returns False (no state change) when ineligible or out of runs.
        """
        ctx = self.ctx
        if ctx.tiers is None:
            return False
        if not ctx.promotion.eligible(
            g, ctx.tiers, ctx.table, ctx.migrating, ctx.last_write, ctx.stats.ticks
        ):
            return False
        members = ctx.tiers.members(g)
        region = int(ctx.table[members[0], REGION])
        start = ctx.free[region].take_run()
        if start is None:
            return False
        G = ctx.pool_cfg.huge_factor
        dst_slots = start + np.arange(G, dtype=np.int32)
        ctx.state = migrator.force_areas(ctx.state, *_host(members, np.full(G, region), dst_slots))
        ctx.count("dispatches", 1, program="force_areas")
        ctx.count("bytes_copied", G * ctx.pool_cfg.block_bytes)
        # take_run left the destination live as one huge allocation; the old
        # scattered member slots free individually and coalesce.
        ctx.free[region].put(ctx.table[members, SLOT])
        ctx.table[members, SLOT] = dst_slots
        ctx.tiers.promote(g, region, start)
        ctx.count("promotions", 1, group=g)
        return True

    def adopt_huge(self, group_ids) -> int:
        """Zero-copy promotion of groups whose members already sit on aligned
        contiguous runs (e.g. straight out of ``init_state``'s dense
        placement).  Pure host metadata; returns the number adopted.
        """
        ctx = self.ctx
        if ctx.tiers is None:
            return 0
        G = ctx.pool_cfg.huge_factor
        adopted = 0
        for g in np.asarray(group_ids, dtype=np.int64):
            g = int(g)
            members = ctx.tiers.members(g)
            if ctx.tiers.tier[g] or ctx.migrating[members].any():
                continue
            region = ctx.table[members, REGION]
            start = int(ctx.table[members[0], SLOT])
            contiguous = (
                (region == region[0]).all()
                and start % G == 0
                and (ctx.table[members, SLOT] == start + np.arange(G)).all()
            )
            if not contiguous:
                continue
            ctx.free[int(region[0])].merge_allocated(start)
            ctx.tiers.promote(g, int(region[0]), start)
            adopted += 1
        return adopted
