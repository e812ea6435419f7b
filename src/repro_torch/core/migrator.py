"""Migration programs: the device data plane of ``page_leap()``.

An area's life cycle (driven from the host by :mod:`repro_torch.core.driver`):

    begin   -> open the copy epoch (set in_flight, clear dirty)
    copy    -> physical copy, source region -> pooled destination slots
               (budgeted; an epoch may span ticks, which is the window in
               which concurrent writes can dirty a block)
    commit  -> the atomic "remap": flip table entries of *clean* blocks to
               their destination, return the dirty verdict so the host can
               requeue dirty blocks with adaptive splitting

:func:`megastep` runs a whole tick — the previous epoch's commits, then
begin/zero/force/copy/runs/heat — as one sequence of kernels on the current
stream, over the state's tensors in place.  :func:`force_areas` is the fused
copy+flip that tier promotion uses.

Operands have their real lengths.  The JAX megastep pads every phase to a
shared bucket with out-of-bounds sentinel lanes, which XLA drops or clamps,
to keep its compile cache small; eager PyTorch has no such cache, and an
out-of-bounds index raises on the CPU and device-asserts on CUDA.  So the
port ships no sentinel lanes and no lane-0 replication, and an empty phase
gets an empty tensor and is skipped.  Padding comes back with CUDA-graph
capture, together with a trash slot in the pool.

No phase synchronises with the host: there is no ``.item()``, no boolean-mask
indexing and no ``nonzero``.  Index operands are int64 on the state's
device; ``table`` stays int32.
"""

from __future__ import annotations

import torch

from repro_torch.core.state import REGION, SLOT, LeapState, flat_pool_view
from repro_torch.kernels import ops


def _entries(regions: torch.Tensor, slots: torch.Tensor, dtype) -> torch.Tensor:
    return torch.stack([regions, slots], dim=-1).to(dtype)


def megastep(
    state: LeapState,
    commit_ids: torch.Tensor,
    commit_regions: torch.Tensor,
    commit_slots: torch.Tensor,
    grp_members: torch.Tensor,
    grp_regions: torch.Tensor,
    grp_starts: torch.Tensor,
    begin_ids: torch.Tensor,
    zero_flat: torch.Tensor,
    force_ids: torch.Tensor,
    force_regions: torch.Tensor,
    force_slots: torch.Tensor,
    copy_src: torch.Tensor,
    copy_dst: torch.Tensor,
    run_src: torch.Tensor,
    run_dst: torch.Tensor,
    heat: torch.Tensor,
    heat_ids: torch.Tensor,
    heat_w: torch.Tensor,
    group: int = 1,
    impl: str | None = None,
    heat_decay: float = 1.0,
) -> tuple[LeapState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tick: commit -> group-commit -> begin -> zero -> force -> copy -> runs -> heat.

    Updates ``state`` (and ``heat``) in place and returns them with the dirty
    verdicts ``(state, verdict_small, verdict_groups, heat)``.  Phase order
    matches the JAX megastep: the commit verdicts are gathered into new
    tensors before begin clears ``dirty``; force reads the post-commit table
    and the post-zero pool and gathers its payload before it scatters; the
    copy and run phases come after force; heat touches nothing else.
    """
    table, dirty, in_flight = state.table, state.dirty, state.in_flight
    dev = table.device
    s_per = state.pool.shape[1]
    empty = torch.zeros(0, dtype=torch.bool, device=dev)

    # -- commit (previous epoch): small blocks, then all-or-nothing groups --
    verdict_small = empty
    if commit_ids.shape[0]:
        verdict_small = dirty[commit_ids]  # True => copy invalidated
        proposed = _entries(commit_regions, commit_slots, table.dtype)
        table[commit_ids] = torch.where(verdict_small[:, None], table[commit_ids], proposed)
        in_flight.index_fill_(0, commit_ids, False)

    verdict_groups = empty
    if grp_starts.shape[0]:
        k = grp_starts.shape[0]
        members = grp_members.view(k, group)
        verdict_groups = dirty[members].any(dim=1)
        member_slots = grp_starts[:, None] + torch.arange(group, device=dev)[None, :]
        gprop = _entries(grp_regions[:, None].expand(k, group), member_slots, table.dtype)
        gnew = torch.where(verdict_groups[:, None, None], table[members], gprop)
        table[grp_members] = gnew.view(-1, 2)
        in_flight.index_fill_(0, grp_members, False)

    # -- begin: open this tick's copy epochs --------------------------------
    if begin_ids.shape[0]:
        in_flight.index_fill_(0, begin_ids, True)
        dirty.index_fill_(0, begin_ids, False)

    # -- zero freshly allocated destinations (page-fault analogue) ----------
    flat = flat_pool_view(state.pool)
    if zero_flat.shape[0]:
        flat.index_fill_(0, zero_flat, 0)

    # -- force: fused copy+flip escalations (reads the post-commit table) ---
    if force_ids.shape[0]:
        loc = table[force_ids].long()
        force_src = loc[:, REGION] * s_per + loc[:, SLOT]
        force_dst = force_regions * s_per + force_slots
        flat[force_dst] = flat[force_src]  # the gather completes first
        table[force_ids] = _entries(force_regions, force_slots, table.dtype)
        in_flight.index_fill_(0, force_ids, False)
        dirty.index_fill_(0, force_ids, False)

    # -- physical copy: the leap_copy kernel over the flat pool view --------
    if copy_src.shape[0]:
        ops.copy_blocks_impl(flat, copy_src, copy_dst, impl=impl)
    if run_src.shape[0]:
        ops.copy_runs_impl(flat, run_src, run_dst, run=group, impl=impl)

    # -- access heat: decay + accumulate this tick's samples (tiering) ------
    if heat_ids.shape[0]:
        heat = ops.heat_scan_impl(heat, heat_ids, heat_w, heat_decay, impl=impl)

    return state, verdict_small, verdict_groups, heat


def heat_update(
    heat: torch.Tensor,
    ids: torch.Tensor,
    w: torch.Tensor,
    decay: float,
    impl: str | None = None,
) -> torch.Tensor:
    """Standalone access-heat pass, in place (under megastep the same update
    rides the tick as its trailing phase)."""
    return ops.heat_scan_impl(heat, ids, w, decay, impl=impl)


def force_areas(
    state: LeapState,
    block_ids: torch.Tensor,
    dst_regions: torch.Tensor,
    dst_slots: torch.Tensor,
) -> LeapState:
    """Batched write-through escalation, in place: fused copy+flip."""
    loc = state.table[block_ids].long()
    state.pool[dst_regions, dst_slots] = state.pool[loc[:, REGION], loc[:, SLOT]]
    state.table[block_ids] = _entries(dst_regions, dst_slots, state.table.dtype)
    state.in_flight.index_fill_(0, block_ids, False)
    state.dirty.index_fill_(0, block_ids, False)
    return state


# --------------------------------------------------------------------------
# Compile-cache introspection (control-path cost accounting)
# --------------------------------------------------------------------------

_PROGRAMS = ("megastep", "heat_update", "force_areas")


def program_cache_sizes() -> dict[str, int]:
    """Compiled-variant count per migration program: always zero, since
    PyTorch runs eagerly and compiles nothing (the JAX package counts its
    XLA compiles here)."""
    return {name: 0 for name in _PROGRAMS}


def program_cache_size() -> int:
    """Total compiled migration-program variants (zero; see above)."""
    return sum(program_cache_sizes().values())
