"""Migration programs: the device data plane of ``page_leap()``.

An area's life cycle (driven from the host by :mod:`repro_torch.core.driver`):

    begin   -> open the copy epoch (set in_flight, clear dirty)
    copy    -> physical copy, source region -> pooled destination slots
               (budgeted; an epoch may span ticks, which is the window in
               which concurrent writes can dirty a block)
    commit  -> the atomic "remap": flip table entries of *clean* blocks to
               their destination, return the dirty verdict so the host can
               requeue dirty blocks with adaptive splitting

The JAX package's three dispatch generations are ported:

  * the per-area programs (``begin_area``/``copy_chunk``/
    ``copy_chunk_ppermute``/``commit_area``/``force_migrate``, with
    ``zero_fill``): one program per chunk and per area, with the
    destination region a plain argument; the legacy baseline that the
    paper's figures measure the fused generations against.  They are plain
    tensor indexing, as in the JAX package, and launch none of the
    hand-written kernels;
  * the batched programs (``begin_areas``/``zero_fill``/``force_areas``/
    ``fused_copy``/``fused_copy_runs``/``fused_copy_ppermute``/
    ``commit_areas``/``commit_groups``/``heat_update``): one program per
    tick phase, each covering every area the driver scheduled this tick;
  * :func:`megastep`: the whole tick — the previous epoch's commits, then
    begin/zero/force/copy/runs/heat — as one sequence of those programs.

Every program runs on the current stream over the state's tensors in place.
Two copy backends: ``xla`` moves flat slot ids through ``fused_copy`` (the
``copy_blocks`` kernel over the flat pool view), and ``ppermute`` moves one
(src, dst) region pair at a time through ``fused_copy_ppermute`` (the
``gather_blocks`` and ``scatter_blocks`` kernels around a point-to-point
transfer on a region mesh).  The legacy generation's counterparts are
``copy_chunk`` and ``copy_chunk_ppermute``.

Operands have their real lengths.  The JAX package pads every phase to a
bucket (lane-0 replication in the batched generation, out-of-bounds
sentinel lanes in the megastep), which XLA drops or clamps, to keep its
compile cache small; eager PyTorch has no such cache, and an out-of-bounds
index raises on the CPU and device-asserts on CUDA.  So the port ships no
padding, and an empty phase gets an empty tensor and is skipped.  Padding
comes back with CUDA-graph capture, together with a trash slot in the pool.

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


# --------------------------------------------------------------------------
# Per-area dispatch (the legacy generation): one program per chunk and per
# area, the destination region a plain argument.
# --------------------------------------------------------------------------


def begin_area(state: LeapState, block_ids: torch.Tensor) -> LeapState:
    """Open a copy epoch: mark blocks in flight, clear their dirty bits."""
    return begin_areas(state, block_ids)


def copy_chunk(
    state: LeapState,
    block_ids: torch.Tensor,
    dst_slots: torch.Tensor,
    dst_region: int,
) -> LeapState:
    """Physical copy of ``block_ids`` into ``(dst_region, dst_slots)``.

    Pure data movement — the table is untouched, so readers keep hitting the
    source location (non-atomic copy phase, exactly as in the paper).  The
    payload is gathered into a new tensor before it is scattered.
    """
    loc = state.table[block_ids].long()
    state.pool[dst_region][dst_slots] = state.pool[loc[:, REGION], loc[:, SLOT]]
    return state


def copy_chunk_ppermute(
    state: LeapState,
    block_ids: torch.Tensor,
    dst_slots: torch.Tensor,
    src_region: int,
    dst_region: int,
    mesh,
) -> LeapState:
    """Point-to-point copy of exactly one area chunk's bytes.

    The single-controller form of the JAX package's ``shard_map`` +
    ``ppermute`` program with static ``(src_region, dst_region)``: the
    chunk's source slots are packed by plain indexing on the source
    region's device, the buffer moves to the destination region's device
    (on a one-device mesh it is already there), and it is unpacked into the
    destination slots.
    """
    slots = state.table[block_ids, SLOT].long()
    buf = state.pool[src_region][slots].to(mesh.device(dst_region), non_blocking=True)
    state.pool[dst_region][dst_slots] = buf
    return state


def commit_area(
    state: LeapState,
    block_ids: torch.Tensor,
    dst_slots: torch.Tensor,
    dst_region: int,
) -> tuple[LeapState, torch.Tensor]:
    """The atomic remap of one area: flip the table entries of clean blocks;
    return the dirty verdict (True = copy invalidated)."""
    return commit_areas(state, block_ids, torch.full_like(dst_slots, dst_region), dst_slots)


def force_migrate(
    state: LeapState,
    block_ids: torch.Tensor,
    dst_slots: torch.Tensor,
    dst_region: int,
) -> LeapState:
    """Fused copy+remap of one area (write-through escalation): no race
    window exists.  The payload is gathered before it is scattered."""
    return force_areas(state, block_ids, torch.full_like(dst_slots, dst_region), dst_slots)


# --------------------------------------------------------------------------
# Batched dispatch: one program per tick phase, multi-area.
#
# Each program updates the state in place and returns it (the commits also
# return their verdicts).  The JAX package pads these operands to geometric
# buckets by replicating lane 0; the port ships the real lengths.
# --------------------------------------------------------------------------


def begin_areas(state: LeapState, block_ids: torch.Tensor) -> LeapState:
    """Open copy epochs for every area scheduled this tick."""
    state.in_flight.index_fill_(0, block_ids, True)
    state.dirty.index_fill_(0, block_ids, False)
    return state


def fused_copy(
    state: LeapState,
    src_flat: torch.Tensor,
    dst_flat: torch.Tensor,
    impl: str | None = None,
) -> LeapState:
    """Physical copy of the tick's chunk plan: flat slot ids (``region * S +
    slot``) through the ``leap_copy`` kernel over the flat pool view."""
    ops.copy_blocks_impl(flat_pool_view(state.pool), src_flat, dst_flat, impl=impl)
    return state


def fused_copy_runs(
    state: LeapState,
    src_starts: torch.Tensor,
    dst_starts: torch.Tensor,
    run: int,
    impl: str | None = None,
) -> LeapState:
    """Physical copy of whole huge blocks: one contiguous ``run``-slot move
    per block, from flat G-aligned start slots."""
    ops.copy_runs_impl(flat_pool_view(state.pool), src_starts, dst_starts, run=run, impl=impl)
    return state


def commit_areas(
    state: LeapState,
    block_ids: torch.Tensor,
    dst_regions: torch.Tensor,
    dst_slots: torch.Tensor,
) -> tuple[LeapState, torch.Tensor]:
    """Atomic remap of every commit-ready area: flip the table entries of
    clean blocks; return the packed dirty verdict (True = copy invalidated)."""
    table = state.table
    verdict = state.dirty[block_ids]  # a new tensor: later phases may clear dirty
    proposed = _entries(dst_regions, dst_slots, table.dtype)
    table[block_ids] = torch.where(verdict[:, None], table[block_ids], proposed)
    state.in_flight.index_fill_(0, block_ids, False)
    return state, verdict


def commit_groups(
    state: LeapState,
    block_ids: torch.Tensor,
    dst_regions: torch.Tensor,
    dst_starts: torch.Tensor,
    group: int,
) -> tuple[LeapState, torch.Tensor]:
    """All-or-nothing remap of huge areas; one verdict lane per group.

    ``block_ids`` is ``[K * group]`` (K huge areas' members, group-major); a
    group is dirty iff any member was written during its copy epoch.
    """
    table = state.table
    k = dst_starts.shape[0]
    members = block_ids.view(k, group)
    verdict = state.dirty[members].any(dim=1)
    member_slots = dst_starts[:, None] + torch.arange(group, device=table.device)[None, :]
    proposed = _entries(dst_regions[:, None].expand(k, group), member_slots, table.dtype)
    new = torch.where(verdict[:, None, None], table[members], proposed)
    table[block_ids] = new.view(-1, 2)
    state.in_flight.index_fill_(0, block_ids, False)
    return state, verdict


def force_areas(
    state: LeapState,
    block_ids: torch.Tensor,
    dst_regions: torch.Tensor,
    dst_slots: torch.Tensor,
) -> LeapState:
    """Batched write-through escalation, in place: fused copy+flip.  The
    payload is gathered before it is scattered."""
    loc = state.table[block_ids].long()
    state.pool[dst_regions, dst_slots] = state.pool[loc[:, REGION], loc[:, SLOT]]
    state.table[block_ids] = _entries(dst_regions, dst_slots, state.table.dtype)
    state.in_flight.index_fill_(0, block_ids, False)
    state.dirty.index_fill_(0, block_ids, False)
    return state


def zero_fill(state: LeapState, slots: torch.Tensor, dst_region: int) -> LeapState:
    """Zero destination slots before a copy lands (page-fault analogue of
    the fresh-destination schedulers)."""
    state.pool[dst_region].index_fill_(0, slots, 0)
    return state


def fused_copy_ppermute(
    state: LeapState,
    src_slots: torch.Tensor,
    dst_slots: torch.Tensor,
    src_region: int,
    dst_region: int,
    mesh,
    impl: str | None = None,
) -> LeapState:
    """Point-to-point copy of one (src, dst) region pair's traffic this tick.

    The single-controller form of the JAX ``shard_map`` + ``ppermute``
    program: ``gather_blocks`` packs the source region's slots into a
    staging buffer, ``Tensor.to`` moves it to the destination region's
    device (the point-to-point transfer; on a one-device mesh the buffer
    is already there and no bytes cross a link), and ``scatter_blocks``
    unpacks it into the destination slots.  Each kernel sees one region's
    shard of the flat pool, ``flat_pool_view(pool[r:r+1])``.
    """
    pool = state.pool
    src = flat_pool_view(pool[src_region : src_region + 1])
    buf = ops.gather_blocks_impl(src, src_slots, impl=impl)
    buf = buf.to(mesh.device(dst_region), non_blocking=True)
    dst = flat_pool_view(pool[dst_region : dst_region + 1])
    ops.scatter_blocks_impl(dst, dst_slots, buf, impl=impl)
    return state


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


# --------------------------------------------------------------------------
# Megastep dispatch: the whole tick as one sequence of programs.
# --------------------------------------------------------------------------


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
    copy and run phases come after force; heat touches nothing else.  Each
    phase is the batched program of the same name, skipped when empty.
    """
    empty = torch.zeros(0, dtype=torch.bool, device=state.device)
    verdict_small = verdict_groups = empty
    if commit_ids.shape[0]:
        state, verdict_small = commit_areas(state, commit_ids, commit_regions, commit_slots)
    if grp_starts.shape[0]:
        state, verdict_groups = commit_groups(state, grp_members, grp_regions, grp_starts, group)
    if begin_ids.shape[0]:
        begin_areas(state, begin_ids)
    if zero_flat.shape[0]:
        flat_pool_view(state.pool).index_fill_(0, zero_flat, 0)
    if force_ids.shape[0]:
        force_areas(state, force_ids, force_regions, force_slots)
    if copy_src.shape[0]:
        fused_copy(state, copy_src, copy_dst, impl=impl)
    if run_src.shape[0]:
        fused_copy_runs(state, run_src, run_dst, group, impl=impl)
    if heat_ids.shape[0]:
        heat = heat_update(heat, heat_ids, heat_w, heat_decay, impl=impl)
    return state, verdict_small, verdict_groups, heat


# --------------------------------------------------------------------------
# Compile-cache introspection (control-path cost accounting)
# --------------------------------------------------------------------------

_PROGRAMS = (
    "megastep",
    "heat_update",
    "zero_fill",
    "begin_area",
    "copy_chunk",
    "copy_chunk_ppermute",
    "commit_area",
    "force_migrate",
    "begin_areas",
    "fused_copy",
    "fused_copy_runs",
    "commit_areas",
    "commit_groups",
    "force_areas",
    "fused_copy_ppermute",
)


def program_cache_sizes() -> dict[str, int]:
    """Compiled-variant count per migration program: always zero, since
    PyTorch runs eagerly and compiles nothing (the JAX package counts its
    XLA compiles here)."""
    return {name: 0 for name in _PROGRAMS}


def program_cache_size() -> int:
    """Total compiled migration-program variants (zero; see above)."""
    return sum(program_cache_sizes().values())
