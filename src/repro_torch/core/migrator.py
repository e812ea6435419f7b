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
    destination region a static argument; the legacy baseline that the
    paper's figures measure the fused generations against.  Apart from the
    force, which moves its payload through the ``copy_blocks`` kernel, they
    are plain tensor indexing, as in the JAX package;
  * the batched programs (``begin_areas``/``zero_fill``/``force_areas``/
    ``fused_copy``/``fused_copy_runs``/``fused_copy_ppermute``/
    ``commit_areas``/``commit_groups``/``heat_update``): one program per
    tick phase, each covering every area the driver scheduled this tick;
  * :func:`megastep`: the whole tick — the previous epoch's commits, then
    begin/zero/force/copy/runs/heat — as one program built from those
    programs' launches.

Every program runs on the current stream over the state's tensors in place.
Two copy backends: ``xla`` moves flat slot ids through ``fused_copy`` (the
``copy_blocks`` kernel over the flat pool view), and ``ppermute`` moves one
(src, dst) region pair at a time through ``fused_copy_ppermute`` (the
``gather_blocks`` and ``scatter_blocks`` kernels around a point-to-point
transfer on a region mesh).  The legacy generation's counterparts are
``copy_chunk`` and ``copy_chunk_ppermute``.

Every program is compiled the way the JAX package jits it: it goes through
its own :class:`~repro_torch.core.graphs.Program` in :data:`PROGRAMS`, the
port's counterpart of a jitted function's cache, keyed on what that cache
keys on (operand lengths, static arguments, the state's or the heat
plane's shapes and dtypes, the device).  On CUDA each variant is one
captured CUDA graph and a call is one replay; on the CPU the variant is
only registered and the program runs eagerly.  The dispatch stage pads the
batched programs and the megastep to the reference's buckets, so a drain
needs few variants; the per-area programs run at their real lengths, as in
the reference.  The reference pads the megastep with out-of-bounds sentinel
lanes, which XLA drops; an out-of-bounds index would raise here, so every
pad lane replicates lane 0 (the reference's own ``pad_to_bucket`` rule),
which each program applies idempotently, and pad heat lanes carry weight
0.  An empty megastep phase gets an empty tensor and is left out of the
variant.  The megastep's phases call the programs' bodies, not the
programs: the megastep's capture registers nothing else, as tracing the
JAX megastep compiles no other migration program.

A program returns the state it updated in place (the commits also their
verdicts, the heat pass its plane).  A replay's verdict is its graph's own
tensor, which the next replay overwrites: ``VerdictFuture`` copies it at
once, on the same stream.

No program synchronises with the host: there is no ``.item()``, no
boolean-mask indexing and no ``nonzero``.  Index operands are int64, on the
host or on the state's device; ``table`` stays int32.
"""

from __future__ import annotations

import torch

from repro_torch.core import graphs
from repro_torch.core.state import REGION, SLOT, LeapState, flat_pool_view
from repro_torch.kernels import ops

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

# One variant cache per program of the JAX package's ``_PROGRAMS``.
PROGRAMS = {name: graphs.Program(name) for name in _PROGRAMS}
MEGASTEP = PROGRAMS["megastep"]


def _entries(regions: torch.Tensor, slots: torch.Tensor, dtype) -> torch.Tensor:
    return torch.stack([regions, slots], dim=-1).to(dtype)


def _state_key(state: LeapState) -> tuple:
    return (tuple(state.pool.shape), state.pool.dtype, tuple(state.table.shape),
            str(state.device))


def _bound(state: LeapState) -> list[torch.Tensor]:
    return [state.pool, state.table, state.dirty, state.in_flight]


def _run(name: str, body, state: LeapState, operands, *static):
    """``body(state, *operands, *static)`` as a variant of ``PROGRAMS[name]``,
    keyed on the operands' lengths, the static arguments and the state."""
    key = (tuple(t.shape[0] for t in operands), static, _state_key(state))
    return PROGRAMS[name](key, lambda *ops_: body(state, *ops_, *static), list(operands),
                          _bound(state))


# --------------------------------------------------------------------------
# The programs' bodies, on device tensors.  Each updates the state in place
# and returns only what the program outputs (a verdict, or nothing): a body
# must not return a tensor its graph is bound to.
# --------------------------------------------------------------------------


def _begin(state: LeapState, block_ids: torch.Tensor) -> None:
    state.in_flight.index_fill_(0, block_ids, True)
    state.dirty.index_fill_(0, block_ids, False)


def _copy_chunk(state: LeapState, block_ids, dst_slots, dst_region: int) -> None:
    loc = state.table[block_ids].long()
    state.pool[dst_region][dst_slots] = state.pool[loc[:, REGION], loc[:, SLOT]]


def _copy_chunk_ppermute(state: LeapState, block_ids, dst_slots, src_region: int,
                         dst_region: int, mesh) -> None:
    slots = state.table[block_ids, SLOT].long()
    buf = state.pool[src_region][slots].to(mesh.device(dst_region), non_blocking=True)
    state.pool[dst_region][dst_slots] = buf


def _commit(state: LeapState, block_ids, dst_regions, dst_slots) -> torch.Tensor:
    table = state.table
    verdict = state.dirty[block_ids]  # a new tensor: later phases may clear dirty
    proposed = _entries(dst_regions, dst_slots, table.dtype)
    table[block_ids] = torch.where(verdict[:, None], table[block_ids], proposed)
    state.in_flight.index_fill_(0, block_ids, False)
    return verdict


def _commit_area(state: LeapState, block_ids, dst_slots, dst_region: int) -> torch.Tensor:
    return _commit(state, block_ids, torch.full_like(dst_slots, dst_region), dst_slots)


def _commit_groups(state: LeapState, block_ids, dst_regions, dst_starts,
                   group: int) -> torch.Tensor:
    table = state.table
    k = dst_starts.shape[0]
    members = block_ids.view(k, group)
    verdict = state.dirty[members].any(dim=1)
    member_slots = dst_starts[:, None] + torch.arange(group, device=table.device)[None, :]
    proposed = _entries(dst_regions[:, None].expand(k, group), member_slots, table.dtype)
    new = torch.where(verdict[:, None, None], table[members], proposed)
    table[block_ids] = new.view(-1, 2)
    state.in_flight.index_fill_(0, block_ids, False)
    return verdict


def _force(state: LeapState, block_ids, dst_regions, dst_slots) -> None:
    """The fused copy+flip, its payload moved by one ``copy_blocks`` launch
    over the flat pool view (no payload temporary).  Its destinations are
    fresh slots, never a source in the same batch (K1's contract); a pad
    lane repeats lane 0's copy."""
    s = state.pool.shape[1]
    loc = state.table[block_ids].long()
    ops.copy_blocks_impl(flat_pool_view(state.pool), loc[:, REGION] * s + loc[:, SLOT],
                         dst_regions * s + dst_slots)
    state.table[block_ids] = _entries(dst_regions, dst_slots, state.table.dtype)
    state.in_flight.index_fill_(0, block_ids, False)
    state.dirty.index_fill_(0, block_ids, False)


def _force_migrate(state: LeapState, block_ids, dst_slots, dst_region: int) -> None:
    _force(state, block_ids, torch.full_like(dst_slots, dst_region), dst_slots)


def _zero_fill(state: LeapState, slots, dst_region: int) -> None:
    state.pool[dst_region].index_fill_(0, slots, 0)


def _fused_copy(state: LeapState, src_flat, dst_flat, impl) -> None:
    ops.copy_blocks_impl(flat_pool_view(state.pool), src_flat, dst_flat, impl=impl)


def _fused_copy_runs(state: LeapState, src_starts, dst_starts, run: int, impl) -> None:
    ops.copy_runs_impl(flat_pool_view(state.pool), src_starts, dst_starts, run=run, impl=impl)


def _fused_copy_ppermute(state: LeapState, src_slots, dst_slots, src_region: int,
                         dst_region: int, mesh, impl) -> None:
    pool = state.pool
    src = flat_pool_view(pool[src_region : src_region + 1])
    buf = ops.gather_blocks_impl(src, src_slots, impl=impl)
    buf = buf.to(mesh.device(dst_region), non_blocking=True)
    dst = flat_pool_view(pool[dst_region : dst_region + 1])
    ops.scatter_blocks_impl(dst, dst_slots, buf, impl=impl)


# --------------------------------------------------------------------------
# Per-area dispatch (the legacy generation): one program per chunk and per
# area, the destination region a static argument, real lengths.
# --------------------------------------------------------------------------


def begin_area(state: LeapState, block_ids: torch.Tensor) -> LeapState:
    """Open a copy epoch: mark blocks in flight, clear their dirty bits."""
    _run("begin_area", _begin, state, (block_ids,))
    return state


def copy_chunk(
    state: LeapState,
    block_ids: torch.Tensor,
    dst_slots: torch.Tensor,
    dst_region: int,
) -> LeapState:
    """Physical copy of ``block_ids`` into ``(dst_region, dst_slots)``.

    Pure data movement — the table is untouched, so readers keep hitting the
    source location (non-atomic copy phase, exactly as in the paper).  The
    payload is gathered into a temporary (one chunk) before it is scattered.
    """
    _run("copy_chunk", _copy_chunk, state, (block_ids, dst_slots), int(dst_region))
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
    _run("copy_chunk_ppermute", _copy_chunk_ppermute, state, (block_ids, dst_slots),
         int(src_region), int(dst_region), mesh)
    return state


def commit_area(
    state: LeapState,
    block_ids: torch.Tensor,
    dst_slots: torch.Tensor,
    dst_region: int,
) -> tuple[LeapState, torch.Tensor]:
    """The atomic remap of one area: flip the table entries of clean blocks;
    return the dirty verdict (True = copy invalidated)."""
    return state, _run("commit_area", _commit_area, state, (block_ids, dst_slots),
                       int(dst_region))


def force_migrate(
    state: LeapState,
    block_ids: torch.Tensor,
    dst_slots: torch.Tensor,
    dst_region: int,
) -> LeapState:
    """Fused copy+remap of one area (write-through escalation): no race
    window exists.  The payload moves through the ``copy_blocks`` kernel;
    the destinations must not be sources of the same call."""
    _run("force_migrate", _force_migrate, state, (block_ids, dst_slots), int(dst_region))
    return state


# --------------------------------------------------------------------------
# Batched dispatch: one program per tick phase, multi-area.  The dispatch
# stage pads the operands to geometric buckets by replicating lane 0, as the
# JAX package does; every program applies a repeated lane idempotently.
# --------------------------------------------------------------------------


def begin_areas(state: LeapState, block_ids: torch.Tensor) -> LeapState:
    """Open copy epochs for every area scheduled this tick."""
    _run("begin_areas", _begin, state, (block_ids,))
    return state


def fused_copy(
    state: LeapState,
    src_flat: torch.Tensor,
    dst_flat: torch.Tensor,
    impl: str | None = None,
) -> LeapState:
    """Physical copy of the tick's chunk plan: flat slot ids (``region * S +
    slot``) through the ``leap_copy`` kernel over the flat pool view."""
    _run("fused_copy", _fused_copy, state, (src_flat, dst_flat), impl)
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
    _run("fused_copy_runs", _fused_copy_runs, state, (src_starts, dst_starts), int(run), impl)
    return state


def commit_areas(
    state: LeapState,
    block_ids: torch.Tensor,
    dst_regions: torch.Tensor,
    dst_slots: torch.Tensor,
) -> tuple[LeapState, torch.Tensor]:
    """Atomic remap of every commit-ready area: flip the table entries of
    clean blocks; return the packed dirty verdict (True = copy invalidated)."""
    return state, _run("commit_areas", _commit, state, (block_ids, dst_regions, dst_slots))


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
    return state, _run("commit_groups", _commit_groups, state,
                       (block_ids, dst_regions, dst_starts), int(group))


def force_areas(
    state: LeapState,
    block_ids: torch.Tensor,
    dst_regions: torch.Tensor,
    dst_slots: torch.Tensor,
) -> LeapState:
    """Batched write-through escalation, in place: fused copy+flip, the
    payload moved by one ``copy_blocks`` launch (flat ids computed on the
    device from the table as it stands).  The destinations must not be
    sources of the same call."""
    _run("force_areas", _force, state, (block_ids, dst_regions, dst_slots))
    return state


def zero_fill(state: LeapState, slots: torch.Tensor, dst_region: int) -> LeapState:
    """Zero destination slots before a copy lands (page-fault analogue of
    the fresh-destination schedulers)."""
    _run("zero_fill", _zero_fill, state, (slots,), int(dst_region))
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
    shard of the flat pool, ``flat_pool_view(pool[r:r+1])``.  Captured, the
    staging buffer stays in the graph: it is the transfer.
    """
    _run("fused_copy_ppermute", _fused_copy_ppermute, state, (src_slots, dst_slots),
         int(src_region), int(dst_region), mesh, impl)
    return state


def heat_update(
    heat: torch.Tensor,
    ids: torch.Tensor,
    w: torch.Tensor,
    decay: float,
    impl: str | None = None,
) -> torch.Tensor:
    """Standalone access-heat pass, in place (under megastep the same update
    rides the tick as its trailing phase).  ``w`` is float32; a pad lane
    repeats lane 0's id with weight 0."""
    key = (ids.shape[0], w.shape[0], float(decay), impl, tuple(heat.shape), heat.dtype,
           str(heat.device))

    def body(ids_, w_):
        ops.heat_scan_impl(heat, ids_, w_, decay, impl=impl)

    PROGRAMS["heat_update"](key, body, [ids, w], [heat])
    return heat


# --------------------------------------------------------------------------
# Megastep dispatch: the whole tick as one program.
# --------------------------------------------------------------------------


def _megastep_phases(
    state: LeapState,
    commit_ids, commit_regions, commit_slots,
    grp_members, grp_regions, grp_starts,
    begin_ids, zero_flat,
    force_ids, force_regions, force_slots,
    copy_src, copy_dst, run_src, run_dst,
    heat, heat_ids, heat_w,
    group: int, impl: str | None, heat_decay: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The megastep's launches; returns its verdicts ``(small, groups)``."""
    empty = torch.zeros(0, dtype=torch.bool, device=state.device)
    verdict_small = verdict_groups = empty
    if commit_ids.shape[0]:
        verdict_small = _commit(state, commit_ids, commit_regions, commit_slots)
    if grp_starts.shape[0]:
        verdict_groups = _commit_groups(state, grp_members, grp_regions, grp_starts, group)
    if begin_ids.shape[0]:
        _begin(state, begin_ids)
    if zero_flat.shape[0]:
        flat_pool_view(state.pool).index_fill_(0, zero_flat, 0)
    if force_ids.shape[0]:
        _force(state, force_ids, force_regions, force_slots)
    if copy_src.shape[0]:
        _fused_copy(state, copy_src, copy_dst, impl)
    if run_src.shape[0]:
        _fused_copy_runs(state, run_src, run_dst, group, impl)
    if heat_ids.shape[0]:
        ops.heat_scan_impl(heat, heat_ids, heat_w, heat_decay, impl=impl)
    return verdict_small, verdict_groups


def _megastep_variant(state: LeapState, operands, heat, group, impl, heat_decay):
    """``(key, body, inputs, bound)`` of one megastep call for :data:`MEGASTEP`.

    The key holds what the JAX megastep's cache keys on: every operand's
    length (which phases are present and at which bucket), the static
    arguments, the state's and the heat plane's shapes and dtypes, and the
    device.  The program updates the state in place, and the heat plane when
    its phase is present: those are the tensors a captured graph belongs to.
    """
    inputs = list(operands)  # the 16 index operands (heat_ids last), then heat_w
    key = (
        tuple(t.shape[0] for t in inputs),
        group, impl, float(heat_decay),
        tuple(state.pool.shape), state.pool.dtype, tuple(state.table.shape),
        tuple(heat.shape), str(state.device),
    )
    with_heat = bool(inputs[15].shape[0])
    bound = _bound(state) + ([heat] if with_heat else [])

    def body(*ops_):
        return _megastep_phases(state, *ops_[:15], heat, ops_[15], ops_[16],
                                group=group, impl=impl, heat_decay=heat_decay)

    return key, body, inputs, bound


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
    and the post-zero pool; the copy and run phases come after force; heat
    touches nothing else.  Each phase is the body of the batched program of
    the same name, left out when empty.

    Index operands are int64 and ``heat_w`` float32, on the host or on the
    state's device.  The call is one variant of :data:`MEGASTEP`: on CUDA a
    replay of its captured graph, whose verdicts are static tensors that the
    next replay of the same graph overwrites (``VerdictFuture`` copies them
    first, on the same stream).
    """
    operands = (commit_ids, commit_regions, commit_slots, grp_members, grp_regions, grp_starts,
                begin_ids, zero_flat, force_ids, force_regions, force_slots, copy_src, copy_dst,
                run_src, run_dst, heat_ids, heat_w)
    verdict_small, verdict_groups = MEGASTEP(
        *_megastep_variant(state, operands, heat, group, impl, heat_decay))
    return state, verdict_small, verdict_groups, heat


def warm_megastep(state: LeapState, *operands, heat: torch.Tensor, group: int = 1,
                  impl: str | None = None, heat_decay: float = 1.0) -> None:
    """Compile the megastep variant of these operands ahead of time: capture
    it on CUDA, register it on the CPU.  Nothing runs; the operands (the
    megastep's, ``heat_ids`` and ``heat_w`` last) give lengths only."""
    MEGASTEP.warm(*_megastep_variant(state, operands, heat, group, impl, heat_decay))


# --------------------------------------------------------------------------
# Compile-cache introspection (control-path cost accounting)
# --------------------------------------------------------------------------


def program_cache_sizes() -> dict[str, int]:
    """Compiled-variant count per migration program (process-wide), as the
    JAX package counts its XLA compiles; the driver differences the total
    to report ``MigrationStats.jit_cache_misses``."""
    return {name: len(prog) for name, prog in PROGRAMS.items()}


def program_cache_size() -> int:
    """Total compiled migration-program variants (process-wide)."""
    return sum(program_cache_sizes().values())


def clear_program_caches() -> None:
    """Forget every program's variants and graphs (each reference program's
    ``clear_cache()``)."""
    for prog in PROGRAMS.values():
        prog.clear()
