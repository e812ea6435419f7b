"""Leap pool state: the device-resident data plane of `page_leap()`.

The paper separates *virtual* pages (what the application names) from
*physical* pages (where bytes live) and migrates by copying physically and
re-mapping virtually.  Here the same separation is:

  logical block id  (0..n_blocks)    -- what the application names
  (region, slot)                     -- where the bytes live: ``pool[r, s]``

``pool`` is a single pre-allocated tensor ``[n_regions, slots_per_region,
*block_shape]`` on one device ("NUMA region" ≙ a slice of device memory),
or, once placed on a region mesh (:func:`state_sharding`), one tensor per
region on that region's device (see :class:`LeapState`).
The ``table`` maps logical blocks to their physical location (it is the page
table).  ``dirty`` and ``in_flight`` implement the paper's write-detection
protocol: a write to a block that is currently being copied marks it dirty,
which causes the commit (the atomic "remap") to reject and requeue the block.

Where the JAX package donates buffers to pure programs, the port updates
the tensors of a :class:`LeapState` in place: ``leap_write`` and the
migration programs mutate ``pool``/``table``/``dirty``/``in_flight`` and
return the same state object.  ``table`` stays ``int32`` and initial slots
are assigned densely in block-id order, because the host mirrors of the
driver depend on both.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import graphs
from repro_torch.topology import NumaTopology

REGION = 0  # column index of the region coordinate in ``table``
SLOT = 1  # column index of the slot coordinate in ``table``


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Static description of a leap pool.

    Attributes:
      n_regions: number of memory regions (NUMA analogue).
      slots_per_region: physical capacity of each region, in blocks.
      block_shape: shape of one block's payload (e.g. ``(rows, cols)`` for a
        morsel pool or ``(blk_tokens, 2, kv_heads, head_dim)`` for KV).
      dtype: payload dtype (a ``torch.dtype``).
      region_axis: name of the mesh axis the region dim lies along, or None
        for a pool that no mesh describes; :func:`state_sharding` checks it
        against the mesh of the ppermute copy backend.
      huge_factor: G — small slots per huge block (two-tier pool; 1 = small
        only).  A huge block is G physically-contiguous, G-aligned slots in
        one region whose G logical blocks share one level-1 table entry.
        Must be a power of two dividing slots_per_region so huge runs never
        straddle a region boundary.
      topology: optional :class:`repro_torch.topology.NumaTopology`
        describing region-pair distances and per-link bandwidth budgets.
    """

    n_regions: int
    slots_per_region: int
    block_shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    region_axis: str | tuple[str, ...] | None = None
    huge_factor: int = 1
    topology: "NumaTopology | None" = None

    def __post_init__(self):
        g = self.huge_factor
        if g < 1 or (g & (g - 1)) != 0:
            raise ValueError(f"huge_factor must be a power of two, got {g}")
        if self.slots_per_region % g != 0:
            raise ValueError(
                f"huge_factor {g} must divide slots_per_region "
                f"{self.slots_per_region}"
            )
        if self.topology is not None and self.topology.n_regions != self.n_regions:
            raise ValueError(
                f"topology covers {self.topology.n_regions} regions, "
                f"pool has {self.n_regions}"
            )

    @property
    def block_elems(self) -> int:
        return int(np.prod(self.block_shape))

    @property
    def block_bytes(self) -> int:
        return self.block_elems * self.dtype.itemsize

    @property
    def capacity_blocks(self) -> int:
        return self.n_regions * self.slots_per_region


@dataclasses.dataclass
class LeapState:
    """Device-resident migration state, updated in place.

    pool:      [R, S, *block_shape]  physical storage, region-major; or, on a
                                     region mesh, a tuple of R shards, shard r
                                     ``[S + 1, *block_shape]`` on the region's
                                     device in its own allocation, its last
                                     row a sink that masked-off lanes of a
                                     write land in (never read).
    table:     [N, 2] int32          logical block -> (region, slot).
    dirty:     [N]    bool           written while in flight (invalidates copy).
    in_flight: [N]    bool           currently under an open copy epoch.

    ``pool[r]`` is region r's storage in either layout (a view ``[S, ...]``
    of the one tensor, or the shard).  The table and flags live on the home
    device, :attr:`device`.
    """

    pool: torch.Tensor | tuple[torch.Tensor, ...]
    table: torch.Tensor
    dirty: torch.Tensor
    in_flight: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return self.table.shape[0]

    @property
    def device(self) -> torch.device:
        """The home device: the table's, the flags' and region 0's."""
        return self.table.device

    @property
    def sharded(self) -> bool:
        """Whether the pool is one tensor per region (placed on a region mesh)."""
        return isinstance(self.pool, tuple)

    @property
    def pool_shape(self) -> tuple[int, ...]:
        """``(R, S, *block_shape)`` in either layout."""
        if self.sharded:
            shard = self.pool[0]
            return (len(self.pool), shard.shape[0] - 1) + tuple(shard.shape[1:])
        return tuple(self.pool.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.pool[0].dtype

    @property
    def regions(self) -> list[torch.Tensor]:
        """Each region's slots ``[S, *block_shape]`` (views, sink rows left out)."""
        s = self.pool_shape[1]
        return [self.pool[r][:s] for r in range(self.pool_shape[0])]

    @property
    def devices(self) -> list[torch.device]:
        """Every device the state lives on, the home device first."""
        out = [self.device]
        for t in state_tensors(self):
            if t.device not in out:
                out.append(t.device)
        return out

    @classmethod
    def from_numpy(cls, pool, table, dirty, in_flight, device) -> "LeapState":
        """State from host arrays, e.g. ``np.asarray`` of each leaf of the JAX
        package's state, so that both packages start from the same bytes.

        A numpy dtype torch lacks (bfloat16 from ``ml_dtypes``) crosses as
        raw bits of the same width and is reinterpreted.
        """
        return cls(
            pool=_tensor_from_host(pool, device),
            table=_tensor_from_host(np.asarray(table, np.int32), device),
            dirty=_tensor_from_host(np.asarray(dirty, bool), device),
            in_flight=_tensor_from_host(np.asarray(in_flight, bool), device),
        )

    def to(self, placement: "LeapState") -> "LeapState":
        """This state where ``placement`` (from :func:`state_sharding`, or a
        ``LeapState`` of devices) puts it: a tuple of devices for the pool
        makes one shard per region, each a new allocation; a single device
        makes one pool tensor again.  Tensors already in place are kept, and
        a state already placed is returned as it is."""
        flags = [getattr(self, n).to(getattr(placement, n)) for n in ("table", "dirty", "in_flight")]
        if isinstance(placement.pool, tuple):
            devices = tuple(map(torch.device, placement.pool))
            pool = self.pool
            if not self.sharded or tuple(t.device for t in pool) != devices:
                pool = tuple(_shard(region, d) for region, d in zip(self.regions, devices))
        elif self.sharded:
            pool = torch.stack([region.to(placement.pool) for region in self.regions])
        else:
            pool = self.pool.to(placement.pool)
        if pool is self.pool and all(a is b for a, b in zip(flags, (self.table, self.dirty,
                                                                    self.in_flight))):
            return self
        return LeapState(pool, *flags)

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Host copies ``(pool, table, dirty, in_flight)``, the pool as one
        ``[R, S, *block_shape]`` array in either layout; a bfloat16 pool
        comes back as float32 (numpy has no bfloat16 of its own)."""
        pool = torch.stack([region.detach().cpu() for region in self.regions])
        if pool.dtype == torch.bfloat16:
            pool = pool.float()
        return (
            pool.numpy(),
            self.table.cpu().numpy().copy(),
            self.dirty.cpu().numpy().copy(),
            self.in_flight.cpu().numpy().copy(),
        )


def _shard(region: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Region slots ``[S, *blk]`` as a new ``[S + 1, *blk]`` tensor on
    ``device``, its sink row zero."""
    out = torch.empty((region.shape[0] + 1,) + tuple(region.shape[1:]), dtype=region.dtype,
                      device=device)
    out[:-1].copy_(region)
    out[-1].zero_()
    return out


def _tensor_from_host(arr, device) -> torch.Tensor:
    arr = np.array(arr)  # a writable host copy the tensor may own
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _default_device(device=None) -> torch.device:
    """``device`` if given; else the current CUDA device, which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def init_state(
    cfg: PoolConfig,
    n_blocks: int,
    initial_regions: Sequence[int] | np.ndarray,
    device=None,
) -> LeapState:
    """Create a pool with ``n_blocks`` logical blocks placed per ``initial_regions``.

    Blocks are assigned slots densely within each region, in block-id order
    (the host driver mirrors this allocation).  The state lives on
    ``device``, the current CUDA device by default (raises without one).
    """
    device = _default_device(device)
    initial_regions = np.asarray(initial_regions, dtype=np.int32)
    if initial_regions.shape != (n_blocks,):
        raise ValueError(
            f"initial_regions must have shape ({n_blocks},), got {initial_regions.shape}"
        )
    if n_blocks > cfg.capacity_blocks:
        raise ValueError("more logical blocks than physical capacity")
    if n_blocks and (
        initial_regions.min() < 0 or initial_regions.max() >= cfg.n_regions
    ):
        raise ValueError(
            f"initial_regions must lie in [0, {cfg.n_regions}), got range "
            f"[{initial_regions.min()}, {initial_regions.max()}]"
        )
    # Dense per-region slot assignment in block-id order, vectorized: a stable
    # sort groups blocks by region while preserving id order, so the rank of a
    # block within its group is its slot.
    counts = np.bincount(initial_regions, minlength=cfg.n_regions)
    over = np.nonzero(counts > cfg.slots_per_region)[0]
    if len(over):
        raise ValueError(f"region {over[0]} over capacity during initial placement")
    order = np.argsort(initial_regions, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slots = np.empty(n_blocks, dtype=np.int32)
    slots[order] = np.arange(n_blocks, dtype=np.int32) - np.repeat(
        starts, counts
    ).astype(np.int32)
    table = np.stack([initial_regions, slots], axis=1).astype(np.int32)
    pool = torch.zeros(
        (cfg.n_regions, cfg.slots_per_region) + tuple(cfg.block_shape),
        dtype=cfg.dtype,
        device=device,
    )
    return LeapState(
        pool=pool,
        table=torch.as_tensor(table, device=device),
        dirty=torch.zeros(n_blocks, dtype=torch.bool, device=device),
        in_flight=torch.zeros(n_blocks, dtype=torch.bool, device=device),
    )


def state_sharding(cfg: PoolConfig, mesh) -> LeapState:
    """Where each tensor of a :class:`LeapState` lives on a region ``mesh``
    (a :class:`repro_torch.launch.mesh.RegionMesh`), as a ``LeapState`` of
    ``torch.device`` s for :meth:`LeapState.to`.

    As the JAX package shards the pool's region dim over ``cfg.region_axis``,
    the pool becomes one shard per region on ``mesh.device(r)``, even where
    several regions share a device.  The JAX package replicates the table
    and the flags; the port keeps one copy on the home device
    ``mesh.device(0)`` (beside the driver's host mirror), which every
    program reads from one controller (ROADMAP D5).
    """
    if cfg.region_axis != mesh.axis_name:
        raise ValueError(
            f"pool region_axis {cfg.region_axis!r} is not the mesh axis {mesh.axis_name!r}"
        )
    if mesh.size != cfg.n_regions:
        raise ValueError(f"mesh has {mesh.size} entries for {cfg.n_regions} regions")
    home = mesh.device(0)
    return LeapState(pool=tuple(mesh.devices), table=home, dirty=home, in_flight=home)


# --------------------------------------------------------------------------
# Logical reads / writes through the table.
#
# ``leap_write`` is the SIGSEGV-handler analogue: the framework owns every
# mutation, so "trapping" a write is simply fusing ``dirty |= in_flight`` into
# the write program.  Writes always land at the *current* physical location;
# dirtiness only matters for blocks with an open copy epoch.
#
# Each function is compiled as the JAX package jits it: through its own
# ``graphs.Program`` in ``IO_PROGRAMS``, one variant per length of the ids,
# shape and dtype of the values (rows, row offsets), ``huge_factor`` and
# state shapes; on the card one captured graph over the state's tensors.
# Nothing is padded: a pad lane of a write would write.  Block ids may be
# any integer tensor or array (on the host or the state's device) and values
# any tensor or array: they are the programs' operands, staged to the card
# outside the graph.  The reads hand out fresh tensors, as the reference
# returns a fresh array from every call.  These programs are the
# application's, not migration programs: ``migrator.PROGRAMS`` and
# ``jit_cache_misses`` leave them out, as the reference's ``_PROGRAMS`` does.
#
# Over a sharded pool a lane's region is data, read from the table on the
# device, and a captured graph cannot branch on it.  So the pool programs
# run a static loop over the regions: a read gathers every lane from every
# region (a lane of another region reads slot 0) and keeps, lane by lane,
# the block of its own region; a write writes every region with the lanes
# of other regions sent to its sink row, so that no masked lane overwrites
# a real one and, of duplicate ids, the last still wins as in the one
# tensor.  That reads or writes R times the lanes' bytes; the table and
# flag programs are the same in both layouts.
# --------------------------------------------------------------------------


def host_to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``; on CUDA through pinned memory, so that the
    copy is queued on the current stream without blocking the host."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def as_index(ids, device: torch.device) -> torch.Tensor:
    """Integer ids as an int64 tensor on ``device``."""
    if isinstance(ids, torch.Tensor) and ids.device == device:
        return ids.to(torch.int64)
    return host_to_device(_host_index(ids), device)


def _host_index(ids) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return torch.from_numpy(np.asarray(ids, dtype=np.int64).copy())


def operand_index(ids, device: torch.device) -> torch.Tensor:
    """Ids as an int64 program operand: as they are on ``device``, else on
    the host (the program stages them)."""
    if isinstance(ids, torch.Tensor) and ids.device == device:
        return ids.to(torch.int64)
    return _host_index(ids)


def _operand(values) -> torch.Tensor:
    return values if isinstance(values, torch.Tensor) else torch.as_tensor(np.asarray(values))


IO_PROGRAMS = {
    name: graphs.Program(name, fresh=name not in ("leap_write", "leap_write_rows"))
    for name in ("leap_read", "leap_write", "leap_write_rows", "block_regions", "huge_read",
                 "group_dirty", "group_in_flight")
}


# lanes of a sharded read gathered at once: a chunk's temporaries
# are all a graph keeps beside the output (an 8,192-block read of 64 KiB
# blocks keeps 64 MiB, not R times 512 MiB)
SHARD_CHUNK = 1024


def state_key(state: LeapState) -> tuple:
    """What a program's variant keys on of ``state``: shapes, dtype and
    devices (each shard's on a region mesh)."""
    key = (state.pool_shape, state.dtype, tuple(state.table.shape), str(state.device))
    if state.sharded:
        key += (tuple(str(t.device) for t in state.pool),)
    return key


def state_tensors(state: LeapState) -> list[torch.Tensor]:
    """The tensors a program over ``state`` is bound to (every shard of a
    sharded pool; region 0's first, on the home device)."""
    pool = list(state.pool) if state.sharded else [state.pool]
    return pool + [state.table, state.dirty, state.in_flight]


def _io(name: str, body, state: LeapState, operands, *static):
    """``body(state, *operands, *static)`` as a variant of ``IO_PROGRAMS[name]``,
    keyed on the operands' shapes and dtypes, the static arguments and the
    state."""
    key = (tuple((tuple(t.shape), t.dtype) for t in operands), static, state_key(state))
    return IO_PROGRAMS[name](key, lambda *ops: body(state, *ops, *static), list(operands),
                             state_tensors(state))


def _locate(state: LeapState, block_ids: torch.Tensor):
    loc = state.table[block_ids].long()
    return loc[:, REGION], loc[:, SLOT]


def _lanes(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-lane ``mask`` shaped to broadcast over ``like``'s trailing dims."""
    return mask.view(mask.shape + (1,) * (like.ndim - mask.ndim))


def gather_regions(state: LeapState, region: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``out[i] = pool[region[i]][index[i]]`` on the home device over a
    sharded pool; ``index`` is ``[K]`` or ``[K, G]`` (a run a lane).  A
    static loop over the regions, ``SHARD_CHUNK`` lanes at a time: each
    region's gather on its device, with other regions' lanes at slot 0,
    combined lane by lane on the home device."""
    home, shards = state.device, state.pool
    out = None
    for lo in range(0, max(region.shape[0], 1), SHARD_CHUNK):
        reg, idx = region[lo : lo + SHARD_CHUNK], index[lo : lo + SHARD_CHUNK]
        for r, shard in enumerate(shards):
            mine = reg == r
            part = shard[torch.where(_lanes(mine, idx), idx, 0).to(shard.device)].to(home)
            if out is None:
                out = torch.empty((region.shape[0],) + tuple(part.shape[1:]), dtype=part.dtype,
                                  device=home)
            dst = out[lo : lo + SHARD_CHUNK]
            if r == 0:
                dst.copy_(part)
            else:
                torch.where(_lanes(mine, part), part, dst, out=dst)
    return out


def scatter_regions(state: LeapState, region: torch.Tensor, index: torch.Tensor,
                    values: torch.Tensor, put) -> None:
    """``put(pool[region[i]], index[i], values[i])`` for every lane over a
    sharded pool: one ``put`` a region, on its device, with the lanes of
    other regions at its sink row."""
    for r, shard in enumerate(state.pool):
        sink = shard.shape[0] - 1
        put(shard, torch.where(region == r, index, sink).to(shard.device),
            values.to(shard.device))


def _read(state: LeapState, ids: torch.Tensor) -> torch.Tensor:
    region, slot = _locate(state, ids)
    if state.sharded:
        return gather_regions(state, region, slot)
    return state.pool[region, slot]


def _trap(state: LeapState, ids: torch.Tensor) -> None:
    state.dirty[ids] = state.dirty[ids] | state.in_flight[ids]


def _put(shard, idx, values) -> None:
    shard[idx] = values


def _write(state: LeapState, ids: torch.Tensor, values: torch.Tensor) -> None:
    region, slot = _locate(state, ids)
    values = values.to(state.dtype)
    if state.sharded:
        scatter_regions(state, region, slot, values, _put)
    else:
        state.pool[region, slot] = values
    _trap(state, ids)


def _write_rows(state: LeapState, ids, offs, rows) -> None:
    region, slot = _locate(state, ids)
    rows = rows.to(state.dtype)
    if state.sharded:
        def put(shard, idx, values):
            shard[idx, offs.to(shard.device)] = values

        scatter_regions(state, region, slot, rows, put)
    else:
        state.pool[region, slot, offs] = rows
    _trap(state, ids)


def leap_read(state: LeapState, block_ids) -> torch.Tensor:
    """Gather whole blocks: returns ``[len(block_ids), *block_shape]``."""
    return _io("leap_read", _read, state, [operand_index(block_ids, state.device)])


def leap_write(state: LeapState, block_ids, values) -> LeapState:
    """Overwrite whole blocks in place; marks in-flight blocks dirty."""
    _io("leap_write", _write, state, [operand_index(block_ids, state.device), _operand(values)])
    return state


def leap_write_rows(state: LeapState, block_ids, row_offsets, rows) -> LeapState:
    """Partial-block write in place: one row (first payload dim) per entry.

    ``rows`` has shape ``[K, *block_shape[1:]]``.  Same dirty semantics as
    ``leap_write`` — the paper's protocol does not care how much of the page
    was written, only *that* it was written during an open copy.
    """
    _io("leap_write_rows", _write_rows, state,
        [operand_index(block_ids, state.device), operand_index(row_offsets, state.device),
         _operand(rows)])
    return state


def block_regions(state: LeapState, block_ids) -> torch.Tensor:
    return _io("block_regions", lambda st, ids: st.table[ids, REGION], state,
               [operand_index(block_ids, state.device)])


# --------------------------------------------------------------------------
# Tier-aware (group) semantics.
#
# A huge block is G logical blocks [g*G, (g+1)*G) whose table entries expand
# to one contiguous slot run, so the flat table/dirty/in_flight vectors keep
# working per block; the group views below are the level-1 semantics: a huge
# read is one contiguous slice, and a huge copy epoch is dirtied by a write
# to *any* member (the commit verdict is the OR over the run, exactly like a
# huge-page PTE covering G small pages).  ``huge_factor`` is static, as in
# the reference: a variant each.
# --------------------------------------------------------------------------


def _huge_read(state: LeapState, groups: torch.Tensor, huge_factor: int) -> torch.Tensor:
    region, slot = _locate(state, groups * huge_factor)
    run = torch.arange(huge_factor, device=state.device)
    if state.sharded:
        return gather_regions(state, region, slot[:, None] + run[None, :])
    return state.pool[region[:, None], slot[:, None] + run[None, :]]


def huge_read(state: LeapState, group_ids, huge_factor: int) -> torch.Tensor:
    """Read whole huge blocks: ``[len(group_ids), G, *block_shape]``.

    Resolves one level-1 entry (member 0's location) per group and slices the
    contiguous run — G blocks per table lookup instead of G lookups.
    """
    return _io("huge_read", _huge_read, state, [operand_index(group_ids, state.device)],
               huge_factor)


def _members(state: LeapState, g: torch.Tensor, huge_factor: int) -> torch.Tensor:
    return g[:, None] * huge_factor + torch.arange(huge_factor, device=state.device)[None, :]


def group_dirty(state: LeapState, group_ids, huge_factor: int) -> torch.Tensor:
    """Level-1 dirty view: a group is dirty iff any member is dirty."""
    return _io("group_dirty",
               lambda st, g, hf: st.dirty[_members(st, g, hf)].any(dim=1), state,
               [operand_index(group_ids, state.device)], huge_factor)


def group_in_flight(state: LeapState, group_ids, huge_factor: int) -> torch.Tensor:
    """Level-1 in-flight view: a group is in flight iff any member is."""
    return _io("group_in_flight",
               lambda st, g, hf: st.in_flight[_members(st, g, hf)].any(dim=1), state,
               [operand_index(group_ids, state.device)], huge_factor)


def flat_pool_view(pool: torch.Tensor) -> torch.Tensor:
    """View ``pool [R, S, *blk]`` in the kernel layout ``[R*S, rows, cols]``.

    A (region, slot) pair becomes the flat slot ``region * S + slot``; the
    payload collapses to 2-D (``rows = prod(blk[:-1])``, ``cols = blk[-1]``).
    The result shares storage with ``pool``, so writes through it land in
    the pool (the pool is contiguous).  A sharded pool has no flat view:
    take :func:`region_view` of each region's storage.
    """
    r, s = pool.shape[:2]
    payload = pool.shape[2:]
    rows = int(np.prod(payload[:-1])) if len(payload) > 1 else 1
    cols = int(payload[-1]) if payload else 1
    return pool.view(r * s, rows, cols)


def region_view(storage: torch.Tensor) -> torch.Tensor:
    """One region's storage ``pool[r]`` (a shard, its sink row included, or
    a slice of the one tensor) in the kernel layout ``[slots, rows, cols]``."""
    return flat_pool_view(storage[None])


def placement_histogram(state: LeapState, n_regions: int) -> np.ndarray:
    """Host-side histogram: how many blocks currently live on each region."""
    regions = state.table[:, REGION].cpu().numpy()
    return np.bincount(regions, minlength=n_regions)
