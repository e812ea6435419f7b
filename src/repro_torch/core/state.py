"""Leap pool state: the device-resident data plane of `page_leap()`.

The paper separates *virtual* pages (what the application names) from
*physical* pages (where bytes live) and migrates by copying physically and
re-mapping virtually.  Here the same separation is:

  logical block id  (0..n_blocks)    -- what the application names
  (region, slot)                     -- where the bytes live: ``pool[r, s]``

``pool`` is a single pre-allocated tensor ``[n_regions, slots_per_region,
*block_shape]`` on one device ("NUMA region" ≙ a slice of device memory).
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
      region_axis: mesh axis of the region dim in the JAX package; unused
        until the port's multi-device slice, kept for config parity.
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

    pool:      [R, S, *block_shape]  physical storage, region-major.
    table:     [N, 2] int32          logical block -> (region, slot).
    dirty:     [N]    bool           written while in flight (invalidates copy).
    in_flight: [N]    bool           currently under an open copy epoch.
    """

    pool: torch.Tensor
    table: torch.Tensor
    dirty: torch.Tensor
    in_flight: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return self.table.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pool.device

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

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Host copies ``(pool, table, dirty, in_flight)``; a bfloat16 pool
        comes back as float32 (numpy has no bfloat16 of its own)."""
        pool = self.pool.detach().cpu()
        if pool.dtype == torch.bfloat16:
            pool = pool.float()
        return (
            pool.numpy().copy(),
            self.table.cpu().numpy().copy(),
            self.dirty.cpu().numpy().copy(),
            self.in_flight.cpu().numpy().copy(),
        )


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


# --------------------------------------------------------------------------
# Logical reads / writes through the table.
#
# ``leap_write`` is the SIGSEGV-handler analogue: the framework owns every
# mutation, so "trapping" a write is simply fusing ``dirty |= in_flight`` into
# the write.  Writes always land at the *current* physical location;
# dirtiness only matters for blocks with an open copy epoch.
#
# Block ids may be any integer tensor or array; they go to the state's device
# as int64.
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
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return host_to_device(torch.from_numpy(np.asarray(ids, dtype=np.int64).copy()), device)


def _locate(state: LeapState, block_ids: torch.Tensor):
    loc = state.table[block_ids].long()
    return loc[:, REGION], loc[:, SLOT]


def leap_read(state: LeapState, block_ids) -> torch.Tensor:
    """Gather whole blocks: returns ``[len(block_ids), *block_shape]``."""
    region, slot = _locate(state, as_index(block_ids, state.device))
    return state.pool[region, slot]


def leap_write(state: LeapState, block_ids, values) -> LeapState:
    """Overwrite whole blocks in place; marks in-flight blocks dirty."""
    ids = as_index(block_ids, state.device)
    region, slot = _locate(state, ids)
    state.pool[region, slot] = torch.as_tensor(values, device=state.device).to(
        state.pool.dtype
    )
    state.dirty[ids] = state.dirty[ids] | state.in_flight[ids]
    return state


def leap_write_rows(state: LeapState, block_ids, row_offsets, rows) -> LeapState:
    """Partial-block write in place: one row (first payload dim) per entry.

    ``rows`` has shape ``[K, *block_shape[1:]]``.  Same dirty semantics as
    ``leap_write`` — the paper's protocol does not care how much of the page
    was written, only *that* it was written during an open copy.
    """
    ids = as_index(block_ids, state.device)
    region, slot = _locate(state, ids)
    offs = as_index(row_offsets, state.device)
    state.pool[region, slot, offs] = torch.as_tensor(rows, device=state.device).to(
        state.pool.dtype
    )
    state.dirty[ids] = state.dirty[ids] | state.in_flight[ids]
    return state


def block_regions(state: LeapState, block_ids) -> torch.Tensor:
    return state.table[as_index(block_ids, state.device), REGION]


# --------------------------------------------------------------------------
# Tier-aware (group) semantics.
#
# A huge block is G logical blocks [g*G, (g+1)*G) whose table entries expand
# to one contiguous slot run, so the flat table/dirty/in_flight vectors keep
# working per block; the group views below are the level-1 semantics: a huge
# read is one contiguous slice, and a huge copy epoch is dirtied by a write
# to *any* member (the commit verdict is the OR over the run, exactly like a
# huge-page PTE covering G small pages).
# --------------------------------------------------------------------------


def huge_read(state: LeapState, group_ids, huge_factor: int) -> torch.Tensor:
    """Read whole huge blocks: ``[len(group_ids), G, *block_shape]``.

    Resolves one level-1 entry (member 0's location) per group and slices the
    contiguous run — G blocks per table lookup instead of G lookups.
    """
    first = as_index(group_ids, state.device) * huge_factor
    region, slot = _locate(state, first)
    run = torch.arange(huge_factor, device=state.device)
    return state.pool[region[:, None], slot[:, None] + run[None, :]]


def _members(state: LeapState, group_ids, huge_factor: int) -> torch.Tensor:
    g = as_index(group_ids, state.device)
    return g[:, None] * huge_factor + torch.arange(huge_factor, device=state.device)[None, :]


def group_dirty(state: LeapState, group_ids, huge_factor: int) -> torch.Tensor:
    """Level-1 dirty view: a group is dirty iff any member is dirty."""
    return state.dirty[_members(state, group_ids, huge_factor)].any(dim=1)


def group_in_flight(state: LeapState, group_ids, huge_factor: int) -> torch.Tensor:
    """Level-1 in-flight view: a group is in flight iff any member is."""
    return state.in_flight[_members(state, group_ids, huge_factor)].any(dim=1)


def flat_pool_view(pool: torch.Tensor) -> torch.Tensor:
    """View ``pool [R, S, *blk]`` in the kernel layout ``[R*S, rows, cols]``.

    A (region, slot) pair becomes the flat slot ``region * S + slot``; the
    payload collapses to 2-D (``rows = prod(blk[:-1])``, ``cols = blk[-1]``).
    The result shares storage with ``pool``, so writes through it land in
    the pool (the pool is contiguous).
    """
    r, s = pool.shape[:2]
    payload = pool.shape[2:]
    rows = int(np.prod(payload[:-1])) if len(payload) > 1 else 1
    cols = int(payload[-1]) if payload else 1
    return pool.view(r * s, rows, cols)


def placement_histogram(state: LeapState, n_regions: int) -> np.ndarray:
    """Host-side histogram: how many blocks currently live on each region."""
    regions = state.table[:, REGION].cpu().numpy()
    return np.bincount(regions, minlength=n_regions)
