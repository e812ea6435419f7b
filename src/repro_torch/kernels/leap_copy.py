"""Block copies: the physical-copy hot path of migration.

``copy_blocks``, ``copy_runs``, ``gather_blocks`` and ``scatter_blocks``
wrap the hand-written CUDA kernels of ``csrc/leap_copy.cu``, which replace
the TPU kernels ``copy_blocks_pallas``, ``copy_runs_pallas``,
``gather_blocks_pallas`` and ``scatter_blocks_pallas`` of the JAX package's
``kernels/leap_copy.py``: one lane-copy kernel for the copies and the
scatter, and a persistent TMA bulk-copy pipeline for the gather (the
lane-copy kernel's byte instance where the gather's operands are not
16-byte aligned).  A CUDA tensor launches a kernel on the current stream; a
CPU tensor takes the plain version in :mod:`.ref`.  The copies
and the scatter update the flat ``[S, rows, cols]`` pool in place and return
it; the gather returns a new ``[K, rows, cols]`` staging buffer.

The kernel's CTAs run in any order, so the lanes of one in-pool copy must
not overlap and no destination may be a source.  :func:`check_copy_plan`
checks that on the host, where the dispatch stage builds the plan.  The
scatter keeps the last of duplicate ids on the device, as the TPU grid does.

``copy_blocks_shards``, ``copy_runs_shards`` and ``zero_blocks_shards`` are
K1, K2 and a zero-fill over a pool held as one tensor a region (a state
placed on a region mesh): the lane kernel's shard-table instance, which
reads and writes each lane in the shard its flat slot id names (``f // S``,
slot ``f % S``), so one launch moves what the one-tensor kernel moves.  It
runs on the ids' device and reaches a shard on another card through its
device pointer, once :func:`enable_peer_access` has let it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, ref

MAX_SHARDS = 64  # the shard table's size in csrc/leap_copy.cu (kMaxShards)
_peers: set[tuple[int, int]] = set()  # (device, peer) pairs with peer access on


def check_copy_plan(src, dst, n_slots: int, run: int = 1) -> None:
    """Raise ValueError unless the copy plan meets the kernel's contract.

    Lane ``i`` moves slots ``[src[i], src[i] + run)`` to
    ``[dst[i], dst[i] + run)``.  Starts must be ``run``-aligned and in range,
    destination runs pairwise distinct, and no destination run a source run.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError(f"src {src.shape} and dst {dst.shape} must be equal 1-D")
    if not len(src):
        return
    if run < 1 or n_slots % run:
        raise ValueError(f"run {run} must divide slot count {n_slots}")
    if (src % run).any() or (dst % run).any():
        raise ValueError(f"copy starts must be {run}-aligned")
    lo = min(src.min(), dst.min())
    hi = max(src.max(), dst.max())
    if lo < 0 or hi + run > n_slots:
        raise ValueError(f"copy slots [{lo}, {hi + run}) outside [0, {n_slots})")
    d_units = dst // run
    if len(np.unique(d_units)) != len(d_units):
        raise ValueError("copy plan writes one destination twice")
    if np.intersect1d(src // run, d_units).size:
        raise ValueError("copy plan destination is also a source")


def _check_pool(pool) -> None:
    if not pool.is_cuda:
        raise ValueError(f"the CUDA copy kernel needs a CUDA pool, got {pool.device}")
    if pool.ndim != 3 or not pool.is_contiguous():
        raise ValueError(f"pool must be a contiguous [slots, rows, cols], got {pool.shape}")


def _check_index(name: str, t, device) -> None:
    if t.device != device or t.dtype != torch.int64:
        raise ValueError(f"{name} must be int64 on {device}, got {t.dtype} on {t.device}")
    if t.ndim != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")


def _check_operands(pool, src, dst, run: int) -> None:
    _check_pool(pool)
    if run < 1 or pool.shape[0] % run:
        raise ValueError(f"run {run} must divide slot count {pool.shape[0]}")
    _check_index("src", src, pool.device)
    _check_index("dst", dst, pool.device)
    if src.shape != dst.shape:
        raise ValueError(f"src {tuple(src.shape)} and dst {tuple(dst.shape)} differ")


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the bytes of two contiguous tensors share any address."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def _slot_bytes(pool) -> int:
    return pool[0].numel() * pool.element_size()


def _call(name: str, device, *args) -> None:
    """Launch entry point ``name`` on ``device`` and its current stream."""
    with torch.cuda.device(device):
        err = getattr(_build.load(), name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _launch(pool, src, dst, run: int) -> None:
    slot_bytes = _slot_bytes(pool)
    _call("leap_copy_lanes", pool.device, pool.data_ptr(), src.data_ptr(), dst.data_ptr(),
          src.shape[0], slot_bytes, run * slot_bytes)


def copy_blocks(pool: torch.Tensor, src_idx: torch.Tensor, dst_idx: torch.Tensor):
    """In-place ``pool[dst_idx[i]] = pool[src_idx[i]]``; returns ``pool``."""
    if pool.device.type == "cpu":
        return ref.copy_blocks_ref(pool, src_idx, dst_idx)
    _check_operands(pool, src_idx, dst_idx, 1)
    if src_idx.shape[0]:
        _launch(pool, src_idx, dst_idx, 1)
        copy_blocks.launches += 1
    return pool


def copy_runs(
    pool: torch.Tensor, src_starts: torch.Tensor, dst_starts: torch.Tensor, run: int
):
    """In-place ``pool[dst:dst+run] = pool[src:src+run]`` per lane; returns ``pool``."""
    if pool.device.type == "cpu":
        return ref.copy_runs_ref(pool, src_starts, dst_starts, run)
    _check_operands(pool, src_starts, dst_starts, run)
    if src_starts.shape[0]:
        _launch(pool, src_starts, dst_starts, run)
        copy_runs.launches += 1
    return pool


def gather_blocks(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pool[idx]`` packed into a new contiguous ``[K, rows, cols]`` buffer.

    ``pool`` may be a view with a storage offset (one region's shard of the
    flat pool); duplicate ids read the same slot twice.
    """
    if pool.device.type == "cpu":
        return ref.gather_blocks_ref(pool, idx)
    _check_pool(pool)
    _check_index("idx", idx, pool.device)
    out = torch.empty((idx.shape[0],) + tuple(pool.shape[1:]), dtype=pool.dtype,
                      device=pool.device)
    if idx.shape[0]:
        _call("leap_gather_blocks", pool.device, out.data_ptr(), pool.data_ptr(), idx.data_ptr(),
              idx.shape[0], _slot_bytes(pool))
        gather_blocks.launches += 1
        gather_blocks.lanes += idx.shape[0]
    return out


def scatter_blocks(pool: torch.Tensor, idx: torch.Tensor, blocks: torch.Tensor):
    """In-place ``pool[idx[i]] = blocks[i]``; of duplicate ids the last lane
    wins.  ``blocks`` must not share memory with ``pool``.  Returns ``pool``."""
    if pool.device.type == "cpu":
        return ref.scatter_blocks_ref(pool, idx, blocks)
    _check_pool(pool)
    _check_index("idx", idx, pool.device)
    want = (idx.shape[0],) + tuple(pool.shape[1:])
    if blocks.device != pool.device or blocks.dtype != pool.dtype:
        raise ValueError(f"blocks must be {pool.dtype} on {pool.device}, "
                         f"got {blocks.dtype} on {blocks.device}")
    if tuple(blocks.shape) != want or not blocks.is_contiguous():
        raise ValueError(f"blocks must be a contiguous {list(want)}, got {list(blocks.shape)}")
    if idx.shape[0]:
        if _overlap(blocks, pool):
            raise ValueError("blocks and pool share memory; scatter from a separate buffer")
        _call("leap_scatter_blocks", pool.device, pool.data_ptr(), blocks.data_ptr(), idx.data_ptr(),
              idx.shape[0], _slot_bytes(pool))
        scatter_blocks.launches += 1
    return pool


# -- K1 and K2 over region shards -------------------------------------------------


def enable_peer_access(devices) -> None:
    """Let kernels on each CUDA device of ``devices`` reach the memory of
    every other one, once a pair; raise when two cannot reach each other.
    Call it before a capture: the library call is no capture's work."""
    cards = sorted({torch.device(d).index for d in devices if torch.device(d).type == "cuda"})
    for a in cards:
        for b in cards:
            if a == b or (a, b) in _peers:
                continue
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"peer access cuda:{a} -> cuda:{b} is off and a capture is "
                                   "underway: enable it first (RegionMesh does on creation)")
            err = _build.load().leap_enable_peer_access(a, b)
            if err:
                raise RuntimeError(f"cuda:{a} cannot reach the memory of cuda:{b} "
                                   f"(peer access: CUDA error {err})")
            _peers.add((a, b))


def _check_shards(shards, slots_per_region: int, run: int, home: torch.device) -> None:
    if not 1 <= len(shards) <= MAX_SHARDS:
        raise ValueError(f"the shard table holds 1 to {MAX_SHARDS} shards, got {len(shards)}")
    first = shards[0]
    for t in shards:
        if not t.is_cuda:
            raise ValueError(f"the CUDA shard kernel needs CUDA shards, got one on {t.device}")
        if t.ndim != 3 or not t.is_contiguous():
            raise ValueError(f"a shard must be a contiguous [slots, rows, cols], got {t.shape}")
        if t.dtype != first.dtype or t.shape[1:] != first.shape[1:]:
            raise ValueError("every shard must have the first's dtype and block shape")
        if t.shape[0] < slots_per_region:
            raise ValueError(f"a shard of {t.shape[0]} slots holds no {slots_per_region}")
    if run < 1 or slots_per_region % run:
        raise ValueError(f"run {run} must divide the slots a region, {slots_per_region}: "
                         "a run may not cross a region")
    if home.type != "cuda":
        raise ValueError(f"the ids must lie on a CUDA device, got {home}")
    enable_peer_access([home] + [t.device for t in shards])


def _launch_shards(shards, src, dst, slots_per_region: int, run: int) -> None:
    """One launch of the shard-table instance (``src`` None: the zero one)."""
    home = dst.device
    _check_shards(shards, slots_per_region, run, home)
    _check_index("dst", dst, home)
    if src is not None:
        _check_index("src", src, home)
        if src.shape != dst.shape:
            raise ValueError(f"src {tuple(src.shape)} and dst {tuple(dst.shape)} differ")
    slot_bytes = _slot_bytes(shards[0])
    bases = (ctypes.c_void_p * len(shards))(*(t.data_ptr() for t in shards))
    _call("leap_copy_shards", home, bases, len(shards), None if src is None else src.data_ptr(),
          dst.data_ptr(), dst.shape[0], slots_per_region, slot_bytes, run * slot_bytes)


def copy_blocks_shards(shards, src_flat: torch.Tensor, dst_flat: torch.Tensor,
                       slots_per_region: int) -> None:
    """In place over region shards (each ``[S + 1, rows, cols]``, its last
    row a sink): flat slot ``dst_flat[i]`` takes flat slot ``src_flat[i]``,
    flat slot ``f`` being slot ``f % S`` of shard ``f // S``.  The contract
    of :func:`copy_blocks` holds: no destination is a source."""
    if shards[0].device.type == "cpu":
        return ref.copy_shards_ref(shards, src_flat, dst_flat, slots_per_region)
    if dst_flat.shape[0]:
        _launch_shards(shards, src_flat, dst_flat, slots_per_region, 1)
        copy_blocks_shards.launches += 1


def copy_runs_shards(shards, src_starts: torch.Tensor, dst_starts: torch.Tensor,
                     slots_per_region: int, run: int) -> None:
    """:func:`copy_blocks_shards` of whole runs: ``run`` slots from each
    flat start, starts ``run``-aligned and ``run`` dividing ``S``."""
    if shards[0].device.type == "cpu":
        return ref.copy_shards_ref(shards, src_starts, dst_starts, slots_per_region, run)
    if dst_starts.shape[0]:
        _launch_shards(shards, src_starts, dst_starts, slots_per_region, run)
        copy_runs_shards.launches += 1


def zero_blocks_shards(shards, dst_flat: torch.Tensor, slots_per_region: int) -> None:
    """Zero flat slots ``dst_flat`` of region shards, in place."""
    if shards[0].device.type == "cpu":
        return ref.zero_shards_ref(shards, dst_flat, slots_per_region)
    if dst_flat.shape[0]:
        _launch_shards(shards, None, dst_flat, slots_per_region, 1)
        zero_blocks_shards.launches += 1


copy_blocks.launches = 0  # kernel launches in this process (read by chip_smoke.py)
copy_runs.launches = 0
gather_blocks.launches = 0
gather_blocks.lanes = 0  # lanes summed over the launches (host-side only)
scatter_blocks.launches = 0
copy_blocks_shards.launches = 0
copy_runs_shards.launches = 0
zero_blocks_shards.launches = 0
