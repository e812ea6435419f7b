"""Intra-pool block and run copies: the physical-copy hot path of migration.

``copy_blocks`` and ``copy_runs`` wrap one hand-written CUDA kernel,
``csrc/leap_copy.cu``, which replaces the TPU kernels
``copy_blocks_pallas`` and ``copy_runs_pallas`` of the JAX package's
``kernels/leap_copy.py``.  A CUDA tensor launches the kernel on the current
stream; a CPU tensor takes the plain version in :mod:`.ref`.  Both update
the flat ``[S, rows, cols]`` pool in place and return it.

The kernel's CTAs run in any order, so the lanes of one launch must not
overlap and no destination may be a source.  :func:`check_copy_plan` checks
that on the host, where the dispatch stage builds the plan.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref


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


def _check_operands(pool, src, dst, run: int) -> None:
    if not pool.is_cuda:
        raise ValueError(f"the CUDA copy kernel needs a CUDA pool, got {pool.device}")
    if pool.ndim != 3 or not pool.is_contiguous():
        raise ValueError(f"pool must be a contiguous [slots, rows, cols], got {pool.shape}")
    if run < 1 or pool.shape[0] % run:
        raise ValueError(f"run {run} must divide slot count {pool.shape[0]}")
    for name, t in (("src", src), ("dst", dst)):
        if t.device != pool.device or t.dtype != torch.int64:
            raise ValueError(f"{name} must be int64 on {pool.device}, got {t.dtype} on {t.device}")
        if t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if src.shape != dst.shape:
        raise ValueError(f"src {tuple(src.shape)} and dst {tuple(dst.shape)} differ")


def _launch(pool, src, dst, run: int) -> None:
    slot_bytes = pool[0].numel() * pool.element_size()
    with torch.cuda.device(pool.device):
        err = _build.load().leap_copy_lanes(
            pool.data_ptr(),
            src.data_ptr(),
            dst.data_ptr(),
            src.shape[0],
            slot_bytes,
            run * slot_bytes,
            torch.cuda.current_stream(pool.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"leap_copy_lanes launch failed: CUDA error {err}")


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


copy_blocks.launches = 0  # kernel launches in this process (read by chip_smoke.py)
copy_runs.launches = 0
