"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function computes what its kernel computes, on any device.  The kernel
wrappers use them for CPU tensors; the tests and ``chip_smoke.py`` hold the
kernels against them.  Like the kernels, they update ``pool`` / ``heat`` in
place and return it (the JAX package's buffer donation, made explicit).
"""

from __future__ import annotations

import numpy as np
import torch

# -- leap_copy ---------------------------------------------------------------


def copy_blocks_ref(
    pool: torch.Tensor, src_idx: torch.Tensor, dst_idx: torch.Tensor
) -> torch.Tensor:
    """``pool[dst_idx[i]] = pool[src_idx[i]]`` over the flat ``[S, rows, cols]`` pool.

    The gather completes before the scatter, so the result does not depend
    on lane order (destinations are disjoint from sources by contract).
    """
    pool[dst_idx] = pool[src_idx]
    return pool


def copy_runs_ref(
    pool: torch.Tensor, src_starts: torch.Tensor, dst_starts: torch.Tensor, run: int
) -> torch.Tensor:
    """``pool[dst:dst+run] = pool[src:src+run]`` per lane (starts ``run``-aligned)."""
    s = pool.shape[0]
    grouped = pool.view((s // run, run) + tuple(pool.shape[1:]))
    grouped[dst_starts // run] = grouped[src_starts // run]
    return pool


# -- access-heat scan (closed-loop tiering) -----------------------------------


def heat_scan_ref(
    heat: torch.Tensor,  # [L] f32 per-block heat
    ids: torch.Tensor,  # [K] int64 block ids; ids >= L are inert lanes
    w: torch.Tensor,  # [K] f32 per-access weight
    decay: float,
) -> torch.Tensor:
    """``heat = heat * decay + acc`` with ``acc[i] = sum(w[k] for ids[k] == i)``.

    Lanes with ``ids >= L`` land in a trailing trash entry that is dropped,
    the JAX oracle's ``mode="drop"`` without a host-side mask.
    """
    (length,) = heat.shape
    acc = torch.zeros(length + 1, dtype=torch.float32, device=heat.device)
    acc.index_add_(0, ids.clamp(max=length), w.to(torch.float32))
    heat.mul_(np.float32(decay)).add_(acc[:length])
    return heat
