"""Kernel dispatch for the migrator's device programs.

``impl`` picks the implementation:

* ``None`` / ``"auto"``: a CUDA tensor goes to the hand-written CUDA kernel,
  a CPU tensor to the plain PyTorch version;
* ``"cuda"``: the kernel, and a CPU tensor raises;
* ``"ref"``: the plain version, on any device.

Nothing falls back from the kernel to the plain version: a kernel that does
not build or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import heat_scan as heat_mod
from repro_torch.kernels import leap_copy, ref

IMPLS = (None, "auto", "cuda", "ref")


def _use_kernel(impl: str | None, t: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ref":
        return False
    if impl == "cuda" and not t.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got one on {t.device}")
    return t.is_cuda


def copy_blocks_impl(pool, src_idx, dst_idx, *, impl: str | None = None):
    """Intra-pool block copy ``pool[dst_idx[i]] = pool[src_idx[i]]``, in place."""
    if _use_kernel(impl, pool):
        return leap_copy.copy_blocks(pool, src_idx, dst_idx)
    return ref.copy_blocks_ref(pool, src_idx, dst_idx)


def copy_runs_impl(pool, src_starts, dst_starts, *, run: int, impl: str | None = None):
    """Contiguous-run copy: one huge block (``run`` aligned slots) per lane, in place."""
    if _use_kernel(impl, pool):
        return leap_copy.copy_runs(pool, src_starts, dst_starts, run)
    return ref.copy_runs_ref(pool, src_starts, dst_starts, run)


def heat_scan_impl(heat, ids, w, decay, *, impl: str | None = None):
    """Fused decay + accumulate over the heat plane, in place.

    An empty sample batch leaves the plane untouched (no decay), as the JAX
    dispatcher does; ids ``>= len(heat)`` are inert on every path.
    """
    if ids.shape[0] == 0:
        return heat
    if _use_kernel(impl, heat):
        return heat_mod.heat_scan(heat, ids, w, decay)
    return ref.heat_scan_ref(heat, ids, w, decay)
