"""Per-block access-heat decay + accumulate, in one pass over the plane.

The closed-loop tiering plane keeps one exponentially decayed heat counter
per block on the device::

    heat' = heat * decay;  heat'[ids[k]] += w[k]   for every access sample

``heat_scan`` wraps the hand-written CUDA kernel ``csrc/heat_scan.cu``, which
replaces the TPU kernel ``heat_scan_pallas`` of the JAX package's
``kernels/heat_scan.py``.  A CUDA tensor launches the kernel on the current
stream; a CPU tensor takes the plain version in :mod:`.ref`.  Either way the
plane is updated in place and returned, and ids ``>= len(heat)`` are inert.

The kernel gives each CTA a tile of :data:`TILE_ENTRIES` entries (its grid
is :func:`scan_tiles` CTAs); a CTA keeps the samples that fall in its tile,
in sample order, in a shared buffer that it folds in rounds when more arrive.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref

# the plane's padding unit (the JAX plane's tile, 8 sublanes x 128 lanes),
# and the entries each CTA of csrc/heat_scan.cu owns (its kTileEntries)
TILE_ENTRIES = 1024


def padded_heat_len(n_blocks: int) -> int:
    """Smallest multiple of 1024 holding ``n_blocks`` (the JAX plane's length)."""
    return max(1, (max(n_blocks, 1) + TILE_ENTRIES - 1) // TILE_ENTRIES) * TILE_ENTRIES


def scan_tiles(n_heat: int) -> int:
    """CTAs in the kernel's grid, which the kernel's C entry sizes itself:
    one per ``TILE_ENTRIES`` entries of the plane."""
    return -(-n_heat // TILE_ENTRIES)


def heat_scan(heat: torch.Tensor, ids: torch.Tensor, w: torch.Tensor, decay: float):
    """Fused decay + accumulate over the flat fp32 plane, in place; returns ``heat``."""
    if heat.device.type == "cpu":
        return ref.heat_scan_ref(heat, ids, w, decay)
    if heat.dtype != torch.float32 or heat.ndim != 1 or not heat.is_contiguous():
        raise ValueError(f"heat must be a contiguous 1-D float32 tensor, got {heat.dtype}")
    if ids.dtype != torch.int64 or w.dtype != torch.float32:
        raise ValueError(f"ids must be int64 and w float32, got {ids.dtype}, {w.dtype}")
    for name, t in (("ids", ids), ("w", w)):
        if t.device != heat.device or t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor on {heat.device}")
    if ids.shape != w.shape:
        raise ValueError(f"ids {tuple(ids.shape)} and w {tuple(w.shape)} differ")
    with torch.cuda.device(heat.device):
        err = _build.load().leap_heat_scan(
            heat.data_ptr(),
            ids.data_ptr(),
            w.data_ptr(),
            heat.shape[0],
            ids.shape[0],
            float(np.float32(decay)),
            torch.cuda.current_stream(heat.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"leap_heat_scan launch failed: CUDA error {err}")
    heat_scan.launches += 1
    return heat


heat_scan.launches = 0  # kernel launches in this process (read by chip_smoke.py)
