"""Region meshes for the ppermute copy backend.

The JAX package runs that backend under ``shard_map`` on a mesh with one
device per memory region.  The port drives it from one controller: a
:class:`RegionMesh` names the ``torch.device`` that holds each region, and
``migrator.fused_copy_ppermute`` packs a region's slots on its device, moves
the staging buffer to the destination region's device and unpacks it there.

So far every region lives on one device (one card, or the CPU for tests):
the pool is one tensor, and the move between regions is ``Tensor.to`` of a
buffer that is already there.  A mesh over several cards needs a pool split
into per-card shards (ROADMAP queue 1 item 5) and raises until then.
"""

from __future__ import annotations

import dataclasses

import torch


def _default_device(device=None) -> torch.device:
    # imported here: repro_torch.core re-exports this module
    from repro_torch.core.state import _default_device

    return _default_device(device)


@dataclasses.dataclass(frozen=True)
class RegionMesh:
    """One ``torch.device`` per region along the mesh axis ``axis_name``."""

    devices: tuple[torch.device, ...]
    axis_name: str = "data"

    def __post_init__(self) -> None:
        # "cuda" and "cuda:0" name one card: pin the index so they compare equal
        devices = tuple(
            torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None
            else d
            for d in map(torch.device, self.devices)
        )
        if not devices:
            raise ValueError("a region mesh needs at least one region")
        if len(set(devices)) > 1:
            raise NotImplementedError(
                f"a region mesh over several devices ({sorted(map(str, set(devices)))}) "
                "needs a pool sharded per device, which is not ported yet "
                "(ROADMAP queue 1 item 5)"
            )
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        """Regions along the mesh axis."""
        return len(self.devices)

    def device(self, region: int) -> torch.device:
        """The device that holds ``region``."""
        return self.devices[region]


def make_region_mesh(
    n_regions: int, devices=None, axis_name: str = "data"
) -> RegionMesh:
    """A mesh of ``n_regions`` regions; ``devices`` lists one device per
    region (e.g. ``["cpu"] * 4``).  By default every region is the current
    CUDA device, which must exist."""
    if devices is None:
        devices = [_default_device()] * n_regions
    if len(devices) != n_regions:
        raise ValueError(f"{len(devices)} devices for {n_regions} regions")
    return RegionMesh(tuple(devices), axis_name)
