"""Region meshes for a pool sharded over its regions, device meshes for a
model sharded over its parameters, and the production meshes.

The JAX package shards the pool's region dim over a mesh axis with one
device per memory region: its xla backend indexes across the shards
(GSPMD), its ppermute backend runs under ``shard_map``.  The port drives
both from one controller: a :class:`RegionMesh` names the ``torch.device``
that holds each region, and a state placed on it
(``state.to(state_sharding(cfg, mesh))``) holds its pool as one tensor per
region, each in its own allocation on that region's device, with the table
and flags on the home device, ``mesh.device(0)``.
``migrator.fused_copy_ppermute`` packs a region's slots on its device, moves
the staging buffer to the destination region's device (a peer copy between
cards; on one card the buffer is already there) and unpacks it there.  The
xla backend's copies are one kernel on the home device that reads and
writes every shard through its device pointer: on distinct cards a remote
access over NVLink, so a mesh over several cards turns peer access on
between them when it is made, and raises if two of them cannot reach each
other.

The regions may share a device (every region on one card, or on the CPU for
tests) or lie on distinct cards; the code that runs over the shards is the
same, and only the accesses between two devices differ.

A :class:`DeviceMesh` is the reference's ``jax.sharding.Mesh`` for the
model: axis names and sizes (a ``MeshShape``) and one ``torch.device`` per
position, row-major.  ``distributed/sharding.py`` ``place`` lays a model or
a training state out over it by the reference's rules, and one controller
runs the sharded train and decode steps over it (``train/train_step.py``,
``models/lm.py``).  Its positions too may share a device or lie on
distinct cards.

``make_production_mesh`` and ``make_debug_mesh`` give the JAX package's
meshes as :class:`~repro_torch.distributed.sharding.MeshShape` s (names and
sizes, no devices), which the dry-run's accounting reads.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.sharding import MeshShape
from repro_torch.kernels.leap_copy import enable_peer_access


def _default_device(device=None) -> torch.device:
    # imported here: repro_torch.core re-exports this module
    from repro_torch.core.state import _default_device

    return _default_device(device)


def _pinned(device) -> torch.device:
    """``device`` with its card's index ("cuda" names the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class RegionMesh:
    """One ``torch.device`` per region along the mesh axis ``axis_name``."""

    devices: tuple[torch.device, ...]
    axis_name: str = "data"

    def __post_init__(self) -> None:
        # "cuda" and "cuda:0" name one card: pin the index so they compare equal
        devices = tuple(map(_pinned, self.devices))
        if not devices:
            raise ValueError("a region mesh needs at least one region")
        object.__setattr__(self, "devices", devices)
        if len({d for d in devices if d.type == "cuda"}) > 1:
            enable_peer_access(devices)

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
    """A mesh of ``n_regions`` regions, region r on ``devices[r]`` (e.g.
    ``["cpu"] * 4``, or ``["cuda:0", "cuda:1"]`` for a region a card).  By
    default every region is the current CUDA device, which must exist."""
    if devices is None:
        devices = [_default_device()] * n_regions
    if len(devices) != n_regions:
        raise ValueError(f"{len(devices)} devices for {n_regions} regions")
    return RegionMesh(tuple(devices), axis_name)


@dataclasses.dataclass(frozen=True)
class DeviceMesh(MeshShape):
    """A :class:`MeshShape` with ``devices[p]`` holding position ``p``
    (row-major over the axes).  A card that is not on this host raises;
    peer access is turned on between distinct cards."""

    devices: tuple = ()

    def __post_init__(self) -> None:
        super().__post_init__()
        devices = tuple(_pinned(d) for d in self.devices)
        if len(devices) != self.size:
            raise ValueError(f"{len(devices)} devices for a mesh of {self.size} positions "
                             f"{self.shape}")
        for d in devices:
            if d.type == "cuda" and d.index >= torch.cuda.device_count():
                raise ValueError(f"{d} is not on this host ({torch.cuda.device_count()} cards)")
        object.__setattr__(self, "devices", devices)
        if len({d for d in devices if d.type == "cuda"}) > 1:
            enable_peer_access(devices)


def make_device_mesh(sizes, axis_names, devices=None) -> DeviceMesh:
    """A mesh of ``sizes`` over ``axis_names``, position ``p`` (row-major) on
    ``devices[p]`` (e.g. ``["cpu"] * 8``, or a card a position).  By default
    every position is the current CUDA device, which must exist."""
    sizes, axis_names = tuple(sizes), tuple(axis_names)
    if devices is None:
        devices = [_default_device()] * math.prod(sizes)
    return DeviceMesh(sizes, axis_names, tuple(devices))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: 256 chips (16, 16) = ("data", "model").
    Multi-pod: 2 pods x 256 chips (2, 16, 16) = ("pod", "data", "model");
    pods are pure data parallel."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_debug_mesh(n_devices: int | None = None) -> MeshShape:
    """Small (data, model) mesh over ``n_devices`` (default: the CUDA cards
    present, at least one)."""
    n = n_devices or max(torch.cuda.device_count(), 1)
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return MeshShape((n // model, model), ("data", "model"))
