"""NUMA topology model: region-pair distances, per-link bandwidth budgets.

The paper's `page_leap()` treats every remote region as equally costly — a
fine assumption on the 2-socket evaluation machine, but wrong the moment the
pool generalizes past two regions (``PoolConfig.n_regions``): on multi-socket
meshes, chiplet fabrics, and CXL-pooled tiers the cost of a migration is a
function of *which* link the copy crosses.  This module is the machine
description the scheduler consults (DESIGN.md §7):

  distance   [R, R] int    SLIT-style relative access cost (10 = local).
  bandwidth  [R, R] float  relative link throughput (1.0 = the fastest
                           inter-region link; a congested/far link < 1.0).
  concurrency[R, R] int    how many distinct areas may charge the link in
                           one scheduler tick (per-link dispatch budget).

Nothing here imports from the rest of ``repro`` — the topology is pure
machine metadata (numpy only), attached to a pool via
``PoolConfig(topology=...)`` and consumed by the driver's link-aware
scheduler, the placement policies, and the fault-drain planner.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LOCAL_DISTANCE = 10  # ACPI SLIT convention: distance to self


@dataclasses.dataclass(eq=False)  # identity equality: ndarray fields
class NumaTopology:
    """Region-pair distance matrix plus per-link bandwidth/dispatch budgets."""

    distance: np.ndarray  # [R, R] int32, SLIT-style (diag == LOCAL_DISTANCE)
    bandwidth: np.ndarray  # [R, R] float64, relative units (1.0 = fastest link)
    concurrency: np.ndarray  # [R, R] int32, areas per link per tick

    def __post_init__(self):
        self.distance = np.asarray(self.distance, dtype=np.int32)
        r = self.distance.shape[0]
        if self.distance.shape != (r, r):
            raise ValueError(f"distance must be square, got {self.distance.shape}")
        if self.bandwidth is None:
            self.bandwidth = np.ones((r, r), dtype=np.float64)
        self.bandwidth = np.asarray(self.bandwidth, dtype=np.float64)
        if self.concurrency is None:
            self.concurrency = np.full((r, r), 8, dtype=np.int32)
        self.concurrency = np.asarray(self.concurrency, dtype=np.int32)
        for name, m in (("bandwidth", self.bandwidth), ("concurrency", self.concurrency)):
            if m.shape != (r, r):
                raise ValueError(f"{name} must be [{r}, {r}], got {m.shape}")
        # Own private copies, frozen: the topology is shared live through the
        # sealed facade, so its matrices must not be mutable machine state
        # (with_link()/congested() derive fresh writable copies first).
        self.distance = np.array(self.distance, dtype=np.int32)
        self.bandwidth = np.array(self.bandwidth, dtype=np.float64)
        self.concurrency = np.array(self.concurrency, dtype=np.int32)
        for m in (self.distance, self.bandwidth, self.concurrency):
            m.flags.writeable = False
        if not (np.diag(self.distance) == LOCAL_DISTANCE).all():
            raise ValueError(f"diagonal distances must be {LOCAL_DISTANCE} (local)")
        off = ~np.eye(r, dtype=bool)
        if (self.distance[off] <= LOCAL_DISTANCE).any():
            raise ValueError("off-diagonal distances must exceed the local distance")
        if (self.bandwidth[off] <= 0).any():
            raise ValueError("link bandwidth must be positive")
        if (self.concurrency[off] < 1).any():
            raise ValueError("link concurrency must be >= 1")

    # -- shape ---------------------------------------------------------------

    @property
    def n_regions(self) -> int:
        return int(self.distance.shape[0])

    @property
    def min_link_distance(self) -> int:
        """Distance of the fastest inter-region link (the granularity and
        budget reference: a link at this distance runs at full initial-area
        size and unit budget)."""
        r = self.n_regions
        if r < 2:
            return LOCAL_DISTANCE
        off = ~np.eye(r, dtype=bool)
        return int(self.distance[off].min())

    # -- queries --------------------------------------------------------------

    def link_cost(self, src: int, dst: int) -> int:
        return int(self.distance[src, dst])

    def nearest(self, region: int, exclude=()) -> list[int]:
        """Regions ordered by distance from ``region`` (nearest first,
        ``region`` itself and ``exclude`` omitted; ties break by index)."""
        skip = set(exclude) | {region}
        order = np.argsort(self.distance[region], kind="stable")
        return [int(r) for r in order if int(r) not in skip]

    def route(self, src: int, dst: int) -> tuple[int, ...]:
        """Cheapest hop path from ``src`` to ``dst``: ``(src, dst)`` direct,
        or ``(src, via, dst)`` when some two-hop relay is strictly cheaper
        than the direct link (congested/far links get routed around).  Longer
        paths are never considered — every extra hop is a full extra copy of
        the payload, so past two hops the copy amplification always loses.
        """
        if src == dst:
            return (src,)
        direct = int(self.distance[src, dst])
        via = np.asarray(self.distance[src], dtype=np.int64) + np.asarray(
            self.distance[:, dst], dtype=np.int64
        )
        via[src] = via[dst] = np.iinfo(np.int64).max
        m = int(np.argmin(via))
        if int(via[m]) < direct:
            return (src, m, dst)
        return (src, dst)

    def hops(self, src: int, dst: int) -> int:
        return len(self.route(src, dst)) - 1

    def link_blocks(self, src: int, dst: int, unit_blocks: int) -> int:
        """Per-tick block budget of one link: ``unit_blocks`` scaled by the
        link's relative bandwidth, floored at 1 so no link ever starves."""
        return max(1, int(round(float(self.bandwidth[src, dst]) * unit_blocks)))

    # -- derived topologies ----------------------------------------------------

    def with_link(
        self,
        src: int,
        dst: int,
        *,
        distance: int | None = None,
        bandwidth: float | None = None,
        symmetric: bool = True,
    ) -> "NumaTopology":
        """Copy of this topology with one link's parameters overridden."""
        d = self.distance.copy()
        b = self.bandwidth.copy()
        pairs = [(src, dst), (dst, src)] if symmetric else [(src, dst)]
        for s, t in pairs:
            if distance is not None:
                d[s, t] = distance
            if bandwidth is not None:
                b[s, t] = bandwidth
        return NumaTopology(d, b, self.concurrency.copy())

    def congested(self, src: int, dst: int, factor: float) -> "NumaTopology":
        """Model contention on one link: distance scaled up and bandwidth
        scaled down by ``factor`` (both directions)."""
        if factor < 1:
            raise ValueError(f"congestion factor must be >= 1, got {factor}")
        return self.with_link(
            src,
            dst,
            distance=int(round(self.distance[src, dst] * factor)),
            bandwidth=float(self.bandwidth[src, dst]) / factor,
        )

    # -- factories -------------------------------------------------------------

    @classmethod
    def symmetric(
        cls, n: int, remote: int = 20, bandwidth: float = 1.0, concurrency: int = 8
    ) -> "NumaTopology":
        """Fully-connected mesh: every inter-region link identical (the
        implicit topology the pre-topology scheduler assumed)."""
        d = np.full((n, n), remote, dtype=np.int32)
        np.fill_diagonal(d, LOCAL_DISTANCE)
        return cls(
            d,
            np.full((n, n), bandwidth, dtype=np.float64),
            np.full((n, n), concurrency, dtype=np.int32),
        )

    @classmethod
    def two_socket(cls) -> "NumaTopology":
        """The paper's evaluation machine: two sockets over one QPI/UPI-style
        link (SLIT 10/21)."""
        return cls.symmetric(2, remote=21)

    @classmethod
    def quad_socket(cls) -> "NumaTopology":
        """Four sockets on a ring (0-1-2-3-0): adjacent sockets one fast hop
        (21), diagonal pairs two fabric hops (31) at reduced bandwidth — the
        classic 4-socket SLIT shape."""
        d = np.full((4, 4), 31, dtype=np.int32)
        np.fill_diagonal(d, LOCAL_DISTANCE)
        b = np.full((4, 4), 0.5, dtype=np.float64)
        for i in range(4):
            for j in ((i + 1) % 4, (i - 1) % 4):
                d[i, j] = 21
                b[i, j] = 1.0
        np.fill_diagonal(b, 1.0)
        return cls(d, b, np.full((4, 4), 8, dtype=np.int32))

    @classmethod
    def cxl_pooled(cls, n_local: int, n_far: int) -> "NumaTopology":
        """Tiered machine: ``n_local`` socket-attached regions on a fast
        fabric (21) plus ``n_far`` CXL-pooled regions behind a slow expander
        link (40, quarter bandwidth).  Far↔far traffic has no direct path —
        it bounces through a host socket, so its nominal distance (97) is
        deliberately worse than any two-hop relay via a local region
        (40 + 40 = 80): ``route()`` discovers the relay.
        """
        n = n_local + n_far
        d = np.full((n, n), 21, dtype=np.int32)
        b = np.ones((n, n), dtype=np.float64)
        local = np.arange(n) < n_local
        far = ~local
        d[np.ix_(local, far)] = 40
        d[np.ix_(far, local)] = 40
        b[np.ix_(local, far)] = 0.25
        b[np.ix_(far, local)] = 0.25
        if n_far:
            d[np.ix_(far, far)] = 97
            b[np.ix_(far, far)] = 0.125
        np.fill_diagonal(d, LOCAL_DISTANCE)
        np.fill_diagonal(b, 1.0)
        return cls(d, b, np.full((n, n), 8, dtype=np.int32))


def spill_assignments(
    topo: NumaTopology,
    ids: np.ndarray,
    current_regions: np.ndarray,
    dst_region: int,
    spare: dict,
) -> tuple[list[tuple[np.ndarray, int]], np.ndarray]:
    """Capacity-aware, distance-aware assignment of blocks that all want
    ``dst_region``: fill the destination first, then spill the overflow to
    regions nearest the destination — but never move a block to a region
    *farther* from the destination than the one it already occupies (staying
    put beats paying a copy for a worse seat).  Shared by
    ``LeapSession.apply`` rerouting and ``AutoBalancer.decide``.

    ``spare`` (region -> free slots) is mutated.  Returns
    ``(assignments, leftover)`` where each assignment is ``(ids, region)``
    and ``leftover`` are blocks no region could improve — callers decide
    whether those wait for destination capacity.
    """
    ids = np.asarray(ids)
    cur = np.asarray(current_regions)
    out: list[tuple[np.ndarray, int]] = []
    take = min(len(ids), max(0, spare.get(dst_region, 0)))
    if take:
        out.append((ids[:take], int(dst_region)))
        spare[dst_region] = spare.get(dst_region, 0) - take
    overflow, over_cur = ids[take:], cur[take:]
    for near in topo.nearest(dst_region):
        if len(overflow) == 0:
            break
        room = max(0, spare.get(near, 0))
        if room == 0:
            continue
        gain = topo.distance[dst_region, over_cur] > topo.distance[dst_region, near]
        pick = np.nonzero(gain)[0][:room]
        if len(pick) == 0:
            continue
        out.append((overflow[pick], int(near)))
        spare[near] = spare.get(near, 0) - len(pick)
        keep = np.ones(len(overflow), dtype=bool)
        keep[pick] = False
        overflow, over_cur = overflow[keep], over_cur[keep]
    return out, overflow


def modeled_tick_time(
    bytes_per_link: dict, topo: NumaTopology, unit_link_bytes: int
) -> float:
    """Modeled duration of one scheduler tick, in tick-units.

    Links move bytes in parallel; the slowest link this tick paces the tick.
    A link with relative bandwidth ``bw`` sustains ``bw * unit_link_bytes``
    per tick-unit, so a tick that pushed ``b`` bytes across it takes
    ``b / (bw * unit_link_bytes)`` units — never less than 1 (the tick's
    fixed control-path cost).  Benchmarks diff ``MigrationStats.
    bytes_per_link`` between ticks and sum these to get a hardware-model
    completion time that is independent of host wall-clock noise.
    """
    t = 1.0
    for (s, d), nbytes in bytes_per_link.items():
        if s == d or nbytes <= 0:
            continue
        cap = float(topo.bandwidth[s, d]) * unit_link_bytes
        t = max(t, nbytes / cap)
    return t
