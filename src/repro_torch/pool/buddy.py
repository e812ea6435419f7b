"""Per-region buddy allocator over the slot range of one pool region.

Slots are managed at power-of-two orders ``0 .. log2(G)`` where ``G`` is the
huge factor: an order-``k`` block is ``2**k`` contiguous slots starting at a
``2**k``-aligned slot.  A huge block is one order-``log2(G)`` allocation, so
huge allocations are G-aligned and G-contiguous by construction; freeing
coalesces buddies greedily, so a region that drains returns to all-huge free
blocks (no long-term fragmentation from transient small churn).

Tier transitions are bookkeeping on *live* allocations:

  * ``split_allocated(start)``  — demotion: one allocated huge block becomes
    ``G`` allocated small blocks (bytes don't move);
  * ``merge_allocated(start)``  — adoption/promotion commit: ``G`` allocated
    small blocks that happen to form an aligned run become one huge block.

The allocator also speaks the small-slot ``FreeList`` API
(``take``/``put``/``popleft``/``append``/``extend``/``len``/iteration) so
:class:`repro.core.driver.MigrationDriver` and the baselines can treat a
tiered region exactly like a flat one for order-0 traffic.

Every method validates against double frees and misaligned frees — the
allocator is the ground truth the two-level table is checked against.
"""

from __future__ import annotations

import heapq

import numpy as np


class BuddyAllocator:
    def __init__(self, n_slots: int, huge: int):
        if huge < 1 or (huge & (huge - 1)) != 0:
            raise ValueError(f"huge factor must be a power of two, got {huge}")
        if n_slots % huge != 0:
            raise ValueError(f"n_slots {n_slots} not divisible by huge {huge}")
        self.n_slots = n_slots
        self.huge = huge
        self.max_order = huge.bit_length() - 1
        # free blocks per order: start slots (all starts 2**order aligned).
        # A set is the truth; a lazy min-heap alongside gives O(log F)
        # lowest-address-fit (stale heap entries are skipped on pop).
        self._free: list[set[int]] = [set() for _ in range(self.max_order + 1)]
        self._heaps: list[list[int]] = [[] for _ in range(self.max_order + 1)]
        for s in range(0, n_slots, huge):
            self._add_free(self.max_order, s)
        # live allocations: start slot -> order
        self._alloc: dict[int, int] = {}

    def _add_free(self, order: int, start: int) -> None:
        self._free[order].add(start)
        heapq.heappush(self._heaps[order], start)

    def _pop_min_free(self, order: int) -> int:
        """Remove and return the lowest free start at ``order`` (must exist)."""
        heap, live = self._heaps[order], self._free[order]
        while heap[0] not in live:  # drop entries invalidated by coalescing
            heapq.heappop(heap)
        start = heapq.heappop(heap)
        live.discard(start)
        return start

    # -- core buddy operations ------------------------------------------------

    def alloc(self, order: int) -> int | None:
        """Allocate one order-``order`` block (lowest-address fit), or None."""
        if not 0 <= order <= self.max_order:
            raise ValueError(f"order must be in [0, {self.max_order}], got {order}")
        for o in range(order, self.max_order + 1):
            if self._free[o]:
                start = self._pop_min_free(o)
                while o > order:  # split down, keeping the low half
                    o -= 1
                    self._add_free(o, start + (1 << o))
                self._alloc[start] = order
                return start
        return None

    def free(self, start: int, order: int) -> None:
        """Free an allocation, coalescing with free buddies greedily."""
        if self._alloc.get(start) != order:
            raise ValueError(
                f"invalid free: slot {start} order {order} is not live "
                f"(double free or wrong order)"
            )
        del self._alloc[start]
        while order < self.max_order:
            buddy = start ^ (1 << order)
            if buddy not in self._free[order]:
                break
            self._free[order].discard(buddy)  # heap entry goes stale; lazily skipped
            start = min(start, buddy)
            order += 1
        self._add_free(order, start)

    # -- huge-block API ---------------------------------------------------------

    def take_run(self) -> int | None:
        """Allocate one huge block (G aligned contiguous slots); None if no
        free run exists — possible even with >= G free slots (fragmentation)."""
        return self.alloc(self.max_order)

    def free_run(self, start: int) -> None:
        self.free(start, self.max_order)

    def has_run(self) -> bool:
        return any(self._free[o] for o in range(self.max_order, self.max_order + 1))

    def split_allocated(self, start: int) -> None:
        """Demote a live huge block into G live small blocks (pure metadata)."""
        if self._alloc.get(start) != self.max_order:
            raise ValueError(f"slot {start} is not a live huge block")
        del self._alloc[start]
        for i in range(self.huge):
            self._alloc[start + i] = 0

    def merge_allocated(self, start: int) -> None:
        """Adopt G live small blocks at an aligned run as one huge block."""
        if start % self.huge != 0:
            raise ValueError(f"start {start} not {self.huge}-aligned")
        run = range(start, start + self.huge)
        if any(self._alloc.get(s) != 0 for s in run):
            raise ValueError(
                f"run [{start}, {start + self.huge}) is not all live small blocks"
            )
        for s in run:
            del self._alloc[s]
        self._alloc[start] = self.max_order

    # -- bulk reservation (initial placement mirrors init_state) ---------------

    def reserve(self, slots) -> None:
        """Mark specific slots as live order-0 allocations (initial placement)."""
        for s in sorted(int(s) for s in np.asarray(slots, dtype=np.int64)):
            got = self._take_small_at(s)
            if not got:
                raise ValueError(f"slot {s} is not free")

    def _take_small_at(self, slot: int) -> bool:
        """Carve the single slot ``slot`` out of whatever free block holds it."""
        for o in range(self.max_order + 1):
            start = (slot >> o) << o
            if start in self._free[o]:
                self._free[o].discard(start)  # stale heap entry; lazily skipped
                while o > 0:  # split, keeping the half containing `slot`
                    o -= 1
                    lo, hi = start, start + (1 << o)
                    if slot >= hi:
                        self._add_free(o, lo)
                        start = hi
                    else:
                        self._add_free(o, hi)
                self._alloc[slot] = 0
                return True
        return False

    # -- FreeList-compatible small-slot API -------------------------------------

    def take(self, n: int) -> np.ndarray | None:
        """Allocate ``n`` small slots at once, or None (state untouched)."""
        if len(self) < n:
            return None
        return np.asarray([self.alloc(0) for _ in range(n)], dtype=np.int32)

    def put(self, slots) -> None:
        for s in np.asarray(slots, dtype=np.int64):
            self.free(int(s), 0)

    def popleft(self) -> int:
        got = self.take(1)
        if got is None:
            raise IndexError("pop from empty BuddyAllocator")
        return int(got[0])

    def append(self, slot: int) -> None:
        self.free(int(slot), 0)

    def extend(self, slots) -> None:
        self.put(np.fromiter(slots, np.int64))

    def __len__(self) -> int:
        """Total free capacity in small slots (any order)."""
        return sum(len(blocks) << o for o, blocks in enumerate(self._free))

    def __iter__(self):
        """All free slot ids, ascending (FreeList iteration compat)."""
        out = []
        for o, blocks in enumerate(self._free):
            for start in blocks:
                out.extend(range(start, start + (1 << o)))
        return iter(sorted(out))

    # -- invariants --------------------------------------------------------------

    def check(self) -> bool:
        """Validate the allocator's invariants; raises AssertionError on rot.

        * every free/live block is aligned to its order;
        * free blocks and live allocations exactly partition [0, n_slots);
        * no two free buddies of the same order coexist (fully coalesced).
        """
        covered = np.zeros(self.n_slots, dtype=np.int8)
        for o, blocks in enumerate(self._free):
            for start in blocks:
                assert start % (1 << o) == 0, f"free block {start} misaligned @o{o}"
                assert covered[start : start + (1 << o)].sum() == 0, "overlap"
                covered[start : start + (1 << o)] = 1
                if o < self.max_order:
                    assert (start ^ (1 << o)) not in self._free[o], (
                        f"uncoalesced buddy pair at {start} order {o}"
                    )
        for start, o in self._alloc.items():
            assert start % (1 << o) == 0, f"live block {start} misaligned @o{o}"
            assert covered[start : start + (1 << o)].sum() == 0, "overlap"
            covered[start : start + (1 << o)] = 2
        assert covered.all(), "slots neither free nor allocated"
        return True
