"""Host-side work queues of the migration pipeline.

``FreeList`` (vectorized free-slot stack), ``AreaQueue`` (strict-priority
area queue), and ``CommitBatch`` (one in-flight commit dispatch awaiting its
verdict, held as a :class:`VerdictFuture`) were extracted from
``core/driver.py`` when the driver decomposed into the staged pipeline;
``from repro_torch.core.driver import FreeList`` keeps working through the
driver's re-export shim.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.core.adaptive import Area


class FreeList:
    """LIFO free-slot list backed by a numpy array (vectorized alloc/free).

    ``take``/``put`` move n slots in one slice; ``popleft``/``append``/
    iteration keep the deque-ish API the baselines (SyncResharder,
    AutoBalancer) and tests use.  Note ``popleft`` pops from the top of the
    stack — callers only rely on getting *some* free slot, not on FIFO order.
    """

    def __init__(self, slots: np.ndarray):
        slots = np.asarray(slots, dtype=np.int32)
        self._buf = slots.copy()
        self._n = len(slots)

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return iter(self._buf[: self._n].tolist())

    def take(self, n: int) -> np.ndarray | None:
        """Pop ``n`` slots at once, or None if fewer are available."""
        if self._n < n:
            return None
        out = self._buf[self._n - n : self._n].copy()
        self._n -= n
        return out

    def put(self, slots: np.ndarray) -> None:
        """Push a batch of slots."""
        slots = np.asarray(slots, dtype=np.int32)
        need = self._n + len(slots)
        if need > len(self._buf):
            grown = np.empty(max(need, 2 * len(self._buf) + 1), np.int32)
            grown[: self._n] = self._buf[: self._n]
            self._buf = grown
        self._buf[self._n : need] = slots
        self._n = need

    # deque-compat shims (baselines allocate one slot at a time)
    def popleft(self) -> int:
        if self._n == 0:
            raise IndexError("pop from empty FreeList")
        self._n -= 1
        return int(self._buf[self._n])

    def append(self, slot: int) -> None:
        self.put(np.asarray([slot], np.int32))

    def extend(self, slots) -> None:
        self.put(np.fromiter(slots, np.int32))


class AreaQueue:
    """Priority-ordered area queue: strictly higher ``Area.priority`` first,
    FIFO within one priority class.  ``appendleft`` returns a requeued area
    to the head of its own class (preserving the legacy deque semantics for
    single-priority workloads)."""

    def __init__(self):
        self._buckets: dict[int, deque[Area]] = {}

    def _bucket(self, priority: int) -> deque[Area]:
        b = self._buckets.get(priority)
        if b is None:
            b = self._buckets[priority] = deque()
        return b

    def __len__(self) -> int:
        return sum(len(b) for b in self._buckets.values())

    def __iter__(self):
        for p in sorted(self._buckets, reverse=True):
            yield from self._buckets[p]

    def append(self, area: Area) -> None:
        self._bucket(area.priority).append(area)

    def appendleft(self, area: Area) -> None:
        self._bucket(area.priority).appendleft(area)

    def extend(self, areas) -> None:
        for a in areas:
            self.append(a)

    def popleft(self) -> Area:
        for p in sorted(self._buckets, reverse=True):
            b = self._buckets[p]
            if b:
                return b.popleft()
        raise IndexError("pop from empty AreaQueue")

    def remove_request(self, rid: int) -> list[Area]:
        """Drop (and return) every queued area belonging to request ``rid``."""
        dropped = []
        for p, b in self._buckets.items():
            keep = deque()
            for a in b:
                (dropped if a.request_id == rid else keep).append(a)
            self._buckets[p] = keep
        return dropped


class VerdictFuture:
    """A dirty verdict on its way from the device to the host.

    On CUDA the constructor enqueues a ``non_blocking`` copy into pinned host
    memory on the current stream and records an event after it, so that
    neither blocks the host: :meth:`is_ready` asks the event, and
    :meth:`result` waits on it (the pipeline's only device->host sync).  A
    CPU verdict is ready at once.
    """

    def __init__(self, verdict: torch.Tensor):
        self._event = None
        if verdict.is_cuda:
            host = torch.empty(verdict.shape, dtype=verdict.dtype, pin_memory=True)
            host.copy_(verdict, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(verdict.device))
            verdict = host
        self._host = verdict

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def result(self) -> np.ndarray:
        """The packed verdict on the host, waiting for the device if needed."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclasses.dataclass
class CommitBatch:
    """One in-flight commit dispatch: areas packed into a single verdict."""

    areas: list[Area]
    offsets: np.ndarray  # [len(areas) + 1] prefix offsets into verdict
    verdict: VerdictFuture  # packed verdict, device -> host


# Legacy private spellings (pre-pipeline driver internals).
_AreaQueue = AreaQueue
_CommitBatch = CommitBatch
