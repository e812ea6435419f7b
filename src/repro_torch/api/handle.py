"""Per-request futures: the `page_leap()` caller's view of one migration.

A :class:`LeapHandle` wraps the driver-side :class:`repro.core.driver.
RequestState` accounting record that every commit/force/cancel verdict is
credited against, so the handle observes progress without polling the device:
the host mirror is exact (DESIGN.md §4) and updated synchronously with every
verdict the driver harvests.
"""

from __future__ import annotations

import dataclasses
import enum


class HandleStatus(enum.Enum):
    QUEUED = "queued"  # accepted; no epoch opened, nothing resolved yet
    COPYING = "copying"  # at least one block copying, committed, or dropped
    COMMITTED = "committed"  # terminal: every enqueued block reached dst
    PARTIAL = "partial"  # terminal: cancelled after partial progress
    CANCELLED = "cancelled"  # terminal: cancelled before anything committed


@dataclasses.dataclass(frozen=True)
class Progress:
    """Snapshot of one request's per-block accounting.

    ``committed + forced + cancelled + remaining == requested`` always;
    ``remaining == 0`` exactly when the handle is terminal.
    """

    requested: int
    committed: int  # clean commits (the copy survived its dirty check)
    forced: int  # write-through escalations (copy+flip, race-free)
    cancelled: int  # dropped by cancel() before committing
    remaining: int


class LeapHandle:
    """Future for one ``session.leap(...)`` request.

    The handle never touches driver privates: it reads the shared
    :class:`RequestState` record and drives the public ``tick()``/``poll()``
    migration loop when asked to ``wait()``.
    """

    __slots__ = ("_driver", "_req", "tag")

    def __init__(self, driver, req, tag=None):
        self._driver = driver
        self._req = req
        self.tag = tag  # optional caller label (e.g. a sequence id)

    # -- observation -------------------------------------------------------

    @property
    def request_id(self) -> int:
        return self._req.rid

    @property
    def dst_region(self) -> int:
        return self._req.dst_region

    @property
    def priority(self) -> int:
        return self._req.priority

    @property
    def requested(self) -> int:
        """Blocks this request actually enqueued (after dedup/skip)."""
        return self._req.requested

    @property
    def done(self) -> bool:
        return self._req.done

    def progress(self) -> Progress:
        r = self._req
        return Progress(
            requested=r.requested,
            committed=r.committed,
            forced=r.forced,
            cancelled=r.cancelled,
            remaining=r.remaining,
        )

    def latency(self):
        """Telemetry latency breakdown for this request (a
        :class:`repro.obs.LatencyBreakdown`: queue vs copy time in ticks and
        wall seconds, epochs/retries/relay hops), or None when telemetry is
        disabled or the span was evicted.  Live requests report progress so
        far; terminal ones are final."""
        return self._driver.telemetry.latency(self._req.rid)

    @property
    def status(self) -> HandleStatus:
        r = self._req
        if r.done:
            if r.cancelled and r.cancelled == r.requested:
                return HandleStatus.CANCELLED
            if r.cancelled:
                return HandleStatus.PARTIAL
            return HandleStatus.COMMITTED
        if (
            r.committed or r.forced or r.cancelled
            or self._driver.request_in_flight(r.rid)
        ):
            return HandleStatus.COPYING
        return HandleStatus.QUEUED

    # -- control -----------------------------------------------------------

    def wait(self, max_ticks: int = 100_000) -> bool:
        """Drive migration ticks until THIS request resolves (or the tick
        budget ends).  Other queued work keeps its place in the priority
        order; returns True once the handle is terminal."""
        ticks = 0
        while not self.done and ticks < max_ticks:
            self._driver.tick()
            self._driver.poll(block=True)
            ticks += 1
        return self.done

    def cancel(self) -> int:
        """Drop the request's not-yet-opened areas (their reserved
        destination slots are never leaked — queued areas hold none) and mark
        it cancelled; in-flight epochs finish their current verdict, with any
        dirty remainder dropped instead of requeued.  Returns the number of
        blocks dropped immediately."""
        return self._driver.cancel_request(self._req.rid)

    def on_done(self, fn) -> "LeapHandle":
        """Register ``fn(handle)`` to run when the request resolves (fires
        immediately if it already has)."""
        if self._req.done:
            fn(self)
        else:
            self._req.callbacks.append(lambda _req: fn(self))
        return self

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        p = self.progress()
        return (
            f"LeapHandle(rid={self._req.rid}, dst={self._req.dst_region}, "
            f"status={self.status.name}, {p.committed}+{p.forced}c/f "
            f"{p.cancelled}x of {p.requested})"
        )
