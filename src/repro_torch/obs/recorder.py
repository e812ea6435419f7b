"""Bounded telemetry recorder: the event log behind pipeline tracing.

One :class:`TelemetryRecorder` rides on every ``PipelineContext`` (built by
the driver when ``LeapConfig.telemetry`` is on; the shared
:data:`NULL_RECORDER` otherwise).  Three event families, all stored as plain
dicts in one bounded ring:

* ``stage``    timed spans — per-tick pipeline stage timers and sync
               points, emitted via the ``with recorder.stage(name):``
               context manager (``ts``/``dur`` in microseconds).
* ``request``  per-request lifecycle marks — SUBMITTED → ADMITTED → ROUTED
               → EPOCH_OPEN×n → RETRY/RELAY → VERDICT → terminal
               COMMITTED/FORCED/CANCELLED/PARTIAL — each stamped with both
               the tick clock and the wall clock.
* ``counter``  accounting increments, mirrored from ``MigrationStats``
               through ``PipelineContext.count`` so the event log and the
               stats can be diffed for drift.

The ring is strictly bounded (``capacity`` events; evictions are counted in
``dropped``), but two structures never drop so aggregates stay exact:
``counter_totals()`` (a tiny name → running-total dict) and the fixed-bucket
histograms (request latency in ticks/wall, area sizes).  Per-request spans
live in a separate bounded LRU so ``latency(rid)`` works after the driver
pruned its own registry entry.

:class:`NullRecorder` is the disabled stand-in: every hook is a no-op and
``stage()`` returns one shared null context manager, so a disabled pipeline
pays a few attribute lookups per tick and allocates nothing.
"""

from __future__ import annotations

import collections
import dataclasses
import time

from repro_torch.obs.metrics import (
    AREA_BLOCK_BUCKETS,
    LATENCY_TICK_BUCKETS,
    LATENCY_WALL_BUCKETS_S,
    Histogram,
)

#: Lifecycle phases a request span moves through (terminal ones last).
REQUEST_PHASES = (
    "SUBMITTED",
    "ADMITTED",
    "ROUTED",
    "EPOCH_OPEN",
    "RETRY",
    "RELAY",
    "VERDICT",
    "COMMITTED",
    "FORCED",
    "PARTIAL",
    "CANCELLED",
)
TERMINAL_PHASES = ("COMMITTED", "FORCED", "PARTIAL", "CANCELLED")


@dataclasses.dataclass
class RequestSpan:
    """Lifecycle accounting for one request (the recorder's half of a rid)."""

    rid: int
    dst_region: int
    priority: int
    submitted_tick: int
    submitted_ts: float  # microseconds on the recorder clock
    requested: int = 0
    areas: int = 0  # areas routed (ROUTED events)
    epochs: int = 0  # epoch opens, retries included
    retries: int = 0  # dirty rejections observed by verdicts
    relay_hops: int = 0  # relay second hops enqueued
    first_epoch_tick: int | None = None
    first_epoch_ts: float | None = None
    resolved_tick: int | None = None
    resolved_ts: float | None = None
    outcome: str | None = None  # terminal phase, None while live
    committed: int = 0
    forced: int = 0
    cancelled: int = 0


@dataclasses.dataclass(frozen=True)
class LatencyBreakdown:
    """What ``LeapHandle.latency()`` returns: one request's time, attributed.

    ``queue_*`` covers submit → first epoch open (pure scheduling delay);
    ``copy_*`` covers first epoch open → resolution (epochs, retries,
    relays).  A request that resolved without ever opening an epoch (fully
    deduplicated, or cancelled from the queue) has ``copy_* == 0`` and its
    whole life counted as queue time.  For a still-live request the totals
    run to "now" and ``outcome`` is None.
    """

    rid: int
    outcome: str | None
    requested: int
    committed: int
    forced: int
    cancelled: int
    ticks_total: int
    wall_s: float
    queue_ticks: int
    queue_wall_s: float
    copy_ticks: int
    copy_wall_s: float
    epochs: int
    retries: int
    relay_hops: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """Disabled telemetry: strictly no-op, shared, allocation-free hooks."""

    __slots__ = ()

    enabled = False
    capacity = 0
    dropped = 0
    tick = 0

    def begin_tick(self, tick: int) -> None:
        pass

    def stage(self, name: str, **args):
        return _NULL_SPAN

    def count(self, name: str, n: int = 1, **args) -> None:
        pass

    def event(self, kind: str, name: str, **args) -> None:
        pass

    def request_submitted(self, rid, dst_region, priority) -> None:
        pass

    def request_phase(self, rid, phase, n: int = 0, **args) -> None:
        pass

    def request_resolved(self, rid, committed, forced, cancelled, requested) -> None:
        pass

    def events(self) -> list:
        return []

    def counter_totals(self) -> dict:
        return {}

    def histograms(self) -> dict:
        return {}

    def request_spans(self) -> list:
        return []

    def latency(self, rid: int):
        return None

    def clear(self) -> None:
        pass


#: The one shared disabled recorder (identity-comparable in tests).
NULL_RECORDER = NullRecorder()


class _Span:
    """Context manager emitting one ``stage`` event on exit."""

    __slots__ = ("_rec", "_name", "_args", "_t0")

    def __init__(self, rec: "TelemetryRecorder", name: str, args: dict):
        self._rec = rec
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = self._rec._now_us()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        ev = {
            "kind": "stage",
            "name": self._name,
            "tick": rec.tick,
            "ts": self._t0,
            "dur": rec._now_us() - self._t0,
        }
        if self._args:
            ev["args"] = self._args
        rec._append(ev)
        return False


class TelemetryRecorder:
    """Bounded in-memory event log (see module docstring)."""

    enabled = True

    def __init__(
        self,
        capacity: int = 65536,
        request_capacity: int = 1024,
        clock=time.perf_counter,
    ):
        self.capacity = int(capacity)
        self.request_capacity = int(request_capacity)
        self._clock = clock
        self._t0 = clock()
        self._events: collections.deque = collections.deque(maxlen=self.capacity)
        self.dropped = 0  # events evicted from the full ring
        self.tick = 0  # last tick the driver announced via begin_tick
        self._totals: dict[str, int] = {}  # exact counter aggregates (never drop)
        self._live: collections.OrderedDict[int, RequestSpan] = collections.OrderedDict()
        self._done: collections.OrderedDict[int, RequestSpan] = collections.OrderedDict()
        self._hists = {
            "request_latency_ticks": Histogram(LATENCY_TICK_BUCKETS),
            "request_latency_wall_s": Histogram(LATENCY_WALL_BUCKETS_S),
            "area_blocks": Histogram(AREA_BLOCK_BUCKETS),
        }

    # -- clock / ring ------------------------------------------------------

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _append(self, ev: dict) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    def begin_tick(self, tick: int) -> None:
        """Stamp the tick clock; subsequent events attribute to ``tick``."""
        self.tick = int(tick)

    # -- event families ----------------------------------------------------

    def stage(self, name: str, **args) -> _Span:
        """Timed span: ``with recorder.stage("dispatch.run_tick"): ...``."""
        return _Span(self, name, args)

    def event(self, kind: str, name: str, **args) -> None:
        """One instant event (free-form ``kind``/``name``)."""
        ev = {"kind": kind, "name": name, "tick": self.tick, "ts": self._now_us()}
        if args:
            ev["args"] = args
        self._append(ev)

    def count(self, name: str, n: int = 1, **args) -> None:
        """Counter increment: exact running total + one ring event."""
        total = self._totals.get(name, 0) + n
        self._totals[name] = total
        ev = {
            "kind": "counter",
            "name": name,
            "tick": self.tick,
            "ts": self._now_us(),
            "n": n,
            "total": total,
        }
        if args:
            ev["args"] = args
        self._append(ev)

    # -- request lifecycle -------------------------------------------------

    def request_submitted(self, rid: int, dst_region: int, priority: int) -> None:
        span = RequestSpan(
            rid=int(rid),
            dst_region=int(dst_region),
            priority=int(priority),
            submitted_tick=self.tick,
            submitted_ts=self._now_us(),
        )
        self._live[span.rid] = span
        self._req_event(span, "SUBMITTED", dst=span.dst_region, priority=span.priority)

    def request_phase(self, rid: int, phase: str, n: int = 0, **args) -> None:
        """Mark one lifecycle phase on request ``rid`` (ignores unknown rids
        — the span may have been evicted from the bounded store)."""
        span = self._live.get(rid)
        if span is None:
            return
        if phase == "ADMITTED":
            span.requested = n
        elif phase == "ROUTED":
            span.areas += n
        elif phase == "EPOCH_OPEN":
            span.epochs += 1
            if span.first_epoch_tick is None:
                span.first_epoch_tick = self.tick
                span.first_epoch_ts = self._now_us()
            self._hists["area_blocks"].observe(n)
        elif phase == "RETRY":
            span.retries += n
        elif phase == "RELAY":
            span.relay_hops += n
        self._req_event(span, phase, n=n, **args)

    def request_resolved(
        self, rid: int, committed: int, forced: int, cancelled: int, requested: int
    ) -> None:
        """Terminal mark: classify the outcome, observe latency histograms,
        and move the span to the bounded finished store."""
        span = self._live.pop(rid, None)
        if span is None:
            return
        span.requested = requested
        span.committed, span.forced, span.cancelled = committed, forced, cancelled
        if requested and cancelled == requested:
            span.outcome = "CANCELLED"
        elif cancelled:
            span.outcome = "PARTIAL"
        elif requested and forced == requested:
            span.outcome = "FORCED"
        else:
            span.outcome = "COMMITTED"
        span.resolved_tick = self.tick
        span.resolved_ts = self._now_us()
        self._hists["request_latency_ticks"].observe(
            span.resolved_tick - span.submitted_tick
        )
        self._hists["request_latency_wall_s"].observe(
            (span.resolved_ts - span.submitted_ts) / 1e6
        )
        self._done[rid] = span
        while len(self._done) > self.request_capacity:
            self._done.popitem(last=False)
        self._req_event(
            span, span.outcome, committed=committed, forced=forced, cancelled=cancelled
        )

    def _req_event(self, span: RequestSpan, phase: str, **args) -> None:
        ev = {
            "kind": "request",
            "name": phase,
            "rid": span.rid,
            "tick": self.tick,
            "ts": self._now_us(),
        }
        if args:
            ev["args"] = args
        self._append(ev)

    # -- observation -------------------------------------------------------

    def events(self) -> list[dict]:
        """Copy of the ring (oldest first)."""
        return [dict(ev) for ev in self._events]

    def counter_totals(self) -> dict[str, int]:
        """Exact running totals per counter name (never dropped)."""
        return dict(self._totals)

    def histograms(self) -> dict[str, Histogram]:
        """The recorder's fixed-bucket histograms (live objects; callers
        render them via :func:`repro.obs.metrics.build_registry`)."""
        return dict(self._hists)

    def request_spans(self) -> list[RequestSpan]:
        """Finished + live spans, oldest first (copies not needed: spans of
        finished requests are no longer written)."""
        return list(self._done.values()) + list(self._live.values())

    def latency(self, rid: int) -> LatencyBreakdown | None:
        """Latency breakdown for ``rid`` (None: unknown/evicted span)."""
        span = self._done.get(rid) or self._live.get(rid)
        if span is None:
            return None
        end_tick = span.resolved_tick if span.resolved_tick is not None else self.tick
        end_ts = span.resolved_ts if span.resolved_ts is not None else self._now_us()
        split_tick = span.first_epoch_tick if span.first_epoch_tick is not None else end_tick
        split_ts = span.first_epoch_ts if span.first_epoch_ts is not None else end_ts
        return LatencyBreakdown(
            rid=span.rid,
            outcome=span.outcome,
            requested=span.requested,
            committed=span.committed,
            forced=span.forced,
            cancelled=span.cancelled,
            ticks_total=end_tick - span.submitted_tick,
            wall_s=(end_ts - span.submitted_ts) / 1e6,
            queue_ticks=split_tick - span.submitted_tick,
            queue_wall_s=(split_ts - span.submitted_ts) / 1e6,
            copy_ticks=end_tick - split_tick,
            copy_wall_s=(end_ts - split_ts) / 1e6,
            epochs=span.epochs,
            retries=span.retries,
            relay_hops=span.relay_hops,
        )

    def clear(self) -> None:
        """Drop buffered events (totals, histograms and spans survive —
        they are aggregates, not a log)."""
        self._events.clear()


def make_recorder(cfg) -> TelemetryRecorder | NullRecorder:
    """The driver's factory: a live recorder per ``LeapConfig`` with
    telemetry on, the shared :data:`NULL_RECORDER` otherwise."""
    if getattr(cfg, "telemetry", False):
        return TelemetryRecorder(
            capacity=cfg.telemetry_events, request_capacity=cfg.telemetry_requests
        )
    return NULL_RECORDER
