"""Read-only telemetry facade handed out by the public API.

``LeapSession.telemetry()`` / ``PoolFacade.telemetry()`` return a
:class:`TelemetryView` — a thin bundle over the driver's recorder and a
stats-snapshot thunk.  Everything it returns is a copy or a fresh
rendering; holding a view cannot mutate or alias pipeline state.
"""

from __future__ import annotations

from repro_torch.obs.metrics import MetricsRegistry, build_registry
from repro_torch.obs.trace import chrome_trace, summarize, write_chrome_trace


class TelemetryView:
    """Point-in-time telemetry accessor for one migration driver."""

    __slots__ = ("_recorder", "_stats_fn", "_extra_fn")

    def __init__(self, recorder, stats_fn=None, extra_fn=None):
        self._recorder = recorder
        self._stats_fn = stats_fn
        self._extra_fn = extra_fn

    def with_extra(self, extra_fn) -> "TelemetryView":
        """A sibling view whose metrics include extra series: ``extra_fn(reg)``
        runs against each freshly built :class:`MetricsRegistry` — the hook a
        layer above the driver (e.g. the serving engine's per-tenant store)
        uses to co-expose its series in the same scrape.

        Hooks *stack*: extras already attached to this view keep running (in
        attachment order) before the new one, so e.g. the serving engine's
        tenant series compose with the tier-residency gauges the session
        attached underneath rather than replacing them.
        """
        prev = self._extra_fn
        if prev is not None:
            new = extra_fn

            def extra_fn(reg, _prev=prev, _new=new):
                _prev(reg)
                _new(reg)

        return TelemetryView(self._recorder, self._stats_fn, extra_fn)

    @property
    def enabled(self) -> bool:
        return self._recorder.enabled

    # -- raw event access --------------------------------------------------

    def events(self) -> list[dict]:
        """Buffered events (oldest first; bounded by the ring capacity)."""
        return self._recorder.events()

    def counters(self) -> dict:
        """Exact counter totals — never subject to ring eviction."""
        return self._recorder.counter_totals()

    def request_spans(self) -> list:
        """Live + recently resolved request lifecycle spans."""
        return self._recorder.request_spans()

    def latency(self, rid: int):
        """Latency breakdown for one request id (None if unknown/evicted)."""
        return self._recorder.latency(rid)

    # -- metrics -----------------------------------------------------------

    def metrics(self) -> MetricsRegistry:
        stats = self._stats_fn() if self._stats_fn is not None else None
        reg = build_registry(self._recorder, stats)
        if self._extra_fn is not None:
            self._extra_fn(reg)
        return reg

    def metrics_json(self) -> dict:
        return self.metrics().to_json()

    def metrics_text(self) -> str:
        """Prometheus text exposition of the current metrics."""
        return self.metrics().to_prometheus()

    # -- trace export ------------------------------------------------------

    def chrome_trace(self, label: str = "leap") -> dict:
        """Render the buffered events as a Chrome trace-event JSON object."""
        return chrome_trace([(label, self._recorder)])

    def write_trace(self, path: str, label: str = "leap") -> dict:
        """Validate and write a Perfetto-loadable trace file."""
        return write_chrome_trace(path, [(label, self._recorder)])

    def summary(self, label: str = "leap") -> dict:
        """Compact aggregate summary (what bench ``telemetry`` blocks embed)."""
        return summarize([(label, self._recorder)])
