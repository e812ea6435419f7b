"""Pipeline telemetry: bounded event recording, metrics, trace export.

The observability layer of the migration engine (DESIGN.md §10).  Three
pieces, deliberately decoupled from :mod:`repro.core` (core imports obs,
never the reverse):

``recorder``   :class:`TelemetryRecorder` — a bounded ring buffer of
               pipeline events (per-tick stage timers, per-request
               lifecycle spans, counter increments) carried on the
               ``PipelineContext``.  :class:`NullRecorder` is the strict
               no-op stand-in installed when telemetry is disabled.
``metrics``    :class:`MetricsRegistry` — counters, gauges and fixed-bucket
               histograms with a JSON snapshot and Prometheus-style text
               exposition; ``build_registry`` renders a recorder (plus a
               ``MigrationStats`` snapshot) into one.
``trace``      Chrome trace-event JSON export (Perfetto-loadable): stage
               timers become complete ("X") slices, request lifecycles
               become async ("b"/"n"/"e") spans, counters become "C"
               series.  ``validate_chrome_trace`` checks the schema.

:class:`TelemetryView` (``view``) bundles the three behind the public API:
``LeapSession.telemetry()`` / ``PoolFacade.telemetry()`` return one.
"""

from repro_torch.obs.metrics import Histogram, MetricsRegistry, build_registry
from repro_torch.obs.recorder import (
    NULL_RECORDER,
    LatencyBreakdown,
    NullRecorder,
    RequestSpan,
    TelemetryRecorder,
    make_recorder,
)
from repro_torch.obs.trace import (
    chrome_trace,
    summarize,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.view import TelemetryView

__all__ = [
    "Histogram",
    "LatencyBreakdown",
    "MetricsRegistry",
    "NULL_RECORDER",
    "NullRecorder",
    "RequestSpan",
    "TelemetryRecorder",
    "TelemetryView",
    "build_registry",
    "chrome_trace",
    "make_recorder",
    "summarize",
    "validate_chrome_trace",
    "write_chrome_trace",
]
