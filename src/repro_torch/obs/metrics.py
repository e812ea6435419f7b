"""Metrics registry: counters, gauges, fixed-bucket histograms, exposition.

A :class:`MetricsRegistry` is a point-in-time rendering — built fresh per
scrape by :func:`build_registry` from a recorder's exact aggregates plus a
``MigrationStats`` snapshot — not a live store, so exposing it can never
mutate or alias pipeline state.  Two output formats:

* ``to_json()``   — machine-readable snapshot (benchmark ``telemetry``
                    blocks embed this).
* ``to_prometheus()`` — Prometheus text exposition format (``# TYPE``
                    lines, ``name{label="v"} value`` samples, cumulative
                    ``_bucket{le=...}`` histogram series).
"""

from __future__ import annotations

import bisect
import math

#: Fixed histogram buckets (upper bounds).  Fixed at class-of-metric level so
#: snapshots from different runs merge/compare bucket-for-bucket.
LATENCY_TICK_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)
LATENCY_WALL_BUCKETS_S = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0, 30.0,
)
AREA_BLOCK_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 1024)


class Histogram:
    """Fixed-bucket histogram (cumulative-friendly: counts per upper bound)."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Approximate quantile: the upper bound of the bucket holding the
        q-th observation (inf when it landed in the overflow bucket)."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for bound, c in zip(self.buckets + (math.inf,), self.counts):
            seen += c
            if seen >= rank:
                return bound
        return math.inf  # pragma: no cover - loop always reaches rank

    def to_dict(self) -> dict:
        return {
            "buckets": list(self.buckets),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
        }


def _label_key(labels: dict | None) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def _label_text(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class MetricsRegistry:
    """Counters, gauges and histograms with JSON + Prometheus rendering.

    All three kinds take an optional ``labels`` dict — e.g. per-link byte
    counters labeled ``{src, dst}`` or per-tenant latency histograms labeled
    ``{tenant}`` — rendered Prometheus-style (``name{k="v"}``); histogram
    bucket series merge their labels with the ``le`` bound.
    """

    def __init__(self):
        self._counters: dict[str, dict[tuple, float]] = {}
        self._gauges: dict[str, dict[tuple, float]] = {}
        self._hists: dict[str, dict[tuple, Histogram]] = {}

    # -- registration ------------------------------------------------------

    def counter(self, name: str, value, labels: dict | None = None) -> None:
        """Add ``value`` to counter ``name`` (per label set)."""
        series = self._counters.setdefault(name, {})
        key = _label_key(labels)
        series[key] = series.get(key, 0.0) + float(value)

    def gauge(self, name: str, value, labels: dict | None = None) -> None:
        """Set gauge ``name`` (per label set) to ``value``."""
        self._gauges.setdefault(name, {})[_label_key(labels)] = float(value)

    def histogram(self, name: str, hist: Histogram, labels: dict | None = None) -> None:
        """Attach a (pre-observed) histogram under ``name`` (per label set)."""
        self._hists.setdefault(name, {})[_label_key(labels)] = hist

    # -- rendering ---------------------------------------------------------

    def to_json(self) -> dict:
        """Plain-dict snapshot (labels flattened to ``name{k="v"}`` keys)."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, series in sorted(self._counters.items()):
            for key, v in sorted(series.items()):
                out["counters"][name + _label_text(key)] = v
        for name, series in sorted(self._gauges.items()):
            for key, v in sorted(series.items()):
                out["gauges"][name + _label_text(key)] = v
        for name, hists in sorted(self._hists.items()):
            for key, h in sorted(hists.items()):
                out["histograms"][name + _label_text(key)] = h.to_dict()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: list[str] = []
        for name, series in sorted(self._counters.items()):
            lines.append(f"# TYPE {name} counter")
            for key, v in sorted(series.items()):
                lines.append(f"{name}{_label_text(key)} {_fmt(v)}")
        for name, series in sorted(self._gauges.items()):
            lines.append(f"# TYPE {name} gauge")
            for key, v in sorted(series.items()):
                lines.append(f"{name}{_label_text(key)} {_fmt(v)}")
        for name, hists in sorted(self._hists.items()):
            lines.append(f"# TYPE {name} histogram")
            for key, h in sorted(hists.items()):
                cum = 0
                for bound, c in zip(h.buckets, h.counts):
                    cum += c
                    le = key + (("le", _fmt(bound)),)
                    lines.append(f"{name}_bucket{_label_text(le)} {cum}")
                inf = key + (("le", "+Inf"),)
                lines.append(f"{name}_bucket{_label_text(inf)} {h.count}")
                lines.append(f"{name}_sum{_label_text(key)} {_fmt(h.sum)}")
                lines.append(f"{name}_count{_label_text(key)} {h.count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def build_registry(recorder, stats=None) -> MetricsRegistry:
    """Render one driver's telemetry into a fresh :class:`MetricsRegistry`.

    ``recorder`` supplies the exact counter totals and the latency/area
    histograms; ``stats`` (a ``MigrationStats`` *snapshot* — pass a copy,
    not the live object) contributes the per-link byte counters and the
    tick/jit gauges that are tracked on stats rather than the recorder.
    """
    reg = MetricsRegistry()
    totals = recorder.counter_totals()
    for name, total in totals.items():
        reg.counter(f"leap_{name}_total", total)
    for name, hist in recorder.histograms().items():
        reg.histogram(f"leap_{name}", hist)
    reg.gauge("leap_telemetry_events_dropped", getattr(recorder, "dropped", 0))
    if stats is not None:
        reg.gauge("leap_ticks", stats.ticks)
        reg.gauge("leap_jit_cache_misses", stats.jit_cache_misses)
        # Tiering counters live on stats even with the recorder disabled;
        # emit from the snapshot unless the recorder already did (the
        # ``ctx.count`` mirror makes both totals identical when enabled).
        for name in ("tier_promotions", "tier_demotions", "ping_pong_migrations"):
            if name not in totals:
                reg.counter(f"leap_{name}_total", getattr(stats, name, 0))
        for (src, dst), nbytes in sorted(stats.bytes_per_link.items()):
            reg.counter(
                "leap_link_bytes_total", nbytes, labels={"src": src, "dst": dst}
            )
    return reg
