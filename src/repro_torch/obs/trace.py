"""Chrome trace-event export: render recorder events as a Perfetto timeline.

``chrome_trace`` turns one or more recorders into the Chrome trace-event
JSON object format (https://ui.perfetto.dev loads it directly):

* ``stage`` events   → complete ("X") slices on the pool's tick-loop track —
                       stage timers nest under their enclosing ``tick`` span
                       by time containment, giving the flame-style view.
* ``request`` events → async spans (ph "b"/"n"/"e", ``id`` = request id,
                       cat "request"): one horizontal span per request
                       lifecycle with phase instants along it.
* ``counter`` events → counter ("C") series carrying the running total.

Each recorder (pool) becomes its own trace process (``pid``), named via a
metadata event, so a benchmark suite that builds several pools lands as
side-by-side process groups in one file.

``validate_chrome_trace`` is the schema check Perfetto's loader relies on
(required keys per phase type, JSON-serializability); tests and the chaos
dump path run it before writing.
"""

from __future__ import annotations

import json

_REQ_TERMINAL = {"COMMITTED", "FORCED", "PARTIAL", "CANCELLED"}
TICK_TID = 0


def _pool_events(events: list[dict], pid: int) -> list[dict]:
    out: list[dict] = []
    open_rids: set[int] = set()
    for ev in events:
        kind = ev.get("kind")
        args = dict(ev.get("args", ()))
        args["tick"] = ev.get("tick", 0)
        if kind == "stage":
            out.append(
                {
                    "ph": "X",
                    "name": ev["name"],
                    "cat": "stage",
                    "ts": ev["ts"],
                    "dur": max(0.0, ev.get("dur", 0.0)),
                    "pid": pid,
                    "tid": TICK_TID,
                    "args": args,
                }
            )
        elif kind == "counter":
            out.append(
                {
                    "ph": "C",
                    "name": ev["name"],
                    "ts": ev["ts"],
                    "pid": pid,
                    "tid": TICK_TID,
                    "args": {ev["name"]: ev.get("total", ev.get("n", 0))},
                }
            )
        elif kind == "request":
            rid = ev["rid"]
            phase = ev["name"]
            base = {
                "cat": "request",
                "id": rid,
                "ts": ev["ts"],
                "pid": pid,
                "tid": TICK_TID,
                "args": {**args, "phase": phase},
            }
            if phase == "SUBMITTED":
                open_rids.add(rid)
                out.append({"ph": "b", "name": f"leap-{rid}", **base})
            elif phase in _REQ_TERMINAL:
                if rid in open_rids:  # unmatched ends confuse the async track
                    open_rids.discard(rid)
                    out.append({"ph": "n", "name": phase, **base})
                    out.append({"ph": "e", "name": f"leap-{rid}", **base})
            else:
                if rid in open_rids:
                    out.append({"ph": "n", "name": phase, **base})
        else:  # free-form event() marks become instants
            out.append(
                {
                    "ph": "i",
                    "name": ev.get("name", kind or "event"),
                    "s": "t",
                    "ts": ev["ts"],
                    "pid": pid,
                    "tid": TICK_TID,
                    "args": args,
                }
            )
    # A trace cut mid-run (or a bounded ring that evicted the SUBMITTED
    # mark) may leave async spans open; close them at the last timestamp so
    # the file stays loadable.
    if open_rids and out:
        last_ts = max(e["ts"] for e in out)
        for rid in sorted(open_rids):
            out.append(
                {
                    "ph": "e",
                    "name": f"leap-{rid}",
                    "cat": "request",
                    "id": rid,
                    "ts": last_ts,
                    "pid": pid,
                    "tid": TICK_TID,
                    "args": {"phase": "OPEN_AT_EXPORT"},
                }
            )
    return out


def chrome_trace(groups, other_data: dict | None = None) -> dict:
    """Render recorders to one Chrome trace-event JSON object.

    ``groups``: an iterable of ``(label, recorder_or_event_list)`` — each
    becomes one trace process; or a single recorder (one process, label
    "leap").  Returns the JSON-ready dict (see :func:`write_chrome_trace`).
    """
    if hasattr(groups, "events"):
        groups = [("leap", groups)]
    trace_events: list[dict] = []
    for pid, (label, rec) in enumerate(groups):
        events = rec.events() if hasattr(rec, "events") else list(rec)
        trace_events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": TICK_TID,
                "args": {"name": str(label)},
            }
        )
        trace_events.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": pid,
                "tid": TICK_TID,
                "args": {"name": "tick loop"},
            }
        )
        trace_events.extend(_pool_events(events, pid))
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": dict(other_data or {}),
    }


def write_chrome_trace(path: str, groups, other_data: dict | None = None) -> dict:
    """Validate and write a trace file; returns the trace dict."""
    trace = chrome_trace(groups, other_data=other_data)
    validate_chrome_trace(trace)
    with open(path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return trace


def validate_chrome_trace(trace: dict) -> None:
    """Check the trace-event schema Perfetto's loader accepts.

    Raises ``ValueError`` on the first malformed event.  Checked: the
    top-level object shape, JSON-serializability, and the per-phase
    required fields ("X" needs ``dur``; async "b"/"n"/"e" need ``id`` and
    ``cat``; every non-metadata event needs numeric ``ts`` and ``pid``/
    ``tid``); async begins and ends must pair up per (cat, id).
    """
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    json.dumps(trace)  # must serialize (catches ndarray/np scalar leaks)
    async_depth: dict[tuple, int] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph is None:
            raise ValueError(f"event {i}: missing 'ph'")
        if "name" not in ev:
            raise ValueError(f"event {i}: missing 'name'")
        if ph == "M":
            continue
        for field in ("ts", "pid", "tid"):
            if not isinstance(ev.get(field), (int, float)):
                raise ValueError(f"event {i} ({ph}): missing numeric {field!r}")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"event {i}: 'X' event needs numeric 'dur'")
        if ph in ("b", "n", "e"):
            if "id" not in ev or "cat" not in ev:
                raise ValueError(f"event {i}: async {ph!r} needs 'id' and 'cat'")
            key = (ev["cat"], ev["id"])
            if ph == "b":
                async_depth[key] = async_depth.get(key, 0) + 1
            elif ph == "e":
                if async_depth.get(key, 0) < 1:
                    raise ValueError(f"event {i}: async end without begin for {key}")
                async_depth[key] -= 1
    unclosed = {k: d for k, d in async_depth.items() if d}
    if unclosed:
        raise ValueError(f"unclosed async spans: {sorted(unclosed)}")


def summarize(groups) -> dict:
    """Compact telemetry summary for embedding (e.g. in ``BENCH_*.json``).

    Aggregates across pools: event/drop totals, exact counter totals,
    per-stage time totals from the buffered spans, and resolved-request
    latency stats (count / p50 / max ticks) from the recorders' histograms.
    """
    if hasattr(groups, "events"):
        groups = [("leap", groups)]
    groups = list(groups)
    counters: dict[str, int] = {}
    stage_us: dict[str, float] = {}
    n_events = n_dropped = 0
    lat_count = 0
    lat_p50 = lat_max = 0.0
    for _label, rec in groups:
        n_dropped += getattr(rec, "dropped", 0)
        for name, total in rec.counter_totals().items():
            counters[name] = counters.get(name, 0) + total
        for ev in rec.events():
            n_events += 1
            if ev.get("kind") == "stage":
                stage_us[ev["name"]] = stage_us.get(ev["name"], 0.0) + ev.get("dur", 0.0)
        hist = rec.histograms().get("request_latency_ticks")
        if hist is not None and hist.count:
            lat_count += hist.count
            lat_p50 = max(lat_p50, hist.quantile(0.5))
            nonzero = [b for b, c in zip(hist.buckets, hist.counts) if c]
            lat_max = max(lat_max, nonzero[-1] if nonzero else hist.buckets[-1])
    return {
        "pools": len(groups),
        "events": n_events,
        "events_dropped": n_dropped,
        "counters": dict(sorted(counters.items())),
        "stage_totals_us": {k: round(v, 1) for k, v in sorted(stage_us.items())},
        "requests_resolved": lat_count,
        "request_latency_ticks_p50": lat_p50,
        "request_latency_ticks_max_bucket": lat_max,
    }
