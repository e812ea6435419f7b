#!/usr/bin/env python3
"""Where a deployment-size drain of ``chip_smoke.py`` spends its time.

    python3 scripts/profile_drains.py

Runs the smoke's drains on the current CUDA device (131,072 blocks of 64
KiB, 64 writes and 64 reads a tick): the 2-region small-block drain through
the megastep (phase 3's, with ``warm_dispatch``) four times in turns, eager,
graphed, graphed, eager (eager: inside ``graphs.disable_capture()``, every
launch from Python; graphed: one CUDA graph replay a program), then graphed
the same pool through the batched generation and through the legacy one
(phase 35's ``chunk_blocks`` 16), and the 4-region ppermute drain through
the batched generation (its state placed on a one-card region mesh, one
pool tensor a region).  Each run is drained twice: once with
``LeapConfig(telemetry=True)``, printing the host milliseconds a tick in
each pipeline stage (the recorder's ``stage`` spans; nested spans each count
their own whole time) and in ``tick()``, and once under ``torch.profiler``,
from the first request to the end of the drain (the pool's set-up is
outside the window), printing the wall time, the device time summed over
kernels, their ratio (the device's busy share), the kernel count and the
kernels with the most device time.  Each run also records the graphs
captured and replayed over every migration program, and the application's
I/O programs' replays a tick (a tick's writes and reads are one replay
each when graphed).  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as smoke  # noqa: E402
from profile_serving import report  # noqa: E402
from repro_torch.core import graphs  # noqa: E402

SMALL = dict(smoke.DRAIN_CFG, warm_dispatch=True)
MEGASTEP = dict(slots=smoke.SLOTS, cfg_kw=SMALL, n_regions=2)
PPERMUTE = dict(slots=smoke.PP_SLOTS, cfg_kw=smoke.PP_CFG, n_regions=smoke.PP_REGIONS,
                ppermute=True)
BATCHED = dict(MEGASTEP, cfg_kw=dict(smoke.DRAIN_CFG, fused_dispatch="batched"))
LEGACY = dict(MEGASTEP, cfg_kw=dict(smoke.DRAIN_CFG, fused_dispatch="legacy", chunk_blocks=16))
# (name, drain, captured): the megastep eager and graphed in turns, then the
# other generations graphed
RUNS = (
    ("small (megastep, 2 regions), eager", MEGASTEP, False),
    ("small (megastep, 2 regions), graphed", MEGASTEP, True),
    ("small (megastep, 2 regions), graphed again", MEGASTEP, True),
    ("small (megastep, 2 regions), eager again", MEGASTEP, False),
    ("small (batched, 2 regions), graphed", BATCHED, True),
    ("small (legacy, 2 regions), graphed", LEGACY, True),
    ("ppermute (batched, 4 regions over region shards), graphed", PPERMUTE, True),
)


def run(dev, slots, cfg_kw, n_regions, ppermute=False, telemetry=False, window=None):
    mesh = smoke.make_region_mesh(n_regions, [dev] * n_regions) if ppermute else None
    cfg_kw = dict(cfg_kw, telemetry=telemetry, telemetry_events=1 << 20)
    return smoke.drain(dev, smoke.N_BLOCKS, slots, smoke.BLOCK, 1, smoke.SEED, cfg_kw=cfg_kw,
                       n_regions=n_regions, mesh=mesh, window=window)


def stage_ms_per_tick(drv) -> dict[str, float]:
    total = collections.Counter()
    for ev in drv.telemetry.events():
        if ev["kind"] == "stage":
            total[ev["name"]] += ev["dur"]
    ticks = drv.stats.ticks
    return {name: us / 1e3 / ticks for name, us in total.most_common()}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_drains: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    card = smoke.card()
    print(card)
    out = {}
    for name, kw, captured in RUNS:
        before, io_before = smoke.program_counts(), smoke.io_program_counts()
        with contextlib.nullcontext() if captured else graphs.disable_capture():
            drv, _, _, secs = run(dev, telemetry=True, **kw)
            stages = stage_ms_per_tick(drv)
            tick_ms = secs["tick_s"] / drv.stats.ticks * 1e3
            print(f"\n== {name}, telemetry on: {drv.stats.ticks} ticks, {secs['seconds']:.3f} s, "
                  f"tick() {tick_ms:.3f} ms a tick; host ms a tick in each stage:")
            for stage, ms in stages.items():
                print(f"   {stage:32s} {ms:8.3f}")
            del drv
            gc.collect()
            torch.cuda.empty_cache()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            drv, _, _, psecs = run(dev, window=prof, **kw)
        prof_out = report(f"{name}, under the profiler", prof, psecs["seconds"])
        now, io_now = smoke.program_counts(), smoke.io_program_counts()
        graphs_used = dict(captures=now[0] - before[0], replays=now[1] - before[1],
                           io_captures=io_now[0] - io_before[0],
                           io_replays=io_now[1] - io_before[1])
        # a tick's writes and reads over both runs, without the fills' writes
        fills = 2 * -(-smoke.N_BLOCKS // 16384) if captured else 0
        graphs_used["io_replays_a_tick"] = (graphs_used["io_replays"] - fills) / (
            secs["io_steps"] + psecs["io_steps"])
        print(f"   graphs over both runs, every migration program: {graphs_used} [{card}]")
        out[name] = dict(stage_ms_per_tick=stages, tick_ms=tick_ms, drain=secs,
                         profiled=prof_out, profiled_drain=psecs, graphs=graphs_used,
                         stats=dataclasses.asdict(drv.stats) | {"bytes_per_link": None})
        del drv
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"profile_drains": out, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
