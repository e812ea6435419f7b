#!/usr/bin/env python3
"""Where a full-width decode step of the port's ``PagedEngine`` spends its time.

    python3 scripts/profile_serving.py [--deployment granite_3_2b] [--trace serving_trace.json]

Builds a serving deployment of ``chip_smoke.py`` on the current CUDA device
(random bf16 weights from seed 0, 8 prompts of 512 tokens): granite_3_2b at
full width and depth (phase 7, the default), or one of phase 23's MoE
stacks at published widths with the depth cut (``qwen3_moe_235b_a22b``,
``dbrx_132b``), or phase 31's nemotron_4_340b (7 of 96 layers).  It admits
the prompts, warms up with 8 decode steps (the first captures the decode
step's CUDA graph), then times windows of 8 steps without the profiler in
turns: eager (inside ``graphs.disable_capture()``, every launch from
Python), graphed (one replay a step), graphed, eager.  Then it profiles one
more admission, and 4 decode steps graphed and 4 eager, with
``torch.profiler``.  Prints, for each profiled window, the wall time, the
device time summed over kernels and their ratio (the device's busy share),
the kernel count, then the 20 host ops with the most host time and the 20
kernels with the most device time, and the decode step's replays and
captures.  ``--trace`` writes a Chrome trace of the graphed decode window.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import (  # noqa: E402
    MOE_SERVE, NEMO_SERVE, card, paged_deployment, serving_deployment,
)
from repro_torch.core import graphs  # noqa: E402
from repro_torch.serving.engine import PagedEngine  # noqa: E402

WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 8, 8, 4
ROWS = 20  # host ops and kernels listed per window


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


def report(name: str, prof, wall_s: float) -> dict:
    """Kernels are the events on the device; an op's own row repeats the
    device time of the kernels it launched, so only kernels are summed."""
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    ops = [e for e in ka if e.device_type == DeviceType.CPU]
    device_us = sum(_device_us(e) for e in kernels)
    host_us = sum(e.self_cpu_time_total for e in ops)
    launches = sum(e.count for e in kernels)
    print(f"\n== {name}: wall {wall_s * 1e3:.3f} ms, device {device_us / 1e3:.3f} ms "
          f"(busy {device_us / (wall_s * 1e6):.3f}), {launches} kernels, host ops "
          f"{host_us / 1e3:.3f} ms")
    print(f"-- top {ROWS} host ops by self time: name, calls, self host ms, device ms below")
    for e in sorted(ops, key=lambda e: e.self_cpu_time_total, reverse=True)[:ROWS]:
        print(f"   {e.key[:60]:60s} {e.count:7d} {e.self_cpu_time_total / 1e3:9.3f} "
              f"{_device_us(e) / 1e3:9.3f}")
    print(f"-- top {ROWS} kernels by device time: name, launches, device ms")
    for e in sorted(kernels, key=_device_us, reverse=True)[:ROWS]:
        print(f"   {e.key[:70]:70s} {e.count:7d} {_device_us(e) / 1e3:9.3f}")
    return dict(wall_ms=wall_s * 1e3, device_ms=device_us / 1e3, kernels=launches,
                busy_share=device_us / (wall_s * 1e6), host_op_ms=host_us / 1e3)


def main() -> int:
    ap = argparse.ArgumentParser()
    cut = {spec["config"]: spec for spec in (*MOE_SERVE, NEMO_SERVE)}
    ap.add_argument("--deployment", default="granite_3_2b", choices=["granite_3_2b", *cut])
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the decode window")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.deployment in cut:
        cfg, model, pcfg, prompts = paged_deployment(dev, cut[args.deployment])
    else:
        cfg, model, pcfg, prompts = serving_deployment(dev)
    eng = PagedEngine(cfg, model, pcfg, device=dev)
    sids = [eng.admit(p, region=i % pcfg.n_regions) for i, p in enumerate(prompts)]
    for _ in range(WARMUP_STEPS):
        eng.decode(sids)
    print(card(), cfg.name)
    out = {"card": card()}
    for name, captured in (("eager", False), ("graphed", True), ("graphed again", True),
                           ("eager again", False)):
        step_ms = []
        with contextlib.nullcontext() if captured else graphs.disable_capture():
            for _ in range(TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.decode(sids)
                step_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"decode step {name}: {statistics.median(step_ms):.3f} ms "
              f"(median of {TIMED_STEPS}, profiler off)")
        out[f"decode_step_ms_median {name}"] = statistics.median(step_ms)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extra = eng.admit(prompts[0], region=0)  # a ninth sequence with the first prompt
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["admit"] = report(f"one admission (prefill of {len(prompts[0])} tokens + page writes)",
                          prof, wall)
    eng.release(extra)

    for name, captured in (("graphed", True), ("eager", False)):
        torch.cuda.synchronize()
        with contextlib.nullcontext() if captured else graphs.disable_capture(), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                eng.decode(sids)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[f"decode {name}"] = report(
            f"{PROFILED_STEPS} decode steps {name}, batch {len(sids)}", prof, wall)
        if args.trace and captured:
            Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(args.trace)
    prog = eng._decode_step
    out["graphs"] = dict(replays=prog.replays, captures=prog.captures, variants=len(prog))
    print(f"decode step graphs: {out['graphs']}")
    print(json.dumps({"profile_serving": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
