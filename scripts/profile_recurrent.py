#!/usr/bin/env python3
"""Where a full-width prefill and its decode steps on the contiguous cache
(``lm.prefill`` and ``lm.decode_step``) spend their time.

    python3 scripts/profile_recurrent.py [--deployment recurrentgemma_9b] [--trace trace.json]

Builds a run of ``chip_smoke.py`` (random bf16 weights from seed 0):
recurrentgemma_9b at full width and depth (phase 9, the default; 8 prompts
of 2048 tokens), xlstm_125m in full (phase 25), gemma2_27b at full width
and depth (phase 32, 4 prompts of 4,096 tokens) or llava_next_34b and
musicgen_large (phase 33, 8 × 512 seeded embeddings), on the current CUDA
device, warms up with one prefill and 4 decode steps,
times 8 decode steps without the profiler, then profiles one prefill and 4
decode steps with ``torch.profiler``.  Prints for each window what
``profile_serving.py`` prints: wall time, device time summed over kernels,
the device's busy share, the kernel count, the 20 host ops with the most
host time and the 20 kernels with the most device time.  ``--trace`` writes
a Chrome trace of the decode window.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import (  # noqa: E402
    GEMMA_SERVE,
    STUB_SERVE,
    contiguous_deployment,
    recurrent_deployment,
    xlstm_deployment,
)
from profile_serving import report  # noqa: E402
from repro_torch.models import lm  # noqa: E402

WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 4, 8, 4


def decode(model, cfg, cache, tok, pos: int, steps: int, feed=None):
    """``steps`` greedy steps; a stub-frontend arch takes ``feed`` ([B, 1, D])
    as every step's input instead of the argmax token."""
    for i in range(steps):
        logits, cache = lm.decode_step(model, cache, tok if feed is None else feed, pos + i, cfg)
        tok = logits.argmax(-1)[:, None]
        tok.cpu()  # the step's one device-to-host copy, as in chip_smoke.py
    return cache, tok


def main() -> int:
    ap = argparse.ArgumentParser()
    contiguous = {spec["config"]: spec for spec in (GEMMA_SERVE, *STUB_SERVE)}
    ap.add_argument("--deployment", default="recurrentgemma_9b",
                    choices=["recurrentgemma_9b", "xlstm_125m", *contiguous])
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the decode window")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_recurrent: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    feed = None
    if args.deployment in contiguous:
        cfg, model, prompts, feeds = contiguous_deployment(dev, contiguous[args.deployment])
        feed = None if feeds is None else feeds[0]
    else:
        deployment = xlstm_deployment if args.deployment == "xlstm_125m" else recurrent_deployment
        cfg, model, prompts = deployment(dev)
    s = prompts.shape[1]
    max_len = s + WARMUP_STEPS + TIMED_STEPS + PROFILED_STEPS
    logits, cache = lm.prefill(model, prompts, cfg, max_len)
    cache, tok = decode(model, cfg, cache, logits.argmax(-1)[:, None], s, WARMUP_STEPS, feed)
    step_ms = []
    for i in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, tok = decode(model, cfg, cache, tok, s + WARMUP_STEPS + i, 1, feed)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    print(torch.cuda.get_device_name(0), cfg.name,
          f"decode step {statistics.median(step_ms):.3f} ms "
          f"(median of {TIMED_STEPS}, profiler off)")
    out = {"decode_step_ms_median": statistics.median(step_ms)}

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm.prefill(model, prompts, cfg, max_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["prefill"] = report(f"one prefill of {tuple(prompts.shape)} tokens", prof, wall)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode(model, cfg, cache, tok, s + WARMUP_STEPS + TIMED_STEPS, PROFILED_STEPS, feed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["decode"] = report(f"{PROFILED_STEPS} decode steps, batch {prompts.shape[0]}", prof, wall)
    out["config"] = cfg.name
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps({"profile_recurrent": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
