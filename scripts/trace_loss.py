#!/usr/bin/env python3
"""How many device records ``torch.profiler`` loses from one dry-run step.

    python3 scripts/trace_loss.py [--arch recurrentgemma_9b] [--shape prefill_32k] [--profiles 10]

Builds the dry-run cell (``launch/dryrun.py`` ``cut_cell`` and ``build``,
random weights from seed 0) on the current CUDA device, runs its step twice
(the eager first call and its capture, then one replay), then profiles
``--profiles`` replays one at a time, as the dry-run profiles a step.  A
replay launches the same kernels every time, so any difference between the
profiles' device events is the profiler's.  Prints for each profile its
device events and K5 launches, then each kernel name whose count falls short
of the most any profile saw.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline import trace as tr  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma_9b")
    ap.add_argument("--shape", default="prefill_32k")
    ap.add_argument("--profiles", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_loss: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    _build.load()
    cell, _, reduced = dryrun.cut_cell(get_config(args.arch), args.shape)
    step = dryrun.build(cell, dev, 0)[0]
    for _ in range(2):
        step()
        torch.cuda.synchronize(dev)
    counts = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.profiles):
            _, ms, trace = dryrun._profiled(step, dev, f"{tmp}/{i}.trace.json.gz")
            names = collections.Counter(e.get("name", "") for e in tr._events(trace)
                                        if e.get("cat") in tr.DEVICE_CATEGORIES)
            k5 = sum(c for n, c in names.items() if tr.kernel_class(n) == "K5 lru_scan")
            counts.append(names)
            print(f"profile {i}: {sum(names.values())} device events, K5 {k5}, window "
                  f"{ms:.1f} ms", flush=True)
    most = collections.Counter()
    for names in counts:
        most |= names
    print(f"{args.arch} {args.shape} ({reduced or 'not cut'}): most device events seen "
          f"{sum(most.values())} [{torch.cuda.get_device_name(dev)}]")
    for i, names in enumerate(counts):
        short = {n[:80]: names[n] - c for n, c in most.items() if names[n] != c}
        print(f"profile {i}: {sum(names.values()) - sum(most.values())} events, short "
              f"{json.dumps(short)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
