#!/usr/bin/env python3
"""K5's kernels (the RG-LRU scan and its backward) in variants, timed side
by side.

    python3 scripts/tune_lru.py [--only fwd|bwd]

Builds ``src/repro_torch/kernels/csrc/lru_scan.cu`` once as it stands and
once per textual variant below (compiled with ``nvcc`` and
``kernels/_build.py``'s flags into temporary libraries, in parallel), and
launches each build with the plan that ``kernels/lru_scan.py``
``plan_lru_scan`` (the forward) or ``plan_lru_scan_bwd`` (the backward)
chooses, or with one of the plan variants below.  Every variant is held
bit for bit against the plain version (``ref.lru_scan_ref``,
``ref.lru_scan_bwd_ref``) at each shape before anything is timed, then
timed (the median of five CUDA-event timings of 10 calls behind a sleep
kernel, as ``chip_smoke.time_ms`` times), in 3 rounds with the order
reversed every round.  The forward at [1, 32768, 4096], [8, 2048, 4096]
and [4, 2048, 4096] in float32 and at [1, 32768, 4096] in bfloat16; the
backward at the shapes the main paths launch it at, [1, 1024, 2048] and
[1, 1024, 4096] (a tensor-parallel position and a 4 x 1 group of
``chip_smoke.py`` phase 40(b)), [4, 2048, 4096] (phases 28-29) and [8,
2048, 4096] (phase 26), in float32.  Prints the card's name and power
limit, a line per shape and variant, and last one JSON object of the
medians.  Exits non-zero without a CUDA device.

Textual variants (of the source; both kernels):

* ``no L2 hint``: the tensor-map loads without the evict-first policy;
* ``groups of 2``, ``groups of 16``: rows taken from shared memory into
  registers ahead of the chain 2 or 16 at a time (8 in the design).

Forward plan variants (of the design's build, where they differ from its
plan): ``3 stages`` and ``6 stages`` (the design has 4 of about 32 KiB);
``deep ring`` (stages of half the rows, as many as 227 KB holds); ``32
channels`` (one warp a CTA, persistent: at batch 8 each CTA walks 8
tiles); ``half rows`` and ``double rows`` (time rows a stage; 3 stages of
the double); ``one-shot`` (one CTA of 32 channels a tile, stages of half
the rows, so that several CTAs share an SM).

Backward plan variants: ``3 stages`` (the design has 4 of three 16 KiB
boxes); ``half rows``, ``quarter rows`` (with 4 stages); ``deep ring`` and
``deeper ring`` (half and quarter rows, as many stages as 227 KB holds);
``32 channels``, ``64 channels``, ``128 channels`` (persistent, with the
rows of their own default); ``one-shot`` (one CTA of 32 channels a tile,
quarter rows, so that several CTAs share an SM).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build, lru_scan, ref  # noqa: E402

SOURCE = (_build.CSRC / "lru_scan.cu").read_text()
HINTED = ('"cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes'
          '.L2::cache_hint"\n      " [%0], [%1, {%2, %3, %4}], [%5], %6;"')
UNHINTED = ('"cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"\n'
            '      " [%0], [%1, {%2, %3, %4}], [%5];"')
BUILDS = {
    "design": [],
    "no L2 hint": [(HINTED, UNHINTED)],
    "groups of 2": [("constexpr int kGroup = 8;", "constexpr int kGroup = 2;")],
    "groups of 16": [("constexpr int kGroup = 8;", "constexpr int kGroup = 16;")],
}
PLANS = {  # name -> plan_lru_scan keywords
    "3 stages": dict(stages=3),
    "6 stages": dict(stages=6),
    "deep ring": dict(rows="half", stages="fill"),
    "32 channels": dict(channels=32),
    "half rows": dict(rows="half"),
    "double rows": dict(rows="double", stages=3),
    "one-shot": dict(channels=32, rows="half", persistent=False),
}
SHAPES = [((1, 32768, 4096), torch.float32), ((8, 2048, 4096), torch.float32),
          ((4, 2048, 4096), torch.float32), ((1, 32768, 4096), torch.bfloat16)]
BWD_PLANS = {  # name -> plan_lru_scan_bwd keywords
    "3 stages": dict(stages=3),
    "half rows": dict(rows="half"),
    "quarter rows": dict(rows="quarter"),
    "deep ring": dict(rows="half", stages="fill"),
    "deeper ring": dict(rows="quarter", stages="fill"),
    "32 channels": dict(channels=32),
    "64 channels": dict(channels=64),
    "128 channels": dict(channels=128),
    "one-shot": dict(channels=32, rows="quarter", persistent=False),
}
BWD_SHAPES = [(1, 1024, 2048), (1, 1024, 4096), (4, 2048, 4096), (8, 2048, 4096)]


def build(tmp: Path) -> dict[str, ctypes.CDLL]:
    """Every textual variant's library, compiled in parallel."""
    nvcc, procs = _build.find_nvcc(), {}
    for name, edits in BUILDS.items():
        text = SOURCE
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in lru_scan.cu")
            text = text.replace(old, new)
        cu = tmp / f"{len(procs)}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", str(cu), "-o", str(cu.with_suffix(".so"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in ("leap_lru_scan", "leap_lru_scan_bwd", "leap_sm_count"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def variant_plan(base: lru_scan.LruPlan, kw: dict, plan_fn=lru_scan.plan_lru_scan):
    """``base`` with the keywords applied through ``plan_fn``: rows
    ``"half"``, ``"quarter"`` or ``"double"`` of the base's, stages
    ``"fill"`` as many as 227 KB holds; a named channel count with rows of
    its own default.  None where the variant is the base plan or cannot be
    had (rows past ``MAX_ROWS``, a ring past 227 KB)."""
    kw = dict(kw)
    scale = {"half": 0.5, "quarter": 0.25, "double": 2.0}.get(kw.get("rows"))
    if scale is not None:
        kw["rows"] = max(1, int(base.rows * scale))
    if kw.get("stages") == "fill":
        rows = kw.get("rows", base.rows)
        slot = plan_fn(base.b, base.t, base.r, base.itemsize, base.n_sm, rows=rows,
                       channels=kw.get("channels", base.channels)).slot_bytes
        kw["stages"] = min(lru_scan.MAX_STAGES,
                           (lru_scan.MAX_SMEM - lru_scan.SMEM_ALIGN) // (slot + 8))
    try:
        plan = plan_fn(base.b, base.t, base.r, base.itemsize, base.n_sm, **kw)
    except ValueError:
        return None
    return None if plan == base else plan


def run(lib, a, x, h0, plan) -> torch.Tensor:
    out = torch.empty_like(a)
    err = lru_scan.launch(lib, a, x, h0, out, plan)
    if err:
        raise RuntimeError(f"leap_lru_scan failed with {plan.describe()}: CUDA error {err}")
    return out


def run_bwd(lib, g, a, h, h0, plan) -> tuple[torch.Tensor, ...]:
    da, db, dh0 = torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)
    err = lru_scan.launch_bwd(lib, g, a, h, h0, da, db, dh0, plan)
    if err:
        raise RuntimeError(f"leap_lru_scan_bwd failed with {plan.describe()}: CUDA error {err}")
    return da, db, dh0


def in_turns(key: str, runs: dict, call, bound: float) -> dict:
    """Times ``call(lib, plan)`` for every run in 3 rounds, the order
    reversed every round; prints a line a run; the medians."""
    names = list(runs)
    rounds = {n: [] for n in names}
    for rnd in range(3):
        for n in names if rnd % 2 == 0 else names[::-1]:
            lib, plan = runs[n]
            rounds[n].append(smoke.time_ms(lambda: call(lib, plan), iters=10))
    out = {"bound_ms": bound}
    for n in names:
        ms = out[n] = statistics.median(rounds[n])
        plan = runs[n][1].describe()
        print(f"{key} {n:18s} {ms:.4f} ms ({bound / ms:.0%} of the bound {bound:.4f}; "
              f"rounds {', '.join(f'{v:.4f}' for v in rounds[n])}) ctas {plan['ctas']} "
              f"channels {plan['channels_per_cta']} rows {plan['rows']} stages "
              f"{plan['stages']} in flight/SM {plan['in_flight_per_sm']}")
    return out


def tune_forward(libs, dev, n_sm) -> dict:
    medians = {}
    for (b, t, r), dtype in SHAPES:
        a, x, h0 = smoke.lru_inputs(dev, b, t, r, smoke.SEED)
        a, x = a.to(dtype), x.to(dtype)
        want = ref.lru_scan_ref(a, x, h0)
        base = lru_scan.plan_lru_scan(b, t, r, a.element_size(), n_sm)
        runs = {name: (lib, base) for name, lib in libs.items()}
        for name, kw in PLANS.items():
            plan = variant_plan(base, kw)
            if plan is not None:
                runs[name] = (libs["design"], plan)
        key = f"[{b}, {t}, {r}] {str(dtype).removeprefix('torch.')}"
        for name, (lib, plan) in runs.items():
            smoke.check(torch.equal(run(lib, a, x, h0, plan), want),
                        f"{name} at {key} == plain version, bit for bit")
        bound, _ = smoke.lru_bound(a, h0)
        medians[key] = in_turns(key, runs, lambda lib, plan: run(lib, a, x, h0, plan), bound)
        del a, x, h0, want
        torch.cuda.empty_cache()
    return medians


def tune_backward(libs, dev, n_sm) -> dict:
    medians = {}
    for b, t, r in BWD_SHAPES:
        a, x, h0 = smoke.lru_inputs(dev, b, t, r, smoke.SEED + b)
        g = torch.randn(a.shape, generator=torch.Generator(device=dev).manual_seed(smoke.SEED),
                        device=dev)
        h = lru_scan.lru_scan(a, x, h0)
        want = ref.lru_scan_bwd_ref(g, a, h, h0)
        base = lru_scan.plan_lru_scan_bwd(b, t, r, 4, n_sm)
        runs = {name: (lib, base) for name, lib in libs.items()}
        for name, kw in BWD_PLANS.items():
            plan = variant_plan(base, kw, lru_scan.plan_lru_scan_bwd)
            if plan is not None:
                runs[name] = (libs["design"], plan)
        key = f"bwd [{b}, {t}, {r}] float32"
        for name, (lib, plan) in runs.items():
            got, again = run_bwd(lib, g, a, h, h0, plan), run_bwd(lib, g, a, h, h0, plan)
            for what, k, z, w in zip(("da", "db", "dh0"), got, again, want):
                smoke.check(torch.equal(k, w) and torch.equal(k, z),
                            f"{name} {what} at {key} == plain version and run to run, "
                            "bit for bit")
        bound, _ = smoke.lru_bwd_bound(a, h0)
        medians[key] = in_turns(key, runs, lambda lib, plan: run_bwd(lib, g, a, h, h0, plan),
                                bound)
        del a, x, h0, g, h, want
        torch.cuda.empty_cache()
    return medians


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("fwd", "bwd"), help="time one kernel's variants only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_lru: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(smoke.card())
    n_sm = lru_scan.sm_count(dev)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(Path(tmp))
        if args.only != "bwd":
            out["lru_variants"] = tune_forward(libs, dev, n_sm)
        if args.only != "fwd":
            out["lru_bwd_variants"] = tune_backward(libs, dev, n_sm)
    print(json.dumps({**out, "card": smoke.card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
