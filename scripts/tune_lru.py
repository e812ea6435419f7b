#!/usr/bin/env python3
"""K5's forward kernel (the RG-LRU scan) in variants, timed side by side.

    python3 scripts/tune_lru.py

Builds ``src/repro_torch/kernels/csrc/lru_scan.cu`` once as it stands and
once per textual variant below (compiled with ``nvcc`` and
``kernels/_build.py``'s flags into temporary libraries, in parallel), and
launches each build with the plan ``kernels/lru_scan.py`` ``plan_lru_scan``
chooses or with one of the plan variants below.  Every variant is held bit
for bit against the plain version (``ref.lru_scan_ref``) at each shape, then
timed at [1, 32768, 4096], [8, 2048, 4096] and [4, 2048, 4096] in float32
and at [1, 32768, 4096] in bfloat16 (the median of five CUDA-event timings
of 10 calls behind a sleep kernel, as ``chip_smoke.time_ms`` times), in 3
rounds with the order reversed every round.  Prints the card's name and
power limit, a line per shape and variant, and last one JSON object of the
medians.  Exits non-zero without a CUDA device.

Textual variants (of the source):

* ``no L2 hint``: the tensor-map loads without the evict-first policy;
* ``groups of 2``, ``groups of 16``: rows of a and b taken from shared
  memory into registers ahead of the chain 2 or 16 at a time (8 in the
  design).

Plan variants (of the design's build, where they differ from its plan):
``3 stages`` and ``6 stages`` (the design has 4 of about 32 KiB);
``deep ring`` (stages of half the rows, as many as 227 KB holds);
``32 channels`` (one warp a CTA, persistent: at batch 8 each CTA walks 8
tiles); ``half rows`` and ``double rows`` (time rows a stage; 3 stages of
the double); ``one-shot`` (one CTA of 32 channels a tile, stages of half
the rows, so that several CTAs share an SM).
"""

from __future__ import annotations

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
        for fn in ("leap_lru_scan", "leap_sm_count"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def variant_plan(base: lru_scan.LruPlan, kw: dict) -> lru_scan.LruPlan | None:
    """``base`` with the keywords applied: rows ``"half"`` or ``"double"`` of
    the base's, stages ``"fill"`` as many as 227 KB holds.  None where the
    variant is the base plan or cannot be had (rows past ``MAX_ROWS``)."""
    kw = dict(kw)
    if kw.get("rows") == "half":
        kw["rows"] = max(1, base.rows // 2)
    elif kw.get("rows") == "double":
        if 2 * base.rows > lru_scan.MAX_ROWS:
            return None
        kw["rows"] = 2 * base.rows
    if kw.get("stages") == "fill":
        rows = kw.get("rows", base.rows)
        slot = lru_scan.plan_lru_scan(base.b, base.t, base.r, base.itemsize, base.n_sm,
                                      rows=rows, channels=base.channels).slot_bytes
        kw["stages"] = min(lru_scan.MAX_STAGES,
                           (lru_scan.MAX_SMEM - lru_scan.SMEM_ALIGN) // (slot + 8))
    plan = lru_scan.plan_lru_scan(base.b, base.t, base.r, base.itemsize, base.n_sm, **kw)
    return None if plan == base else plan


def run(lib, a, x, h0, plan) -> torch.Tensor:
    out = torch.empty_like(a)
    err = lru_scan.launch(lib, a, x, h0, out, plan)
    if err:
        raise RuntimeError(f"leap_lru_scan failed with {plan.describe()}: CUDA error {err}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_lru: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(smoke.card())
    n_sm = lru_scan.sm_count(dev)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    medians = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(Path(tmp))
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
            names = list(runs)
            rounds = {n: [] for n in names}
            for rnd in range(3):
                for n in names if rnd % 2 == 0 else names[::-1]:
                    lib, plan = runs[n]
                    rounds[n].append(smoke.time_ms(lambda: run(lib, a, x, h0, plan), iters=10))
            bound, _ = smoke.bound_ms(3 * a.numel() * a.element_size() + h0.numel() * 4,
                                      2.0 * a.numel())
            medians[key] = {"bound_ms": bound}
            for n in names:
                ms = statistics.median(rounds[n])
                medians[key][n] = ms
                plan = runs[n][1].describe()
                print(f"{key} {n:18s} {ms:.4f} ms ({bound / ms:.0%} of the bound {bound:.4f}; "
                      f"rounds {', '.join(f'{v:.4f}' for v in rounds[n])}) ctas {plan['ctas']} "
                      f"channels {plan['channels_per_cta']} rows {plan['rows']} stages "
                      f"{plan['stages']} in flight/SM {plan['in_flight_per_sm']}")
            del a, x, h0, want
            torch.cuda.empty_cache()
    print(json.dumps({"lru_variants": medians, "card": smoke.card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
