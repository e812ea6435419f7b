#!/usr/bin/env python3
"""K6a's bulk-copy pipeline in variants, timed against ``index_select``.

    python3 scripts/tune_gather.py

Builds ``src/repro_torch/kernels/csrc/leap_copy.cu`` once as it stands and
once per variant below (each a textual change of the source, compiled with
``nvcc`` and ``kernels/_build.py``'s flags into a temporary library), holds
every build bit for bit against ``pool[idx]`` on ``chip_smoke.py`` phase
12's shard, then times each build's ``leap_gather_blocks`` and
``torch.index_select`` at 256, 512 and 1,024 lanes of 64 KiB, as phase 12 does
(the median of five CUDA-event timings of 50 calls behind a sleep kernel,
8 disjoint id sets in turn), in 5 rounds with the order reversed every
round.  Prints the card's name and power limit, a line per build and lane
count, and last one JSON object of the medians.  Exits non-zero without a
CUDA device.

Variants:

* ``lane copy``: every gather takes ``move_lanes_kernel`` (the kernel the
  gather ran before it had its own);
* ``no L2 hint``: loads without the evict-first cache policy;
* ``4 stages``, ``6 x 32 KiB``: smaller rings, and larger tiles;
* ``4 KiB tiles``: 48 stages of 4 KiB.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

SOURCE = (_build.CSRC / "leap_copy.cu").read_text()
HINTED = ('"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"\n'
          '      " [%0], [%1], %2, [%3], %4;"')
UNHINTED = ('"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"\n'
            '      " [%0], [%1], %2, [%3];"')


def ring(stages: int, tile: int, reading: int) -> list[tuple[str, str]]:
    return [("constexpr int kStages = 12;", f"constexpr int kStages = {stages};"),
            ("constexpr int kMaxTile = 16384;", f"constexpr int kMaxTile = {tile};"),
            ("constexpr int kStoresReading = 2;", f"constexpr int kStoresReading = {reading};")]


VARIANTS = {
    "design": [],
    "lane copy": [("  if (aligned16(out, pool, slot_bytes))\n", "  if (false)\n")],
    "no L2 hint": [(HINTED, UNHINTED)],
    "4 stages": ring(4, 16384, 1),
    "6 x 32 KiB": ring(6, 32768, 1),
    "4 KiB tiles": ring(48, 4096, 4),
}


def build(tmp: Path) -> dict[str, ctypes.CDLL]:
    """Every variant's library, compiled in parallel."""
    nvcc, procs = _build.find_nvcc(), {}
    for name, edits in VARIANTS.items():
        text = SOURCE
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in leap_copy.cu")
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
        lib.leap_gather_blocks.argtypes = _build._SIGNATURES["leap_gather_blocks"]
        lib.leap_gather_blocks.restype = ctypes.c_int
        libs[name] = lib
    return libs


def gather(lib, shard: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    out = torch.empty((idx.shape[0],) + tuple(shard.shape[1:]), dtype=shard.dtype,
                      device=shard.device)
    err = lib.leap_gather_blocks(out.data_ptr(), shard.data_ptr(), idx.data_ptr(), idx.shape[0],
                                 shard[0].numel() * shard.element_size(),
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"leap_gather_blocks failed: CUDA error {err}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_gather: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(smoke.card())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(Path(tmp))
        g = torch.Generator(device=dev).manual_seed(smoke.SEED)
        host = torch.Generator().manual_seed(smoke.SEED)
        pool = torch.randn((2, smoke.PP_SLOTS) + smoke.BLOCK, generator=g, device=dev)
        shard = pool[1:2].view((smoke.PP_SLOTS,) + smoke.BLOCK)
        slot_bytes = shard[0].numel() * shard.element_size()
        medians = {}
        for k in (256, 512, 1024):
            sets = torch.randperm(smoke.PP_SLOTS, generator=host)[: 8 * k].view(8, k).to(dev)
            for name, lib in libs.items():
                smoke.check(torch.equal(gather(lib, shard, sets[0]), shard[sets[0]]),
                            f"{name} at {k} lanes == pool[idx], bit for bit")
            turn = itertools.count()
            fns = {name: (lambda lib=lib: gather(lib, shard, sets[next(turn) % 8]))
                   for name, lib in libs.items()}
            fns["index_select"] = lambda: torch.index_select(shard, 0, sets[next(turn) % 8])
            names = list(fns)
            rounds = {n: [] for n in names}
            for r in range(5):
                for n in names if r % 2 == 0 else names[::-1]:
                    rounds[n].append(smoke.time_ms(fns[n]))
            b, _ = smoke.bound_ms(2 * k * slot_bytes + 8 * k)
            medians[k] = {n: statistics.median(rounds[n]) for n in names}
            for n in names:
                print(f"{k} lanes  {n:12s} {medians[k][n]:.4f} ms (bound {b:.4f}; rounds "
                      f"{', '.join(f'{x:.4f}' for x in rounds[n])})")
    print(json.dumps({"gather_variants": medians, "card": smoke.card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
