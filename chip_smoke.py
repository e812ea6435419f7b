#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises, and no result line is
printed):

1. Device and build: the card's name and power limit, then the port's CUDA
   kernels built from ``src/repro_torch/kernels/csrc`` with ``nvcc``.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the drains give it, with timings (median of CUDA-event times) of the
   kernel, the plain version and a PyTorch library call for the same
   function (timed here only; the port never calls it).
3. A small-page drain through ``LeapSession``: 131,072 blocks of 64 KiB
   (8 GiB) from region 0 to region 1 under 64 random writes and 64 reads per
   tick, with tiering on; every write is mirrored into a device-side shadow.
   No tick may make the host wait for the card (sync debug mode raises).
4. The same drain on a two-tier pool (2 MiB huge blocks).
5. A small drain run twice, on the card (kernels) and on the CPU (plain
   versions), which must agree bit for bit (heat within 1e-6); the CPU
   path is the one the test suite holds against the JAX package.
6. The paged-decode kernel against its plain version on the card, on the
   layer-20 strided view of a 40-layer bf16 pool at granite_3_2b's decode
   shapes (bf16 within rtol 2e-2 and atol 2e-3, an f32 case with softcap 20
   within 2e-5, bit-identical run to run, and unchanged when the pad table
   entries point out of range), timed beside a gather plus
   ``scaled_dot_product_attention`` (timed here only; the port never calls it).
7. Serving at full width: granite_3_2b (40 layers, bf16, random weights from
   a seeded generator) through ``PagedEngine``: 8 prompts of 512 tokens,
   then 64 decode steps, once undisturbed and once while two sequences
   leap-migrate to the other region from step 1 on (``tick()`` before every
   step), their append frontier pages among the pages in flight.  Tokens
   and the last step's logits must be bit-identical between the two runs.
8. The LRU-scan kernel against its plain version on the card at the
   recurrent prefill's shapes ([8, 2048, 4096] f32: bit-identical, and
   bit-identical run to run), a bf16 case within 2e-2 and an odd shape
   (T = 17, R = 96), timed beside its bound and the plain version (no single
   PyTorch call computes a linear recurrence, so there is no library time).
9. recurrentgemma_9b at full width (38 layers, bf16, random weights from a
   seeded generator) through ``lm.prefill`` and ``lm.decode_step``: 8
   prompts of 2048 tokens, then 64 greedy decode steps, twice.  Finite
   logits, exactly one LRU-scan launch per ``rec`` layer in each prefill
   and none in decode, and the same tokens in both runs.
10. The reduced two-layer granite (f32, TF32 off) served on the card
   (kernels) and on the CPU (plain versions) under a live rebalance with
   blocking harvest: equal tokens, pools and logits within 1e-5.
11. The reduced recurrentgemma (f32, TF32 off, ``lru_width`` 128): prefill
   and 4 decode steps on the card (kernels) and on the CPU (plain
   versions): equal tokens, logits and every layer's cache within 1e-5.
12. The gather and scatter kernels (the ppermute backend's pack and unpack)
   against their plain versions on the card, bit for bit: on region 1's
   shard of a 2-region pool of 40,960 slots of 64 KiB f32 (a view at a
   storage offset) at 256 and 1,024 lanes, on the odd shape (5, 4, 64) in
   f32, bf16 and int32, and a scatter with duplicate ids (the last lane must
   win in each of 20 runs); timed beside their bound, their plain versions
   and ``index_select`` / ``index_copy_`` (timed here only).
13. A ppermute drain: 4 regions (a four-socket server) on ``make_region_mesh(4)``
   over the one card, 131,072 blocks of 64 KiB (8 GiB) in 40,960 slots a
   region (a 10 GiB pool), 32,768 starting in each region and all leaping to
   the next region at once, through the batched generation (one
   ``fused_copy_ppermute`` per region pair a tick), under 64 writes and 64
   reads a tick; the checks of phase 3, and gather and scatter launches equal.
14. A small ppermute drain on the card and on the CPU: bit for bit as in
   phase 5.
15. Megastep against batched on the card, same seed, blocking harvest: on a
   small-block pool with tiering, bit-identical pools and tables; on a
   two-tier pool, every block reads back, and the batched drain launches
   the run copy.  The two batched drains launch K1, K2 and K3.

Output: human-readable lines, then the ``{"kernels": [...]}`` line, the
``{"drains": ...}`` line, the ``{"serving": ...}`` line, the
``{"recurrent": ...}`` line, and last ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the rest of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import (  # noqa: E402
    LeapConfig,
    MigrationDriver,
    PoolConfig,
    init_state,
    leap_write,
    make_region_mesh,
    state_sharding,
)
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build,
    heat_scan,
    leap_copy,
    lru_scan,
    ops,
    paged_attn,
    ref,
)
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import PagedConfig, PagedEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
HEAT_TOL = dict(rtol=1e-6, atol=1e-6)  # sums over duplicate ids may associate differently
N_BLOCKS = 131072
SLOTS = 131104  # a little headroom over N_BLOCKS; 4097 runs of 32
BLOCK = (1, 16384)  # 64 KiB fp32 blocks
HUGE = 32  # 2 MiB huge blocks
IO_PER_TICK = 64  # writes and reads per tick
SEED = 0
# paged decode at granite_3_2b's widths: 8 sequences, 32 query heads over
# 8 kv heads of 64, pages of 16 tokens, up to 64 pages a sequence
PAGED = dict(b=8, h=32, kvh=8, hd=64, blk=16, maxb=64, layers=40, layer=20, slots=1024)
# bf16: rtol covers the rounding of large m and l; atol sits about 8 times
# over the error measured on an H100 (2.44e-4) and well under |out| (~0.05)
PAGED_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-3)}
SERVE = dict(prompts=8, prompt_len=512, steps=64)
# recurrentgemma_9b: 8 prompts of 2048 tokens (its attention window), 64 steps
RECUR = dict(prompts=8, prompt_len=2048, steps=64)
LRU_BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # the JAX package's (tests/test_kernels_lru_scan.py)
# the ppermute drain: a four-socket server, 40,960 slots of 64 KiB a region
PP_REGIONS, PP_SLOTS = 4, 40960
PP_CFG = dict(backend="ppermute", axis_name="data", initial_area_blocks=256,
              budget_blocks_per_tick=1024, tiering=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters: int = 50, repeats: int = 5) -> float:
    """Device time of one call: the median over ``repeats`` of CUDA-event time
    around ``iters`` back-to-back calls, divided by ``iters``.

    A sleep kernel holds the stream while the host queues the calls, so the
    calls run back to back and the host's launch overhead (tens of
    microseconds of Python per call) stays out of the device time.
    """
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):  # warm-up, and how long the host takes to queue
        fn()
    queue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    per_call = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4 * queue_s * 2e9))  # ~4x the queueing time, in cycles
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def bound_ms(n_bytes: float, n_flops: float = 0.0) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def launch_counts() -> dict[str, int]:
    return {
        "copy_blocks": leap_copy.copy_blocks.launches,
        "copy_runs": leap_copy.copy_runs.launches,
        "heat_scan": heat_scan.heat_scan.launches,
        "paged_decode": paged_attn.paged_decode.launches,
        "lru_scan": lru_scan.lru_scan.launches,
        "gather_blocks": leap_copy.gather_blocks.launches,
        "scatter_blocks": leap_copy.scatter_blocks.launches,
    }


@contextlib.contextmanager
def no_host_sync(dev: torch.device):
    """Inside, any PyTorch call that makes the host wait for the card raises
    (PyTorch's sync debug mode, which sees most but not all such calls)."""
    if dev.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def distinct_ids(n: int, k: int, gen: torch.Generator) -> torch.Tensor:
    """``k`` distinct uniformly random ids below ``n`` (redraws on a repeat,
    which at k = 64 of n = 131072 happens about once in 60 draws)."""
    while True:
        ids = torch.randint(0, n, (k,), generator=gen)
        if len(torch.unique(ids)) == k:
            return ids


def release() -> None:
    """Free the card's memory that earlier phases left: a driver sits in
    reference cycles, which only the garbage collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def reset_launch_counts() -> None:
    leap_copy.copy_blocks.launches = 0
    leap_copy.copy_runs.launches = 0
    heat_scan.heat_scan.launches = 0
    paged_attn.paged_decode.launches = 0
    lru_scan.lru_scan.launches = 0
    leap_copy.gather_blocks.launches = 0
    leap_copy.scatter_blocks.launches = 0


# -- phase 2: kernels against their plain versions ----------------------------


def kernel_checks(dev) -> list[dict]:
    g = torch.Generator(device=dev).manual_seed(SEED)
    host = torch.Generator().manual_seed(SEED)
    pool = torch.randn((2 * SLOTS,) + BLOCK, generator=g, device=dev)  # 16 GiB flat pool
    slot_bytes = pool[0].numel() * pool.element_size()
    rows = []

    def copy_row(name, src, dst, run, kernel, plain, library, replaces):
        want = plain(pool.clone())
        got = kernel(pool)  # in place; copying the same lanes again is idempotent
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{name} kernel == plain version, bit for bit")
        lanes = src.shape[0]
        ends = torch.arange(run, device=dev)
        touched = (dst[:, None] + ends[None, :]).view(-1)
        err = float((got[touched] - want[touched]).abs().max())
        del want
        b, by = bound_ms(2 * lanes * run * slot_bytes + 2 * lanes * 8)
        row = dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/leap_copy.cu",
            replaces=replaces, launches=0, max_abs_err=err,
            ms=time_ms(lambda: kernel(pool)), plain_ms=time_ms(lambda: plain(pool)),
            bound_ms=b, bound_by=by, library_ms=time_ms(lambda: library(pool)),
            shape=f"pool [{2 * SLOTS}, 1, 16384] fp32, {lanes} lanes x {run * slot_bytes} B",
        )
        print(f"{name}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, library "
              f"{row['library_ms']:.4f}, bound {b:.4f}), bit-exact")
        return row

    perm = torch.randperm(SLOTS, generator=host)
    src, dst = perm[:1024].to(dev), (SLOTS + perm[1024:2048]).to(dev)
    rows.append(copy_row(
        "copy_blocks", src, dst, 1,
        lambda p: leap_copy.copy_blocks(p, src, dst),
        lambda p: ref.copy_blocks_ref(p, src, dst),
        lambda p: p.index_copy_(0, dst, p.index_select(0, src)),
        "src/repro/kernels/leap_copy.py:105",
    ))
    runs = torch.randperm(SLOTS // HUGE, generator=host)
    rsrc, rdst = (runs[:32] * HUGE).to(dev), (SLOTS + runs[32:64] * HUGE).to(dev)
    grouped = lambda p: p.view(-1, HUGE, *BLOCK)  # noqa: E731
    rows.append(copy_row(
        "copy_runs", rsrc, rdst, HUGE,
        lambda p: leap_copy.copy_runs(p, rsrc, rdst, HUGE),
        lambda p: ref.copy_runs_ref(p, rsrc, rdst, HUGE),
        lambda p: grouped(p).index_copy_(0, rdst // HUGE,
                                          grouped(p).index_select(0, rsrc // HUGE)),
        "src/repro/kernels/leap_copy.py:139",
    ))
    del pool
    torch.cuda.empty_cache()

    L = heat_scan.padded_heat_len(N_BLOCKS)
    heat0 = torch.rand(L, generator=g, device=dev) * 10
    per_k = {}
    for k in (2 * IO_PER_TICK, 1024):
        ids = torch.randint(0, N_BLOCKS // 64, (k,), generator=g, device=dev)  # duplicates
        ids[::9] = L + torch.arange(len(ids[::9]), device=dev)  # inert lanes
        w = torch.rand(k, generator=g, device=dev) + 0.5
        want = ref.heat_scan_ref(heat0.clone(), ids, w, 0.9)
        got = heat_scan.heat_scan(heat0.clone(), ids, w, 0.9)
        again = heat_scan.heat_scan(heat0.clone(), ids, w, 0.9)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **HEAT_TOL)
        check(torch.equal(got, again), "heat_scan is bit-identical run to run")
        h = heat0.clone()
        padded = torch.zeros(L + 1, device=dev)
        clamped = ids.clamp(max=L)
        b, by = bound_ms(2 * L * 4 + k * 12, 2 * L + k)
        per_k[k] = dict(
            max_abs_err=float((got - want).abs().max()),
            ms=time_ms(lambda: heat_scan.heat_scan(h, ids, w, 0.9)),
            plain_ms=time_ms(lambda: ref.heat_scan_ref(h, ids, w, 0.9)),
            library_ms=time_ms(lambda: padded.mul_(0.9).index_add_(0, clamped, w)),
            bound_ms=b, bound_by=by,
        )
        r = per_k[k]
        print(f"heat_scan K={k}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {b:.6f}), max err {r['max_abs_err']:.3g}")
    main = per_k[2 * IO_PER_TICK]
    rows.append(dict(
        name="heat_scan", route="cuda", source="src/repro_torch/kernels/csrc/heat_scan.cu",
        replaces="src/repro/kernels/heat_scan.py:58", launches=0, **main,
        shape=f"heat [{L}] f32, K={2 * IO_PER_TICK}", at_k1024=per_k[1024],
    ))
    return rows


# -- phase 12: the gather and scatter kernels against their plain versions -----


def gather_scatter_checks(dev) -> list[dict]:
    """K6a and K6b on region 1's shard of a 2-region pool, the shape the
    ppermute drain hands them (a flat view at a storage offset)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    host = torch.Generator().manual_seed(SEED)
    pool = torch.randn((2, PP_SLOTS) + BLOCK, generator=g, device=dev)  # 5 GiB
    shard = pool[1:2].view((PP_SLOTS,) + BLOCK)
    check(shard.storage_offset() > 0, "the kernels see a region shard at an offset")
    slot_bytes = shard[0].numel() * shard.element_size()
    per_k = {"gather_blocks": {}, "scatter_blocks": {}}
    for k in (256, 1024):  # one drain area; a tick's budget
        # 8 disjoint id sets (and block sets) in turn, so that what one call
        # moves is out of the 50 MB L2 by the time the same set comes back
        sets = torch.randperm(PP_SLOTS, generator=host)[: 8 * k].view(8, k).to(dev)
        block_sets = torch.randn((8, k) + BLOCK, generator=g, device=dev)
        idx, blocks = sets[0], block_sets[0]
        want = ref.gather_blocks_ref(shard, idx)
        got = leap_copy.gather_blocks(shard, idx)
        want_pool = ref.scatter_blocks_ref(shard.clone(), idx, blocks)
        leap_copy.scatter_blocks(shard, idx, blocks)  # in place; scattering again is idempotent
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"gather_blocks at {k} lanes == plain version, bit for bit")
        check(torch.equal(shard, want_pool), f"scatter_blocks at {k} lanes == plain version")
        del want_pool
        # each lane read once and written once, and the ids read once
        b, by = bound_ms(2 * k * slot_bytes + k * 8)
        turn = itertools.cycle(range(8))
        cases = {
            "gather_blocks": (lambda i: leap_copy.gather_blocks(shard, sets[i]),
                              lambda i: ref.gather_blocks_ref(shard, sets[i]),
                              lambda i: torch.index_select(shard, 0, sets[i]),
                              float((got - want).abs().max())),
            "scatter_blocks": (lambda i: leap_copy.scatter_blocks(shard, sets[i], block_sets[i]),
                               lambda i: ref.scatter_blocks_ref(shard, sets[i], block_sets[i]),
                               lambda i: shard.index_copy_(0, sets[i], block_sets[i]),
                               float((shard[idx] - blocks).abs().max())),
        }
        for name, fns in cases.items():
            kernel, plain, library = (lambda f=f: f(next(turn)) for f in fns[:3])
            per_k[name][k] = dict(max_abs_err=fns[3], ms=time_ms(kernel),
                                  plain_ms=time_ms(plain), library_ms=time_ms(library),
                                  bound_ms=b, bound_by=by)
            r = per_k[name][k]
            print(f"{name} {k} lanes: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
                  f"{r['library_ms']:.4f}, bound {b:.4f}), bit-exact")
        del got, want, blocks, block_sets

    # duplicate ids: about 16 lanes an id; the last lane must win every run
    idx = torch.randint(0, 64, (1024,), generator=host).to(dev)
    blocks = torch.randn((1024,) + BLOCK, generator=g, device=dev)
    want = ref.scatter_blocks_ref(shard[:64].clone(), idx, blocks)
    lanes = {int(i): lane for lane, i in enumerate(idx.tolist())}  # the last lane of each id
    check(all(torch.equal(want[i], blocks[lane]) for i, lane in lanes.items()),
          "the plain scatter keeps the last duplicate")
    for run in range(20):
        leap_copy.scatter_blocks(shard[:64], idx, blocks)
        check(torch.equal(shard[:64], want), f"scatter_blocks: the last duplicate wins (run {run})")
    del pool, shard, blocks, want
    torch.cuda.empty_cache()

    # the JAX sweep's odd shape, in each of its dtypes (byte path: 256-byte slots)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        small = torch.randint(-100, 100, (5, 4, 64), generator=host).to(dtype).to(dev)
        idx = torch.tensor([4, 0, 4, 2], device=dev)
        blocks = torch.randint(-100, 100, (4, 4, 64), generator=host).to(dtype).to(dev)
        check(torch.equal(leap_copy.gather_blocks(small, idx), ref.gather_blocks_ref(small, idx)),
              f"gather_blocks (5, 4, 64) {dtype} == plain version")
        want = ref.scatter_blocks_ref(small.clone(), idx, blocks)
        check(torch.equal(leap_copy.scatter_blocks(small, idx, blocks), want),
              f"scatter_blocks (5, 4, 64) {dtype} == plain version")
    print("gather_blocks and scatter_blocks: bit-exact on (5, 4, 64) in f32, bf16 and int32; "
          "the last of duplicate ids wins in 20 runs")

    rows = []
    for name, line in (("gather_blocks", 40), ("scatter_blocks", 68)):
        main = per_k[name][1024]
        rows.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/leap_copy.cu",
            replaces=f"src/repro/kernels/leap_copy.py:{line}", launches=0, **main,
            shape=f"region 1 of a [2, {PP_SLOTS}, 1, 16384] fp32 pool, 1024 lanes x "
                  f"{slot_bytes} B",
            at_256_lanes=per_k[name][256],
        ))
    return rows


# -- phases 3-5: drains through LeapSession -----------------------------------


def start_regions(n_blocks: int, n_regions: int) -> np.ndarray:
    """Where each block starts: all in region 0 on two regions, else evenly
    spread (block b in region b * n_regions // n_blocks)."""
    if n_regions == 2:
        return np.zeros(n_blocks, np.int32)
    return (np.arange(n_blocks) * n_regions // n_blocks).astype(np.int32)


def drain(dev, n_blocks: int, slots: int, block, huge_factor: int, seed: int,
          io_per_tick: int = IO_PER_TICK, cfg_kw=None, blocking: bool = False,
          values_on=None, n_regions: int = 2, mesh=None, window=None):
    """Leap every block from its region r to region (r + 1) % n_regions under
    concurrent writes and reads; return the driver, the shadow of what was
    written, the handles and the host seconds of the drain: all of it, inside
    ``session.tick()``, and in the application's writes and reads.  With two
    regions every block starts in region 0; with more, they start spread
    evenly, and each region's blocks are one request.  Writes and reads draw
    their ids from a seeded CPU generator and their values from a seeded
    generator on ``values_on`` (default ``dev``; the CPU where two devices
    must see the same values).  ``mesh`` places the state for the ppermute
    backend; ``window``, a context manager, encloses the timed drain (e.g. a
    profiler)."""
    pc = PoolConfig(n_regions, slots, block, torch.float32, huge_factor=huge_factor,
                    region_axis=mesh.axis_name if mesh else None)
    place = start_regions(n_blocks, n_regions)
    state = init_state(pc, n_blocks, place, device=dev)
    if mesh is not None:
        state = state.to(state_sharding(pc, mesh))
    values_on = torch.device(values_on or dev)
    g = torch.Generator(device=values_on).manual_seed(seed)
    ids_gen = torch.Generator().manual_seed(seed)

    def randn(k: int) -> torch.Tensor:
        return torch.randn((k,) + tuple(block), generator=g, device=values_on).to(dev)

    shadow = torch.empty((n_blocks,) + tuple(block), device=dev)
    step = 16384
    for lo in range(0, n_blocks, step):
        ids = np.arange(lo, min(lo + step, n_blocks))
        shadow[lo : lo + len(ids)] = randn(len(ids))
        leap_write(state, ids, shadow[lo : lo + len(ids)])
    cfg = LeapConfig(**(cfg_kw or dict(initial_area_blocks=256, budget_blocks_per_tick=1024,
                                       tiering=True)))
    drv = MigrationDriver(state, pc, cfg, mesh=mesh)
    if huge_factor > 1:
        groups = n_blocks // huge_factor
        check(drv.adopt_huge(np.arange(groups)) == groups, "adopt_huge adopts every group")
    session = drv.default_session()
    stale_read = torch.zeros((), dtype=torch.bool, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    with window or contextlib.nullcontext():
        t0 = time.perf_counter()
        handles = [session.leap(np.nonzero(place == r)[0], (r + 1) % n_regions)
                   for r in np.unique(place)]
        ticks, tick_s, io_s = 0, 0.0, 0.0
        while not drv.done and ticks < 20 * n_blocks:
            t1 = time.perf_counter()
            with no_host_sync(dev):
                session.tick()
            if blocking:
                session.poll(block=True)
            t2 = time.perf_counter()
            wids = distinct_ids(n_blocks, io_per_tick, ids_gen)
            vals = randn(io_per_tick)
            drv.write(wids, vals)
            shadow[wids.to(dev)] = vals
            rids = distinct_ids(n_blocks, io_per_tick, ids_gen)
            stale_read |= (drv.read(rids) != shadow[rids.to(dev)]).any()
            ticks += 1
            tick_s += t2 - t1
            io_s += time.perf_counter() - t2
        check(session.drain(), "the drain completes")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = dict(seconds=time.perf_counter() - t0, tick_s=tick_s, io_s=io_s)
    check(not bool(stale_read), "every read during the drain saw the latest write")
    return drv, shadow, handles, seconds


def check_drain(drv, shadow, handles, huge: bool) -> dict:
    n, regions = drv.state.n_blocks, drv.pool_cfg.n_regions
    for lo in range(0, n, 8192):
        ids = np.arange(lo, min(lo + 8192, n))
        check(torch.equal(drv.read(ids, note=False), shadow[lo : lo + len(ids)]),
              f"blocks {lo}.. read back equal to the shadow")
    check(drv.verify_mirror(), "host table mirror == device table")
    check(drv.verify_tiers(), "two-tier table and allocators consistent")
    check((drv.host_placement() == (start_regions(n, regions) + 1) % regions).all(),
          "every block lives in its destination region")
    p = [h.progress() for h in handles]
    check(sum(x.committed + x.forced + x.cancelled for x in p) == sum(x.requested for x in p) == n,
          "request accounting closes")
    s = drv.stats
    check(s.blocks_migrated + s.blocks_forced + s.blocks_cancelled == s.blocks_requested,
          "engine accounting closes")
    if drv.cfg.dispatch_mode == "megastep":
        check(0.0 < s.dispatches_per_tick <= 1.0, "at most one megastep per tick")
    else:
        check(s.dispatches_per_tick > 1.0, "batched: one program per phase")
    check(s.dirty_rejections > 0, "concurrent writes dirtied some copies")
    if huge:
        check(s.huge_areas_committed > 0, "huge blocks committed as whole runs")
    heat = drv.heat_snapshot()
    check(np.isfinite(heat).all() and (heat > 0).any(), "heat plane finite and warm")
    return dict(
        ticks=s.ticks, dispatches=s.dispatches, dispatches_per_tick=s.dispatches_per_tick,
        dirty_rejections=s.dirty_rejections, blocks_forced=s.blocks_forced, splits=s.splits,
        demotions=s.demotions, huge_areas_committed=s.huge_areas_committed,
        bytes_copied=s.bytes_copied,
    )


def main_path_drain(dev, huge_factor: int, ppermute: bool = False) -> dict:
    """A deployment-size drain: 2 regions through the megastep, or with
    ``ppermute`` 4 regions on a one-card region mesh through the batched
    generation's point-to-point copies."""
    release()
    torch.cuda.reset_peak_memory_stats()
    slots, seed, kw = SLOTS, SEED + huge_factor, {}
    if ppermute:
        slots, seed = PP_SLOTS, SEED + 2
        kw = dict(cfg_kw=PP_CFG, n_regions=PP_REGIONS, mesh=make_region_mesh(PP_REGIONS))
    reset_launch_counts()
    drv, shadow, handles, times = drain(dev, N_BLOCKS, slots, BLOCK, huge_factor, seed, **kw)
    launches = launch_counts()
    out = check_drain(drv, shadow, handles, huge=huge_factor > 1)
    if ppermute:
        check(launches["gather_blocks"] == launches["scatter_blocks"] > 0,
              "every point-to-point copy gathered and scattered once")
        check(launches["copy_blocks"] == 0, "the ppermute drain copies only point to point")
    moved = N_BLOCKS * drv.pool_cfg.block_bytes
    out.update(times, gib_per_s=moved / times["seconds"] / 2**30, launches=launches,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               regions=drv.pool_cfg.n_regions, dispatch=drv.cfg.dispatch_mode,
               backend=drv.cfg.backend)
    print(f"drain huge_factor={huge_factor} backend={drv.cfg.backend}: {times['seconds']:.3f} s "
          f"(ticks {times['tick_s']:.3f} s, app I/O {times['io_s']:.3f} s), "
          f"{out['gib_per_s']:.3f} GiB/s, {out['ticks']} ticks, "
          f"{out['dispatches_per_tick']:.2f} dispatches a tick, "
          f"{out['dirty_rejections']} rejections, peak {out['peak_gib']:.2f} GiB, "
          f"launches {launches}")
    return out


SMALL_KW = dict(initial_area_blocks=16, budget_blocks_per_tick=64, max_attempts_before_force=2,
                tiering=True)


def small_drain(d, huge: int, cfg_kw=SMALL_KW, n_regions: int = 2):
    """A small drain with blocking harvest and values drawn on the CPU, so
    that two devices, or two dispatch generations, see the same schedule."""
    mesh = make_region_mesh(n_regions, [d] * n_regions) if n_regions > 2 else None
    slots = 544 if n_regions == 2 else 160
    return drain(d, 512, slots, (2, 64), huge, SEED, io_per_tick=24, cfg_kw=cfg_kw,
                 blocking=True, values_on="cpu", n_regions=n_regions, mesh=mesh)


def card_matches_cpu(dev, ppermute: bool = False) -> None:
    """Small drains on the card and on the CPU: megastep on small and on
    two-tier pools (phase 5), or a 4-region ppermute drain (phase 14)."""
    cases = ((1, SMALL_KW, 2), (4, SMALL_KW, 2))
    if ppermute:
        cases = ((1, dict(SMALL_KW, backend="ppermute", axis_name="data"), PP_REGIONS),)
    for huge, kw, regions in cases:
        before = launch_counts()
        (gpu, _, hg, _), (cpu, _, hc, _) = [small_drain(d, huge, kw, regions)
                                            for d in (dev, torch.device("cpu"))]
        check(np.array_equal(gpu.host_table(), cpu.host_table()), "host tables agree")
        for a, b in zip(gpu.state.to_numpy(), cpu.state.to_numpy()):
            check(np.array_equal(a, b), "card and CPU states agree bit for bit")
        np.testing.assert_allclose(gpu.heat_snapshot(), cpu.heat_snapshot(), **HEAT_TOL)
        check(gpu.stats == cpu.stats, "card and CPU MigrationStats agree")
        check([h.progress() for h in hg] == [h.progress() for h in hc],
              "card and CPU request progress agree")
        if regions > 2:
            after = launch_counts()
            check(after["scatter_blocks"] > before["scatter_blocks"],
                  "the card's ppermute drain ran the scatter kernel")
            check(gpu.stats.dirty_rejections > 0, "writes dirtied some ppermute copies")
    print(f"small {'ppermute' if ppermute else 'megastep'} drains on the card and on the CPU agree")


def megastep_matches_batched(dev) -> dict:
    """The reference's differential oracle on the card: the same seeded drain
    under the megastep and under the batched generation (xla backend)."""
    m, _, hm, _ = small_drain(dev, 1, dict(SMALL_KW, fused_dispatch="megastep"))
    reset_launch_counts()
    b, _, hb, _ = small_drain(dev, 1, dict(SMALL_KW, fused_dispatch="batched"))
    for x, y in zip(m.state.to_numpy(), b.state.to_numpy()):
        check(np.array_equal(x, y), "megastep and batched leave bit-identical pools and tables")
    check(np.array_equal(m.host_table(), b.host_table()), "megastep and batched host tables agree")
    check([h.progress() for h in hm] == [h.progress() for h in hb], "and the same progress")
    check(m.stats.dirty_rejections == b.stats.dirty_rejections > 0, "the same rejections")
    small = launch_counts()
    huge, shadow, handles, _ = small_drain(dev, 4, dict(SMALL_KW, fused_dispatch="batched"))
    check_drain(huge, shadow, handles, huge=True)
    launches = launch_counts()
    check(launches["copy_runs"] > small["copy_runs"], "the two-tier batched drain copied runs")
    for name in ("copy_blocks", "copy_runs", "heat_scan"):
        check(launches[name] > 0, f"the batched drains launched {name}")
    print(f"megastep and batched agree bit for bit; batched launches {launches}")
    return dict(megastep_dispatches=m.stats.dispatches, batched_dispatches=b.stats.dispatches,
                ticks=b.stats.ticks, batched_launches=launches)


# -- phase 6: the paged-decode kernel against its plain version ----------------


def paged_inputs(dev, dtype, lens: torch.Tensor, seed: int):
    """q, the layer-20 strided view of a 40-layer pool, tables of distinct
    slots, and ``lens``; everything from seeded generators."""
    p = PAGED
    g = torch.Generator(device=dev).manual_seed(seed)
    host = torch.Generator().manual_seed(seed)
    pool = torch.randn((p["slots"], p["layers"], 2, p["blk"], p["kvh"], p["hd"]),
                       generator=g, device=dev, dtype=dtype)
    q = torch.randn((p["b"], p["h"], p["hd"]), generator=g, device=dev, dtype=dtype)
    tables = torch.randperm(p["slots"], generator=host)[: p["b"] * p["maxb"]]
    tables = tables.view(p["b"], p["maxb"]).int().to(dev)
    return q, pool[:, p["layer"]], tables, lens.int().to(dev)


def paged_bound(q, view, lens_host) -> tuple[float, str]:
    """Each input byte read once and each output written once: the K and V
    rows of every token below len, q, the valid table entries and lens; out,
    m and l.  Operations: 4 flops per token, query head and head element."""
    p = PAGED
    toks = int(lens_host.sum())
    kv_bytes = toks * p["kvh"] * p["hd"] * 2 * view.element_size()
    pages = int(((lens_host + p["blk"] - 1) // p["blk"]).sum())
    n_bytes = (kv_bytes + 2 * q.numel() * q.element_size() + pages * 4 + p["b"] * 4
               + 2 * p["b"] * p["h"] * 4)
    return bound_ms(n_bytes, 4.0 * toks * p["h"] * p["hd"])


def paged_timings(q, view, tables, lens, lens_host) -> dict:
    p = PAGED
    qg = q.view(p["b"], p["kvh"], p["h"] // p["kvh"], p["hd"])
    tok = torch.arange(p["maxb"] * p["blk"], device=q.device)
    mask = (tok[None, :] < lens[:, None].long())[:, None, None, :]  # [B, 1, 1, T]

    def library():  # gather the pages, then one fused attention call
        kv = view[tables.long()].transpose(1, 2)  # [B, 2, MAXB, BLK, KVH, hd]
        k = kv[:, 0].reshape(p["b"], -1, p["kvh"], p["hd"]).transpose(1, 2)
        v = kv[:, 1].reshape(p["b"], -1, p["kvh"], p["hd"]).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]

    want = ref.paged_decode_ref(q, view, tables, lens)[0]
    b, by = paged_bound(q, view, lens_host)
    return dict(
        ms=time_ms(lambda: paged_attn.paged_decode(qg, view, tables, lens)),
        plain_ms=time_ms(lambda: ref.paged_decode_ref(q, view, tables, lens)),
        library_ms=time_ms(library), bound_ms=b, bound_by=by,
        library_max_abs_err=float((library().float() - want.float()).abs().max()),
        tokens=int(lens_host.sum()),
    )


def paged_decode_checks(dev) -> dict:
    p = PAGED
    host = torch.Generator().manual_seed(SEED)
    lens = torch.randint(2, p["maxb"] * p["blk"], (p["b"],), generator=host)
    lens[0], lens[-1] = 1, p["maxb"] * p["blk"]  # one sequence of 1 token, one of 1024
    errs = {}
    for dtype, softcap in ((torch.bfloat16, 0.0), (torch.float32, 20.0)):
        q, view, tables, lens_d = paged_inputs(dev, dtype, lens, SEED)
        check(not view.is_contiguous(), "the kernel reads a strided per-layer view")
        got = ops.paged_decode_partial(q, view, tables, lens_d, kv_heads=p["kvh"], softcap=softcap)
        again = ops.paged_decode_partial(q, view, tables, lens_d, kv_heads=p["kvh"],
                                         softcap=softcap)
        want = ops.paged_decode_partial(q, view, tables, lens_d, kv_heads=p["kvh"],
                                        softcap=softcap, impl="ref")
        torch.cuda.synchronize()
        for a, b, w in zip(got, again, want):
            check(torch.equal(a, b), f"paged_decode {dtype} is bit-identical run to run")
            torch.testing.assert_close(a.float(), w.float(), **PAGED_TOL[dtype])
        check(torch.equal(got[2][0], torch.ones_like(got[2][0])), "a 1-token sequence has l == 1")
        pad = (torch.arange(p["maxb"], device=dev)[None, :]
               >= (lens_d[:, None] + p["blk"] - 1) // p["blk"])
        garbage = tables.masked_fill(pad, 2**31 - 1)  # out of range: any read would fault
        unread = ops.paged_decode_partial(q, view, garbage, lens_d, kv_heads=p["kvh"],
                                          softcap=softcap)
        check(all(torch.equal(a, b) for a, b in zip(unread, got)),
              f"paged_decode {dtype} reads no pad table entry")
        errs[str(dtype)] = max(float((a.float() - w.float()).abs().max())
                               for a, w in zip(got, want))
        if dtype == torch.bfloat16:
            row_t = paged_timings(q, view, tables, lens_d, lens)
            serve_lens = torch.full((p["b"],), SERVE["prompt_len"] + SERVE["steps"] // 2)
            at_serving = paged_timings(q, view, tables, serve_lens.int().to(dev), serve_lens)
        del q, view, tables, got, again, want
        torch.cuda.empty_cache()
    row = dict(
        name="paged_decode", route="cuda", source="src/repro_torch/kernels/csrc/paged_attn.cu",
        replaces="src/repro/kernels/paged_attn.py:101", launches=0,
        max_abs_err=errs[str(torch.bfloat16)], **row_t,
        f32_softcap_max_abs_err=errs[str(torch.float32)],
        shape=(f"q [{p['b']}, {p['h']}, {p['hd']}] bf16, layer {p['layer']} of a "
               f"[{p['slots']}, {p['layers']}, 2, {p['blk']}, {p['kvh']}, {p['hd']}] pool, "
               f"MAXB {p['maxb']}, lens {lens.tolist()}"),
        at_serving_lens=at_serving,
    )
    print(f"paged_decode: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, library "
          f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f}), max err bf16 "
          f"{errs[str(torch.bfloat16)]:.3g}, f32 softcap {errs[str(torch.float32)]:.3g}; at "
          f"serving lens {at_serving['ms']:.4f} ms (bound {at_serving['bound_ms']:.4f})")
    return row


# -- phases 7 and 10: serving through PagedEngine ------------------------------


def serve_run(dev, cfg, model, pcfg, prompts, steps: int, live: bool, blocking: bool = False):
    """Admit the prompts (alternating regions), then decode ``steps`` tokens;
    with ``live``, sequences 0 and 1 leap to the other region after the first
    step and the session ticks before every later step.  Returns the engine,
    the sequence ids, the rebalance handles and the timings."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    eng = PagedEngine(cfg, model, pcfg, device=dev)
    t0 = time.perf_counter()
    sids = [eng.admit(pr, region=i % pcfg.n_regions) for i, pr in enumerate(prompts)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    handles = []
    step_s, tick_s = [], 0.0
    for step in range(steps):
        if live and step == 1:
            # after the first step, so that the page holding the append
            # frontier is among the pages in flight
            handles = [eng.rebalance(s, 1 - eng.seqs[s].region) for s in sids[:2]]
        if handles:
            t1 = time.perf_counter()
            eng.tick()
            if blocking:
                eng.session.poll(block=True)
            tick_s += time.perf_counter() - t1
        t1 = time.perf_counter()
        eng.decode(sids)  # ends in the step's one device-to-host copy
        step_s.append(time.perf_counter() - t1)
    if live:
        check(eng.drain(), "the rebalances drain")
    times = dict(
        prefill_s=prefill_s, decode_s=sum(step_s),
        decode_step_ms_median=statistics.median(step_s) * 1e3,
        tokens_per_s=len(sids) * steps / sum(step_s), tick_s=tick_s,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None,
    )
    return eng, sids, handles, times


def check_serving(eng, sids, handles) -> dict:
    drv = eng.driver
    check(drv.verify_mirror(), "KV pool host table mirror == device table")
    for s, h in zip(sids, handles):
        ids = np.asarray(eng.seqs[s].block_ids)
        check((eng.facade.region_of(ids) == eng.seqs[s].region).all(),
              f"every page of sequence {s} lives in its new region")
        p = h.progress()
        check(p.committed + p.forced + p.cancelled == p.requested, "handle accounting closes")
    st = drv.stats
    check(st.blocks_migrated + st.blocks_forced + st.blocks_cancelled == st.blocks_requested,
          "engine accounting closes")
    acc = eng.page_accounting()
    check(acc["used"] + acc["spare"] + acc["free"] == acc["total"], "page accounting closes")
    return dict(blocks_requested=st.blocks_requested, blocks_migrated=st.blocks_migrated,
                blocks_forced=st.blocks_forced, dirty_rejections=st.dirty_rejections,
                ticks=st.ticks, pages=acc)


def serving_deployment(dev):
    """The full-width serving deployment: granite_3_2b with random bf16
    weights from seed 0 on ``dev``, its paged KV pool's config, and the
    prompts.  ``scripts/profile_serving.py`` profiles this same deployment."""
    cfg = get_config("granite_3_2b")
    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
    pcfg = PagedConfig(block_tokens=16, max_blocks_per_seq=64, n_regions=2, slots_per_region=512,
                       leap=LeapConfig(initial_area_blocks=4, budget_blocks_per_tick=8,
                                       tiering=True))
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(SERVE["prompts"], SERVE["prompt_len"]))
    return cfg, model, pcfg, prompts


def serving_full_width(dev) -> dict:
    t0 = time.perf_counter()
    cfg, model, pcfg, prompts = serving_deployment(dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    runs, out = {}, {}
    for name in ("undisturbed", "live"):
        reset_launch_counts()
        eng, sids, handles, times = serve_run(dev, cfg, model, pcfg, prompts, SERVE["steps"],
                                              live=name == "live")
        launches = launch_counts()
        runs[name] = ([eng.seqs[s].tokens for s in sids], eng.last_logits.clone())
        out[name] = dict(times, launches=launches)
        if name == "live":
            out[name].update(check_serving(eng, sids, handles))
            check(out[name]["dirty_rejections"] > 0, "decode appends dirtied in-flight pages")
            check(launches["copy_blocks"] > 0 and launches["heat_scan"] > 0,
                  "the live run launched copy_blocks and heat_scan")
        check(launches["paged_decode"] == SERVE["steps"] * cfg.n_layers,
              f"{name}: one paged-decode launch per layer and step")
        print(f"serving {name}: prefill {times['prefill_s']:.3f} s, decode step "
              f"{times['decode_step_ms_median']:.3f} ms (median), {times['tokens_per_s']:.1f} "
              f"tok/s, decode {times['decode_s']:.3f} s, ticks {times['tick_s']:.3f} s, peak "
              f"{times['peak_gib']:.2f} GiB, launches {launches}")
        del eng
        torch.cuda.empty_cache()
    check(runs["live"][0] == runs["undisturbed"][0],
          "tokens are identical with and without live migration")
    check(torch.equal(runs["live"][1], runs["undisturbed"][1]),
          "the last step's logits are bit-identical with and without live migration")
    del model
    torch.cuda.empty_cache()
    return dict(config="granite_3_2b", layers=cfg.n_layers, dtype="bfloat16", init_s=init_s,
                **SERVE, runs=out)


def serving_card_matches_cpu(dev) -> None:
    """Reduced granite, f32 with TF32 off, on the card and on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(reduce(get_config("granite_3_2b")), n_layers=2)
    cpu_model = lm.init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    models = {"cuda": copy.deepcopy(cpu_model).to(dev), "cpu": cpu_model}
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 12, 16)]
    pcfg = PagedConfig(block_tokens=4, max_blocks_per_seq=16, n_regions=2, slots_per_region=64,
                       leap=LeapConfig(initial_area_blocks=2, chunk_blocks=1,
                                       budget_blocks_per_tick=1, max_attempts_before_force=3,
                                       tiering=True))
    res = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        eng, sids, _, _ = serve_run(d, cfg, models[name], pcfg, prompts, 10, live=True,
                                    blocking=True)
        res[name] = (eng, [eng.seqs[s].tokens for s in sids])
    (gpu, gtok), (cpu, ctok) = res["cuda"], res["cpu"]
    check(gtok == ctok, "card and CPU decode the same tokens")
    check(np.array_equal(gpu.driver.host_table(), cpu.driver.host_table()), "host tables agree")
    g_state, c_state = gpu.driver.state.to_numpy(), cpu.driver.state.to_numpy()
    np.testing.assert_allclose(g_state[0], c_state[0], rtol=1e-5, atol=1e-5)
    for a, b in zip(g_state[1:], c_state[1:]):
        check(np.array_equal(a, b), "card and CPU tables and dirty/in-flight bits agree")
    torch.testing.assert_close(gpu.last_logits.cpu(), cpu.last_logits, rtol=1e-5, atol=1e-5)
    check(gpu.driver.stats == cpu.driver.stats, "card and CPU MigrationStats agree")
    print("reduced granite served on the card and on the CPU agrees")


# -- phase 8: the LRU-scan kernel against its plain version --------------------


def lru_inputs(dev, b: int, t: int, r: int, seed: int):
    """Decays in (0, 1) as the RG-LRU gates make them, normal inputs and h0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.sigmoid(torch.randn((b, t, r), generator=g, device=dev) + 2.0)
    x = torch.randn((b, t, r), generator=g, device=dev)
    return a, x, torch.randn((b, r), generator=g, device=dev)


def lru_scan_checks(dev) -> dict:
    b, t, r = RECUR["prompts"], RECUR["prompt_len"], get_config("recurrentgemma_9b").rnn_width
    a, x, h0 = lru_inputs(dev, b, t, r, SEED)
    got = ops.lru_scan(a, x, h0)
    again = ops.lru_scan(a, x, h0)
    want = ops.lru_scan(a, x, h0, impl="ref")
    torch.cuda.synchronize()
    check(torch.equal(got, want), "lru_scan f32 == plain version, bit for bit")
    check(torch.equal(got, again), "lru_scan is bit-identical run to run")
    a16, x16, h16 = a.bfloat16(), x.bfloat16(), h0.bfloat16()
    got16 = lru_scan.lru_scan(a16, x16, h16)
    want16 = ref.lru_scan_ref(a16, x16, h16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got16.float(), want16.float(), **LRU_BF16_TOL)
    bf16_err = float((got16.float() - want16.float()).abs().max())
    odd = lru_inputs(dev, 3, 17, 96, SEED + 1)
    check(torch.equal(lru_scan.lru_scan(*odd), ref.lru_scan_ref(*odd)),
          "lru_scan at T = 17, R = 96 == plain version, bit for bit")
    # a and b read once, out written once, h0 read once; 2 flops an element
    bound, by = bound_ms(3 * a.numel() * 4 + h0.numel() * 4, 2.0 * a.numel())
    bound16, by16 = bound_ms(3 * a.numel() * 2 + h0.numel() * 4, 2.0 * a.numel())
    row = dict(
        name="lru_scan", route="cuda", source="src/repro_torch/kernels/csrc/lru_scan.cu",
        replaces="src/repro/kernels/lru_scan.py:56", launches=0,
        max_abs_err=float((got - want).abs().max()),
        ms=time_ms(lambda: lru_scan.lru_scan(a, x, h0)),
        plain_ms=time_ms(lambda: ref.lru_scan_ref(a, x, h0), iters=2, repeats=3),
        bound_ms=bound, bound_by=by, library_ms=None,
        library="none (no single PyTorch call computes a linear recurrence)",
        shape=f"a, b, out [{b}, {t}, {r}] f32, h0 [{b}, {r}] f32",
        bf16=dict(ms=time_ms(lambda: lru_scan.lru_scan(a16, x16, h16)), bound_ms=bound16,
                  bound_by=by16, max_abs_err=bf16_err),
    )
    print(f"lru_scan: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, bound {bound:.4f}), "
          f"bit-exact f32; bf16 {row['bf16']['ms']:.4f} ms (bound {bound16:.4f}), max err "
          f"{bf16_err:.3g}")
    return row


# -- phases 9 and 11: recurrentgemma_9b through lm.prefill and lm.decode_step ----


def recurrent_run(model, cfg, prompts: torch.Tensor, steps: int) -> dict:
    """Prefill the prompts, then ``steps`` greedy decode steps; returns the
    tokens, the timings and the launch counts of each part."""
    dev = prompts.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(model, prompts, cfg, prompts.shape[1] + steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = launch_counts()
    finite = torch.isfinite(logits).all()
    reset_launch_counts()
    tok = logits.argmax(-1)[:, None]
    tokens, step_s = [tok.cpu()], []
    for i in range(steps):
        t1 = time.perf_counter()
        logits, cache = lm.decode_step(model, cache, tok, prompts.shape[1] + i, cfg)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)[:, None]
        tokens.append(tok.cpu())  # the step's one device-to-host copy
        step_s.append(time.perf_counter() - t1)
    check(bool(finite), "recurrentgemma logits are finite")
    return dict(
        tokens=torch.cat(tokens, dim=1), prefill_s=prefill_s,
        decode_s=sum(step_s), decode_step_ms_median=statistics.median(step_s) * 1e3,
        tokens_per_s=prompts.shape[0] * steps / sum(step_s),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        prefill_launches=prefill_launches, decode_launches=launch_counts(),
    )


def recurrent_deployment(dev):
    """recurrentgemma_9b at full width with random bf16 weights from seed 0 on
    ``dev``, and its prompts.  ``scripts/profile_recurrent.py`` profiles this
    same run."""
    cfg = get_config("recurrentgemma_9b")
    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(RECUR["prompts"], RECUR["prompt_len"]))).to(dev)
    return cfg, model, prompts


def recurrent_full_width(dev) -> dict:
    """recurrentgemma_9b at full width and depth, twice over the same prompts."""
    t0 = time.perf_counter()
    cfg, model, prompts = recurrent_deployment(dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_rec = cfg.layer_kinds.count("rec")
    runs, tokens = {}, []
    for name in ("first", "second"):
        res = recurrent_run(model, cfg, prompts, RECUR["steps"])
        check(res["prefill_launches"]["lru_scan"] == n_rec,
              f"{name}: one lru_scan launch per rec layer ({n_rec}) in the prefill")
        check(res["decode_launches"]["lru_scan"] == 0, f"{name}: decode launches no lru_scan")
        tokens.append(res.pop("tokens"))
        # the path's counts: the prefill's and the decode's, each set to 0 before it
        res["launches"] = {k: v + res["decode_launches"][k]
                           for k, v in res["prefill_launches"].items()}
        runs[name] = res
        print(f"recurrentgemma_9b {name}: prefill {res['prefill_s']:.3f} s, decode step "
              f"{res['decode_step_ms_median']:.3f} ms (median), {res['tokens_per_s']:.1f} tok/s, "
              f"decode {res['decode_s']:.3f} s, peak {res['peak_gib']:.2f} GiB, launches "
              f"{res['launches']}")
        torch.cuda.empty_cache()
    check(torch.equal(tokens[0], tokens[1]), "a second identical run decodes the same tokens")
    del model
    torch.cuda.empty_cache()
    return dict(config="recurrentgemma_9b", layers=cfg.n_layers, rec_layers=n_rec,
                dtype="bfloat16", params=cfg.param_count(), init_s=init_s, **RECUR, runs=runs)


def recurrent_card_matches_cpu(dev) -> None:
    """Reduced recurrentgemma, f32 with TF32 off, on the card and on the CPU,
    in lockstep: prefill, then 4 decode steps, compared after each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(reduce(get_config("recurrentgemma_9b")), lru_width=128)
    cpu_model = lm.init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 16)))

    def agree(g, c) -> None:
        (glog, gcache), (clog, ccache) = g, c
        torch.testing.assert_close(glog.cpu(), clog, rtol=1e-5, atol=1e-5)
        for gl, cl in zip(gcache, ccache):
            check(set(gl) == set(cl), "card and CPU caches hold the same entries")
            for k in gl:
                torch.testing.assert_close(gl[k].cpu(), cl[k], rtol=1e-5, atol=1e-5)

    before = lru_scan.lru_scan.launches
    g = lm.prefill(gpu_model, prompt.to(dev), cfg, 20)
    check(lru_scan.lru_scan.launches - before == cfg.layer_kinds.count("rec"),
          "the card's prefill ran the lru_scan kernel once per rec layer")
    c = lm.prefill(cpu_model, prompt, cfg, 20)
    agree(g, c)
    for pos in range(16, 20):
        tok = c[0].argmax(-1)[:, None]
        check(torch.equal(g[0].argmax(-1).cpu(), tok[:, 0]), "card and CPU pick the same tokens")
        g = lm.decode_step(gpu_model, g[1], tok.to(dev), pos, cfg)
        c = lm.decode_step(cpu_model, c[1], tok, pos, cfg)
        agree(g, c)
    print("reduced recurrentgemma on the card and on the CPU agrees")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    _build.load()
    print(f"kernels built in {_build.build_info['seconds']:.2f} s: {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    rows = kernel_checks(dev)
    drains = {"small": main_path_drain(dev, 1)}
    drains["huge"] = main_path_drain(dev, HUGE)
    card_matches_cpu(dev)
    release()  # before the peaks of the serving runs
    rows.append(paged_decode_checks(dev))
    serving = serving_full_width(dev)
    rows.append(lru_scan_checks(dev))
    torch.cuda.empty_cache()
    recurrent = recurrent_full_width(dev)
    serving_card_matches_cpu(dev)
    recurrent_card_matches_cpu(dev)
    rows += gather_scatter_checks(dev)
    drains["ppermute"] = main_path_drain(dev, 1, ppermute=True)
    release()
    card_matches_cpu(dev, ppermute=True)
    oracle = megastep_matches_batched(dev)

    # each path's counts were set to 0 just before it ran and read just after
    paths = (list(drains.values()) + list(serving["runs"].values())
             + list(recurrent["runs"].values()))
    for row in rows:
        row["launches"] = sum(d["launches"][row["name"]] for d in paths)
        check(row["launches"] > 0, f"the main path launched {row['name']}")
    by_name = {row["name"]: row for row in rows}
    check(by_name["paged_decode"]["launches"] == 2 * SERVE["steps"] * serving["layers"],
          "paged decode launched once per layer and step in both serving runs")
    check(by_name["lru_scan"]["launches"] == 2 * recurrent["rec_layers"],
          "lru_scan launched once per rec layer in both recurrent prefills")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"drains": drains, "megastep_vs_batched": oracle, "card": smi}))
    print(json.dumps({"serving": serving, "card": smi}))
    print(json.dumps({"recurrent": recurrent, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
