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

Output: human-readable lines, then the ``{"kernels": [...]}`` line, the
``{"drains": ...}`` line, and last ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the rest of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
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
)
from repro_torch.kernels import _build, heat_scan, leap_copy, ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
HEAT_TOL = dict(rtol=1e-6, atol=1e-6)  # sums over duplicate ids may associate differently
N_BLOCKS = 131072
SLOTS = 131104  # a little headroom over N_BLOCKS; 4097 runs of 32
BLOCK = (1, 16384)  # 64 KiB fp32 blocks
HUGE = 32  # 2 MiB huge blocks
IO_PER_TICK = 64  # writes and reads per tick
SEED = 0


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


def reset_launch_counts() -> None:
    leap_copy.copy_blocks.launches = 0
    leap_copy.copy_runs.launches = 0
    heat_scan.heat_scan.launches = 0


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


# -- phases 3-5: drains through LeapSession -----------------------------------


def drain(dev, n_blocks: int, slots: int, block, huge_factor: int, seed: int,
          io_per_tick: int = IO_PER_TICK, cfg_kw=None, blocking: bool = False,
          values_on=None):
    """Leap every block from region 0 to region 1 under concurrent writes and
    reads; return the driver, the shadow of what was written, the handle and
    the host seconds of the drain: all of it, inside ``session.tick()``, and in
    the application's writes and reads.  Writes and reads draw their ids from a seeded CPU
    generator and their values from a seeded generator on ``values_on``
    (default ``dev``; the CPU where two devices must see the same values)."""
    pc = PoolConfig(2, slots, block, torch.float32, huge_factor=huge_factor)
    state = init_state(pc, n_blocks, np.zeros(n_blocks, np.int32), device=dev)
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
    drv = MigrationDriver(state, pc, cfg)
    if huge_factor > 1:
        groups = n_blocks // huge_factor
        check(drv.adopt_huge(np.arange(groups)) == groups, "adopt_huge adopts every group")
    session = drv.default_session()
    stale_read = torch.zeros((), dtype=torch.bool, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    handle = session.leap(np.arange(n_blocks), 1)
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
    return drv, shadow, handle, seconds


def check_drain(drv, shadow, handle, huge: bool) -> dict:
    n = drv.state.n_blocks
    for lo in range(0, n, 8192):
        ids = np.arange(lo, min(lo + 8192, n))
        check(torch.equal(drv.read(ids, note=False), shadow[lo : lo + len(ids)]),
              f"blocks {lo}.. read back equal to the shadow")
    check(drv.verify_mirror(), "host table mirror == device table")
    check(drv.verify_tiers(), "two-tier table and allocators consistent")
    check((drv.host_placement() == 1).all(), "every block lives in region 1")
    p = handle.progress()
    check(p.committed + p.forced + p.cancelled == p.requested == n, "request accounting closes")
    s = drv.stats
    check(s.blocks_migrated + s.blocks_forced + s.blocks_cancelled == s.blocks_requested,
          "engine accounting closes")
    check(0.0 < s.dispatches_per_tick <= 1.0, "at most one megastep per tick")
    check(s.dirty_rejections > 0, "concurrent writes dirtied some copies")
    if huge:
        check(s.huge_areas_committed > 0, "huge blocks committed as whole runs")
    heat = drv.heat_snapshot()
    check(np.isfinite(heat).all() and (heat > 0).any(), "heat plane finite and warm")
    return dict(
        ticks=s.ticks, dispatches=s.dispatches, dirty_rejections=s.dirty_rejections,
        blocks_forced=s.blocks_forced, splits=s.splits, demotions=s.demotions,
        huge_areas_committed=s.huge_areas_committed, bytes_copied=s.bytes_copied,
    )


def main_path_drain(dev, huge_factor: int) -> dict:
    reset_launch_counts()
    drv, shadow, handle, times = drain(dev, N_BLOCKS, SLOTS, BLOCK, huge_factor, SEED + huge_factor)
    launches = launch_counts()
    out = check_drain(drv, shadow, handle, huge=huge_factor > 1)
    moved = N_BLOCKS * drv.pool_cfg.block_bytes
    out.update(times, gib_per_s=moved / times["seconds"] / 2**30, launches=launches,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"drain huge_factor={huge_factor}: {times['seconds']:.3f} s (ticks "
          f"{times['tick_s']:.3f} s, app I/O {times['io_s']:.3f} s), "
          f"{out['gib_per_s']:.3f} GiB/s, {out['ticks']} ticks, "
          f"{out['dirty_rejections']} rejections, launches {launches}")
    return out


def card_matches_cpu(dev) -> None:
    """A small drain on the card and on the CPU, with blocking harvest."""
    kw = dict(initial_area_blocks=16, budget_blocks_per_tick=64, max_attempts_before_force=2,
              tiering=True)
    for huge in (1, 4):
        runs = [drain(d, 512, 544, (2, 64), huge, SEED, io_per_tick=24, cfg_kw=kw,
                      blocking=True, values_on="cpu")
                for d in (dev, torch.device("cpu"))]
        (gpu, _, hg, _), (cpu, _, hc, _) = runs
        check(np.array_equal(gpu.host_table(), cpu.host_table()), "host tables agree")
        for a, b in zip(gpu.state.to_numpy(), cpu.state.to_numpy()):
            check(np.array_equal(a, b), "card and CPU states agree bit for bit")
        np.testing.assert_allclose(gpu.heat_snapshot(), cpu.heat_snapshot(), **HEAT_TOL)
        check(gpu.stats == cpu.stats, "card and CPU MigrationStats agree")
        check(hg.progress() == hc.progress(), "card and CPU request progress agree")
    print("small drains on the card and on the CPU agree")


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
    torch.cuda.empty_cache()
    drains["huge"] = main_path_drain(dev, HUGE)
    torch.cuda.empty_cache()
    for row in rows:
        row["launches"] = sum(d["launches"][row["name"]] for d in drains.values())
        check(row["launches"] > 0, f"the drains launched {row['name']}")
    card_matches_cpu(dev)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"drains": drains, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
