"""Quickstart on the PyTorch port: the leap migration engine in 60 lines.

Creates a 2-region pool holding 64 blocks, starts an asynchronous migration
through the handle-based session API while a writer keeps mutating blocks,
and shows the dirty-retry protocol converging with zero lost writes.  Runs
on the CUDA card by default; ``--device cpu`` runs the kernels' plain
versions on the CPU.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.api import HandleStatus, LeapSession
from repro_torch.core import LeapConfig, MigrationDriver, PoolConfig, init_state, leap_write


def card_or_cpu(device: str) -> torch.device:
    """``device``; ``cuda`` (the default) raises without a card."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(device)


def run(device: str = "cuda") -> dict:
    """The quickstart on ``device``; returns the ticks, the handle's progress,
    the driver's stats, the placement and the final read (all on the host)."""
    device = card_or_cpu(device)
    # a pool of 64 logical blocks (4 KB each), all resident on region 0
    cfg = PoolConfig(n_regions=2, slots_per_region=80, block_shape=(1, 1024))
    state = init_state(cfg, n_blocks=64, initial_regions=np.zeros(64, np.int32), device=device)
    rng = np.random.default_rng(0)
    data = rng.standard_normal((64, 1, 1024), dtype=np.float32)
    state = leap_write(state, np.arange(64), torch.from_numpy(data))

    drv = MigrationDriver(
        state,
        cfg,
        LeapConfig(
            initial_area_blocks=16,  # start coarse ("16MB sweet spot")
            chunk_blocks=4,  # copy 4 blocks per dispatch
            budget_blocks_per_tick=8,  # async budget per tick
            max_attempts_before_force=4,  # write-through escalation
        ),
    )
    session = LeapSession(drv)

    print("leaping all 64 blocks: region 0 -> region 1 (async, tracked)")
    handle = session.leap(
        np.arange(64),
        dst_region=1,
        on_done=lambda h: print(f"  on_done fired: {h.status.name}"),
    )

    step = 0
    expected = data.copy()
    while not handle.done:
        session.tick()  # one asynchronous migration slice
        # ... meanwhile the application keeps writing (concurrent mutations!)
        ids = rng.choice(64, size=2, replace=False)
        vals = rng.standard_normal((2, 1, 1024), dtype=np.float32)
        drv.write(ids, torch.from_numpy(vals))
        expected[ids] = vals
        step += 1
    assert handle.wait()  # harvest the final verdicts

    p = handle.progress()
    print(f"done after {step} ticks: committed={p.committed} forced={p.forced}")
    assert p.committed + p.forced + p.cancelled == p.requested == 64
    assert handle.status == HandleStatus.COMMITTED
    stats = session.facade.snapshot_stats()
    print(f"dirty rejections={stats.dirty_rejections} splits={stats.splits} "
          f"extra copied={stats.extra_bytes(cfg.block_bytes)} bytes")
    placement = session.facade.placement()
    assert (placement == 1).all(), "all blocks must be on region 1"
    got = drv.read(np.arange(64)).cpu().numpy()
    assert np.array_equal(got, expected), "no write may be lost"
    print("placement verified; every concurrent write preserved ✓")
    return dict(ticks=step, progress=p, stats=stats, placement=placement, read=got)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    run(ap.parse_args().device)
