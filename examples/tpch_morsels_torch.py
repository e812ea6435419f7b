"""Paper §7 scenario on the PyTorch port: morsel-driven TPC-H on the wrong
region.

lineitem morsels sit on region 0; the worker on region 1 leap-migrates them
into pooled memory and runs Q1/Q6 five times — while a transactional writer
keeps updating L_ORDERKEY.  Shows migration time, per-query speed-up trend,
and result correctness under concurrent writes.  Runs on the CUDA card by
default; ``--device cpu`` runs the kernels' plain versions on the CPU.

    PYTHONPATH=src python examples/tpch_morsels_torch.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import LeapConfig
from repro_torch.data import tpch
from repro_torch.data.morsels import MorselStore


def card_or_cpu(device: str) -> torch.device:
    """``device``; ``cuda`` (the default) raises without a card."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device: str = "cuda") -> dict:
    """The scenario on ``device``; returns the migration's seconds and stats,
    the query times and the final Q1 result (float64, on the host)."""
    device = card_or_cpu(device)
    n_rows = 131_072
    data = tpch.gen_lineitem(n_rows, seed=0)
    store = MorselStore.create(
        data, rows_per_morsel=1024, n_regions=2, initial_region=0,
        leap=LeapConfig(initial_area_blocks=32, chunk_blocks=16,
                        budget_blocks_per_tick=32),
        device=device,
    )
    print(f"lineitem: {n_rows} rows in {store.n_morsels} morsels on region 0")

    want_q1 = tpch.q1_reference(data, 2400.0)
    rng = np.random.default_rng(1)

    # Session API: leap() returns a LeapHandle future; the sealed facade is
    # the read-only observation surface (no driver internals needed).
    facade = store.session.facade
    t0 = time.perf_counter()
    handle = store.leap(np.arange(store.n_morsels), dst_region=1)
    while not handle.done:
        store.tick()
        store.write_random_fields(rng, 8, tpch.ORDERKEY, -1.0)  # OLTP writer
    assert handle.wait()
    t_mig = time.perf_counter() - t0
    s = facade.snapshot_stats()
    print(f"migration: {t_mig * 1e3:.1f} ms  (retries={s.dirty_rejections}, "
          f"splits={s.splits}, extra={s.extra_bytes(facade.pool_cfg.block_bytes)}B)")
    assert (store.placement() == 1).all() and facade.verify_mirror()

    query_s = {}
    for q, param in (("q1", 2400.0), ("q6", 730.0)):
        ts = []
        for i in range(5):
            t0 = time.perf_counter()
            tpch.run_query(store, q, param)
            sync(device)
            ts.append(time.perf_counter() - t0)
            store.write_random_fields(rng, 8, tpch.ORDERKEY, -1.0)
        print(f"{q}: {['%.1fms' % (t * 1e3) for t in ts]}")
        query_s[q] = ts

    got = tpch.run_query(store, "q1", 2400.0).cpu().numpy().astype(np.float64)
    np.testing.assert_allclose(got, want_q1, rtol=1e-3)
    print("Q1 result matches reference despite concurrent writes ✓")
    return dict(migration_s=t_mig, stats=s, query_s=query_s, q1=got, q1_reference=want_q1,
                placement=store.placement())


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    run(ap.parse_args().device)
