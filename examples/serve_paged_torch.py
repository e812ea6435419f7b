"""Serving demo on the PyTorch port: batched decode over the leap-paged KV
cache with live replica rebalancing.

Admits a batch of prompts across two regions, decodes while one sequence's
KV pages migrate to the other region, and verifies outputs are identical to
an undisturbed run (the paper's correctness property, on the serving path).
Runs on the CUDA card by default (each decode step one CUDA-graph replay);
``--device cpu`` runs the kernels' plain versions on the CPU.

    PYTHONPATH=src python examples/serve_paged_torch.py [--device cpu]
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.smoke import reduce
from repro_torch.core import LeapConfig
from repro_torch.models import lm
from repro_torch.serving.engine import PagedConfig, PagedEngine


def card_or_cpu(device: str) -> torch.device:
    """``device``; ``cuda`` (the default) raises without a card."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(device)


def run(device: str = "cuda", params: lm.CausalLM | None = None) -> dict:
    """The demo on ``device``; ``params`` (a ``CausalLM`` on ``device``)
    replaces the random weights drawn from seed 0.  Returns the tokens of
    both runs and the live migration's progress and stats."""
    device = card_or_cpu(device)
    cfg = dataclasses.replace(reduce(get_config("qwen2_7b")), n_layers=2)
    if params is None:
        params = lm.init_params(torch.Generator(device=device).manual_seed(0), cfg, device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (6, 11, 17, 9)]
    record = {}

    def serve(live_migration: bool):
        eng = PagedEngine(
            cfg, params,
            PagedConfig(block_tokens=4, max_blocks_per_seq=32, n_regions=2,
                        slots_per_region=128,
                        leap=LeapConfig(initial_area_blocks=2, chunk_blocks=1,
                                        budget_blocks_per_tick=2)),
            device=device,
        )
        sids = [eng.admit(p, region=i % 2) for i, p in enumerate(prompts)]
        handle = None
        if live_migration:
            handle = eng.rebalance(sids[0], dst_region=1)
            print(f"rebalancing seq {sids[0]}: {handle.requested} KV pages "
                  f"region 0 -> 1, live ({handle.status.name})")
        outs = []
        for step in range(16):
            if live_migration:
                eng.tick()
            outs.append(tuple(eng.decode(sids)))
        if live_migration:
            assert handle.wait()
            p = handle.progress()
            assert p.committed + p.forced + p.cancelled == p.requested
            s = eng.facade.snapshot_stats()
            print(f"migration: {handle.status.name} committed={p.committed} "
                  f"forced={p.forced} dirty_rejections={s.dirty_rejections}")
            record.update(progress=p, stats=s, placement=eng.facade.placement())
        return outs

    base = serve(live_migration=False)
    live = serve(live_migration=True)
    assert base == live, "live migration must not change decode outputs"
    print("16 decode steps x 4 sequences: outputs identical under live page migration ✓")
    print("sample tokens:", [t[:2] for t in base[:4]])
    return dict(base=base, live=live, **record)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    run(ap.parse_args().device)
