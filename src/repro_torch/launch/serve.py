"""Serving launcher: batched decode over the paged, migration-managed KV
cache, with optional live rebalancing.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
        --requests 8 --tokens 32 --rebalance

runs the full configuration on the current CUDA device (random weights from
``--seed``).  ``--smoke`` serves the reduced two-layer configuration and
``--device cpu`` runs on the CPU with the kernels' plain versions.  Dense
and MoE stacks serve; recurrent ones (recurrentgemma_9b, xlstm_125m) run
through ``lm.prefill`` and ``lm.decode_step`` instead.  ``main`` returns
the tokens of every step, each decode step's wall milliseconds and the
migration's stats.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import PORTED_ARCH_IDS, canon, get_config
from repro_torch.configs.smoke import reduce
from repro_torch.core import LeapConfig
from repro_torch.models import lm
from repro_torch.serving.engine import PagedConfig, PagedEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="|".join(PORTED_ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--regions", type=int, default=2)
    ap.add_argument("--rebalance", action="store_true",
                    help="live-migrate request 0's KV pages mid-decode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(canon(args.arch))
    if args.smoke:
        cfg = dataclasses.replace(reduce(cfg), n_layers=2)
    if not cfg.embed_inputs:
        raise SystemExit(f"{cfg.name}: stub-frontend arch; serve the backbone via "
                         f"contiguous decode")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = lm.init_params(gen, cfg, device)
    max_blocks = max((args.prompt_len + args.tokens) // 4 + 2, 8)
    # Room for every region's share of the requests plus one rebalanced
    # sequence; half the slots are pages, half migration headroom.
    per_region = -(-args.requests // args.regions) + 1
    eng = PagedEngine(
        cfg,
        model,
        PagedConfig(
            block_tokens=4,
            max_blocks_per_seq=max_blocks,
            n_regions=args.regions,
            slots_per_region=max(256, 2 * per_region * max_blocks),
            leap=LeapConfig(initial_area_blocks=4, chunk_blocks=2, budget_blocks_per_tick=4),
        ),
        device=device,
    )
    rng = np.random.default_rng(args.seed)
    sids = [
        eng.admit(rng.integers(0, cfg.vocab_size, size=args.prompt_len), region=i % args.regions)
        for i in range(args.requests)
    ]
    print(f"admitted {len(sids)} requests across {args.regions} regions")
    if args.rebalance:
        h = eng.rebalance(sids[0], dst_region=1 % args.regions)
        print(f"live-rebalancing request 0 ({h.requested} pages)")
    tokens, step_ms = [], []
    t0 = time.perf_counter()
    for step in range(args.tokens):
        t1 = time.perf_counter()
        if args.rebalance:
            eng.tick()
        out = eng.decode(sids)  # the tokens on the host: the step has ended
        step_ms.append((time.perf_counter() - t1) * 1e3)
        tokens.append(out)
        if step < 3 or step == args.tokens - 1:
            print(f"step {step:3d}: {out}")
    s = eng.driver.stats
    if args.rebalance:
        eng.drain()  # updates s in place
        print(f"migration stats: migrated={s.blocks_migrated} forced={s.blocks_forced} "
              f"dirty={s.dirty_rejections}")
    dt = time.perf_counter() - t0
    total = args.tokens * len(sids)
    print(f"{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s) on {device}")
    return dict(tokens=tokens, step_ms=step_ms, seconds=dt, stats=s, layers=cfg.n_layers,
                replays=eng._decode_step.replays)


if __name__ == "__main__":
    main()
