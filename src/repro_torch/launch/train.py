"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
        --steps 20 --batch 8 --seq 1024 --n-micro 2

trains the full configuration on the current CUDA device (random weights
from ``--seed``, synthetic data).  ``--smoke`` trains the reduced
configuration, and ``--device cpu`` runs on the CPU with the kernels' plain
versions:

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b --smoke \\
        --device cpu --steps 50 --batch 8 --seq 64

A rerun with the same ``--ckpt-dir`` resumes from its last checkpoint.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.base import PORTED_ARCH_IDS, canon, get_config
from repro_torch.configs.smoke import reduce
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="|".join(PORTED_ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "leap_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(canon(args.arch))
    if args.smoke:
        cfg = reduce(cfg)
    data = SyntheticLM(
        DataConfig(
            cfg.vocab_size,
            args.seq,
            args.batch,
            embed_dim=None if cfg.embed_inputs else cfg.d_model,
        )
    )
    tcfg = TrainConfig(
        n_micro=args.n_micro,
        accum_dtype=cfg.grad_accum_dtype,
        optimizer=OptimizerConfig(
            peak_lr=args.lr,
            warmup_steps=max(args.steps // 10, 1),
            total_steps=args.steps,
            state_dtype=cfg.opt_state_dtype,
        ),
    )
    tr = Trainer(
        cfg,
        tcfg,
        TrainerConfig(
            total_steps=args.steps,
            ckpt_every=args.ckpt_every,
            ckpt_dir=args.ckpt_dir,
            log_every=max(args.steps // 20, 1),
        ),
        data,
        seed=args.seed,
        device=args.device,
    )
    resumed = tr.restore_or_init()
    if resumed:
        print(f"resumed from step {resumed}")
    tr.run(on_step=lambda s, m: print(
        f"step {s:6d}  loss {m['loss']:.4f}  gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}"
    ))
    print(f"trained {cfg.name} to step {tr.step} on {tr.device}")


if __name__ == "__main__":
    main()
