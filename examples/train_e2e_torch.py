"""End-to-end training driver on the PyTorch port: a ~100M-parameter
granite-family model trained for a few hundred steps with checkpoints,
restart-after-failure, and morsel-based data placement.

The default preset is a ~15M model for a few hundred steps; pass
``--preset 100m`` for the full-size run (same code path, just bigger dims /
longer wall time).  Runs on the CUDA card by default; ``--device cpu`` runs
on the CPU.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 200] [--preset 15m]
    PYTHONPATH=src python examples/train_e2e_torch.py --chaos   # kill + restart
"""

import argparse
import dataclasses
import shutil
import tempfile

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.models.lm import count_params
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import TrainConfig, TrainState
from repro_torch.train.trainer import Trainer, TrainerConfig

PRESETS = {
    # (d_model, n_layers, n_heads, kv, head_dim, d_ff, vocab, seq, batch)
    "15m": (256, 8, 8, 4, 32, 1024, 8192, 256, 8),
    "100m": (768, 12, 12, 4, 64, 3072, 32000, 512, 8),
}


def card_or_cpu(device: str) -> torch.device:
    """``device``; ``cuda`` (the default) raises without a card."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(device)


def make_cfg(preset: str):
    d, l, h, kv, hd, ff, v, seq, batch = PRESETS[preset]
    base = get_config("granite_3_2b")
    cfg = dataclasses.replace(
        base,
        d_model=d, n_layers=l, n_heads=h, n_kv_heads=kv, head_dim=hd,
        d_ff=ff, vocab_size=v,
        param_dtype="float32", compute_dtype="float32",
        name=f"granite_{preset}", attn_chunk=128,
    )
    return cfg, seq, batch


def run(steps: int = 200, preset: str = "15m", chaos: bool = False,
        ckpt_dir: str | None = None, device: str = "cuda",
        state: TrainState | None = None) -> list[dict]:
    """Train on ``device``; ``state`` (a ``TrainState`` on ``device``)
    replaces the one drawn from seed 0.  Returns the logged history."""
    device = card_or_cpu(device)
    cfg, seq, batch = make_cfg(preset)

    print(f"model: {cfg.name}  params={count_params(cfg) / 1e6:.1f}M  "
          f"seq={seq} batch={batch} steps={steps}")
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="leaptorch_e2e_")
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    tcfg = TrainConfig(
        n_micro=2,
        optimizer=OptimizerConfig(peak_lr=3e-3, warmup_steps=20,
                                  total_steps=steps),
    )
    mk = lambda: Trainer(  # noqa: E731
        cfg, tcfg,
        TrainerConfig(total_steps=steps, ckpt_every=max(steps // 4, 10),
                      ckpt_dir=ckpt_dir, log_every=10),
        data,
        device=device,
    )

    tr = mk()
    if state is not None:
        tr.state = state
    log = lambda step, m: print(  # noqa: E731
        f"step {step:5d}  loss {m['loss']:.4f}  gnorm {m['grad_norm']:.2f}  lr {m['lr']:.2e}"
    )
    if chaos:
        try:
            tr.run(on_step=log, fail_at=steps // 2)
        except RuntimeError as e:
            print(f"!! {e} — restarting from the last committed checkpoint")
        tr = mk()
        resumed = tr.restore_or_init()
        print(f"resumed from step {resumed}")
    hist = tr.run(on_step=log)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss: {first:.4f} -> {last:.4f}  ({'improved ✓' if last < first else 'NO IMPROVEMENT ✗'})")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return hist


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", choices=PRESETS, default="15m")
    ap.add_argument("--chaos", action="store_true", help="fail mid-run and restart")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args()
    run(args.steps, args.preset, args.chaos, args.ckpt_dir, args.device)
