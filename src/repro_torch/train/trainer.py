"""Training loop with checkpoint/restart and simulated failure, as in the JAX
package's ``train/trainer.py``:

  * periodic checkpoints (async by default) with an atomic LATEST marker;
  * ``Trainer.restore_or_init`` resumes from the last committed step; the
    data pipeline is seekable by step, so a restart replays nothing;
  * ``run(fail_at=...)`` simulates a node failure after that step; the
    relaunch restores and continues on the same loss curve.

The trainer runs on ``device``: the current CUDA device by default (it
raises without one); ``device="cpu"`` runs the kernels' plain versions.
Metrics are read back to the host only on logging steps.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.core.state import _default_device
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import lm
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import TrainConfig, TrainState, init_train_state, train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "leap_torch_ckpt"))
    log_every: int = 10
    async_ckpt: bool = True


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainConfig,
        run_cfg: TrainerConfig,
        data: SyntheticLM,
        seed: int = 0,
        device=None,
    ):
        self.cfg, self.tcfg, self.run_cfg, self.data = cfg, tcfg, run_cfg, data
        self.seed = seed
        self.device = _default_device(device)
        self.state: TrainState | None = None
        self.step = 0
        self._pending_ckpt = None
        self.history: list[dict] = []

    # -- lifecycle -----------------------------------------------------------

    def restore_or_init(self) -> int:
        last = ckpt.latest_step(self.run_cfg.ckpt_dir)
        if last is not None:
            model = lm.CausalLM(self.cfg, device="meta")  # a template: no memory
            template = TrainState(params=model, opt=init_opt_state(model, self.tcfg.optimizer))
            self.state, self.step = ckpt.restore(self.run_cfg.ckpt_dir, template,
                                                 device=self.device)
            self.state.params.requires_grad_(True)
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.state = init_train_state(gen, self.cfg, self.tcfg, self.device)
            self.step = 0
        return self.step

    def save(self):
        if self._pending_ckpt is not None:
            self._pending_ckpt.wait()
        self._pending_ckpt = ckpt.save(
            self.run_cfg.ckpt_dir,
            self.step,
            self.state,
            asynchronous=self.run_cfg.async_ckpt,
        )

    # -- loop -----------------------------------------------------------------

    def run(
        self,
        until: int | None = None,
        on_step: Callable[[int, dict], None] | None = None,
        fail_at: int | None = None,
    ) -> list[dict]:
        """Run to ``until`` (default total_steps).  ``fail_at`` simulates a
        node failure (raises RuntimeError) after that step's dispatch."""
        if self.state is None:
            self.restore_or_init()
        until = until or self.run_cfg.total_steps
        while self.step < until:
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch(self.step).items()}
            self.state, metrics = train_step(self.state, batch, self.cfg, self.tcfg)
            self.step += 1
            if fail_at is not None and self.step >= fail_at:
                raise RuntimeError(f"simulated node failure at step {self.step}")
            if self.step % self.run_cfg.ckpt_every == 0:
                self.save()
            if self.step % self.run_cfg.log_every == 0 or self.step == until:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = self.step
                self.history.append(m)
                if on_step:
                    on_step(self.step, m)
        if self._pending_ckpt is not None:
            self._pending_ckpt.wait()
        return self.history
