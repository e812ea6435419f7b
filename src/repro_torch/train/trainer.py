"""Training loop with checkpoint/restart and simulated failure, as in the JAX
package's ``train/trainer.py``:

  * periodic checkpoints (async by default) with an atomic LATEST marker;
  * ``Trainer.restore_or_init`` resumes from the last committed step; the
    data pipeline is seekable by step, so a restart replays nothing;
  * ``run(fail_at=...)`` simulates a node failure after that step; the
    relaunch restores and continues on the same loss curve.

The trainer runs on ``device``: the current CUDA device by default (it
raises without one); ``device="cpu"`` runs the kernels' plain versions.
The step is compiled as the reference jits it (its state donated): one
``graphs.Program`` a trainer, a variant per batch signature, bound to the
parameters, m, v and the step counter, which it updates in place.  On the
card the first step of a variant runs eagerly, as the real step, and the
program captures after it; every later step replays the graph.  Metrics are
the graph's own tensors, read back to the host only on logging steps,
before the next step overwrites them.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.core import graphs
from repro_torch.core.state import _default_device
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import lm
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import (
    TrainConfig,
    TrainState,
    init_train_state,
    state_tensors,
    train_step,
)


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
        self._step_fn = graphs.Program("train_step", eager_first=True)
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
            metrics = self._run_step(self.data.batch(self.step))
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

    def _run_step(self, batch: dict) -> dict:
        """One step over the host batch, as a variant of the step program
        keyed on the batch's shapes and dtypes; returns its metrics."""
        names = list(batch)
        host = [torch.from_numpy(batch[k]) for k in names]
        key = tuple((k, tuple(t.shape), t.dtype) for k, t in zip(names, host))
        state, cfg, tcfg = self.state, self.cfg, self.tcfg

        def body(*values):
            return train_step(state, dict(zip(names, values)), cfg, tcfg)[1]

        return self._step_fn(key, body, host, state_tensors(state), device=self.device)
