"""Roofline model for one NVIDIA H100 SXM (80 GB HBM3), the port's card.

The JAX package's ``roofline/model.py`` with the TPU v5e's constants
replaced by the H100 SXM's data-sheet figures, each at the card's full
power limit of 700 W (a card set below it runs slower under load).  Three
terms per (arch x shape x cards) cell, from per-device numbers:

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = wire_bytes_per_device / NVLINK_BW

plus MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) and the usefulness
ratio MODEL_FLOPS / (FLOPs x devices) that catches recompute and dispatch
waste.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12  # H100 SXM, 700 W: dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # H100 SXM, 700 W: HBM3 bytes/s
NVLINK_BW = 450e9  # H100 SXM, 700 W: NVLink bytes/s each way, to the host's other cards
HBM_BYTES = 80e9  # H100 SXM: 80 GB of HBM3


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops: float  # 6·N·D for the whole step, all devices
    n_chips: int

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The step at its bound: the largest of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful model FLOPs / (devices x peak x step_time): the MFU the step
        would reach if it ran exactly at its dominant bound."""
        denom = self.n_chips * PEAK_FLOPS * self.step_time_s
        return self.model_flops / denom if denom else 0.0


def terms_from_artifact(art: dict) -> RooflineTerms:
    return RooflineTerms(
        compute_s=art["flops_per_device"] / PEAK_FLOPS,
        memory_s=art["bytes_per_device"] / HBM_BW,
        collective_s=art["wire_bytes_per_device"] / NVLINK_BW,
        flops_per_device=art["flops_per_device"],
        bytes_per_device=art["bytes_per_device"],
        wire_bytes_per_device=art["wire_bytes_per_device"],
        model_flops=art["model_flops"],
        n_chips=art["n_chips"],
    )


def model_flops(n_params_active: int, n_tokens: int, kind: str) -> float:
    """6·N·D for training; 2·N·D for a forward-only step (prefill/decode)."""
    if kind == "train":
        return 6.0 * n_params_active * n_tokens
    return 2.0 * n_params_active * n_tokens
