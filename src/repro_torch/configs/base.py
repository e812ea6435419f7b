"""Model configuration schema and the architecture registry.

The same schema as the JAX package's ``configs/base.py``; ``dtype()`` and
``pdtype()`` return ``torch`` dtypes.  Every ported architecture has one
``configs/<id>.py`` exporting ``CONFIG: ModelConfig`` with the exact published
dimensions; reduced smoke variants come from ``configs.smoke.reduce()``.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

# Block kinds (one per layer):
#   attn   - global causal self-attention + dense MLP
#   win    - sliding-window causal self-attention + dense MLP
#   moe    - global causal self-attention + mixture-of-experts FFN
#   rec    - RG-LRU recurrent block (Griffin) + dense MLP
#   mlstm  - xLSTM matrix-memory block (self-contained expansion)
#   slstm  - xLSTM scalar-memory block (self-contained expansion)
BLOCK_KINDS = ("attn", "win", "moe", "rec", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden width
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    norm_topk: bool = True  # renormalize selected gate weights
    groups: int = 1  # GShard expert groups (routing/capacity per token group)
    dispatch_mode: str = "weights"  # "weights" (gather experts) | "tokens" (all-to-all)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layer_pattern: tuple[str, ...] = ("attn",)  # repeating period of kinds
    tail_pattern: tuple[str, ...] = ()  # trailing layers after full periods
    mlp_kind: str = "swiglu"  # swiglu | geglu | relu2 | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    attn_scale: float | None = None  # None -> 1/sqrt(head_dim)
    window: int = 0  # sliding-window size for "win" blocks
    rope_theta: float = 10_000.0
    moe: MoEConfig | None = None
    embed_inputs: bool = True  # False: modality frontend stub feeds embeddings
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    tie_embeddings: bool = False
    lru_width: int | None = None  # RG-LRU state width (default d_model)
    conv_width: int = 4  # causal conv in rec / mlstm blocks
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    grad_accum_dtype: str = "float32"
    microbatch_per_device: int = 1
    attn_chunk: int = 512  # query-block size for chunked attention
    supports_long_context: bool = False
    notes: str = ""

    def __post_init__(self):
        for k in self.layer_pattern + self.tail_pattern:
            if k not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {k}")
        period = len(self.layer_pattern)
        if (self.n_layers - len(self.tail_pattern)) % period != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} incompatible with "
                f"pattern {self.layer_pattern} + tail {self.tail_pattern}"
            )
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def repeats(self) -> int:
        return (self.n_layers - len(self.tail_pattern)) // len(self.layer_pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def rnn_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Every layer's kind in layer order: the period repeated, then the tail."""
        return self.layer_pattern * self.repeats + self.tail_pattern

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def param_count(self) -> int:
        """Exact parameter count, from the model built on the meta device."""
        from repro_torch.models.lm import count_params  # local import, avoids cycle

        return count_params(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        from repro_torch.models.lm import count_params

        return count_params(self, active_only=True)


ARCH_IDS = (
    "nemotron_4_340b",
    "gemma2_27b",
    "granite_3_2b",
    "qwen2_7b",
    "xlstm_125m",
    "dbrx_132b",
    "qwen3_moe_235b_a22b",
    "recurrentgemma_9b",
    "musicgen_large",
    "llava_next_34b",
)

# Every architecture of the JAX package has its config in the port.
PORTED_ARCH_IDS = ARCH_IDS


def canon(arch: str) -> str:
    """Public ``--arch`` ids use dashes."""
    return arch.replace("-", "_")


def get_config(arch: str) -> ModelConfig:
    arch = canon(arch)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; the known ones are {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
