"""The assigned input shapes, and stand-ins for every input of a cell.

Four shapes per LM architecture (seq_len x global_batch), the JAX package's
``configs/shapes.py``:
  train_4k     4,096 x 256   training
  prefill_32k  32,768 x 32   inference
  decode_32k   32,768 x 128  decode (1 new token, KV cache of seq_len)
  long_500k    524,288 x 1   long-context decode; only for archs with
                             sub-quadratic attention

Where the reference returns ``jax.ShapeDtypeStruct`` s, ``token_inputs``,
``input_specs`` and ``cache_specs`` return tensors on PyTorch's ``meta``
device: the same shapes and dtypes, and no memory.  ``cache_specs`` is the
port's own ``lm.init_cache`` on ``meta``: one entry per layer, in layer
order (the reference stacks a period's repeats on a leading axis).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

SKIP = "SKIP(full-attn)"


def cell_status(cfg: ModelConfig, shape: str) -> str | None:
    """None if the (arch, shape) cell runs; otherwise the skip reason."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return SKIP
    return None


def token_inputs(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.embed_inputs:
        return torch.empty((batch, seq), dtype=torch.int32, device=META)
    # modality frontend stub: precomputed frame/patch embeddings
    return torch.empty((batch, seq, cfg.d_model), dtype=torch.bfloat16, device=META)


def spec_of(shape: str | ShapeSpec) -> ShapeSpec:
    """The shape's entry in ``SHAPES``, or ``shape`` itself when it is a
    ``ShapeSpec`` (a cell cut to a smaller batch)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(cfg: ModelConfig, shape: str | ShapeSpec) -> dict:
    """``meta`` stand-ins for the step function's inputs in this cell."""
    sp = spec_of(shape)
    if sp.kind == "train":
        return {
            "inputs": token_inputs(cfg, sp.global_batch, sp.seq_len),
            "labels": torch.empty((sp.global_batch, sp.seq_len), dtype=torch.int32, device=META),
        }
    if sp.kind == "prefill":
        return {"inputs": token_inputs(cfg, sp.global_batch, sp.seq_len)}
    if sp.kind == "decode":
        # one new token against a cache of seq_len (built by cache_specs)
        return {
            "inputs": token_inputs(cfg, sp.global_batch, 1),
            "pos": torch.empty((), dtype=torch.int32, device=META),
        }
    raise ValueError(sp.kind)


def cache_specs(cfg: ModelConfig, shape: str | ShapeSpec) -> list[dict]:
    """The decode cache of this cell on ``meta``, one dict per layer."""
    from repro_torch.models import lm

    sp = spec_of(shape)
    return lm.init_cache(cfg, sp.global_batch, sp.seq_len, device=META)
