"""Distributed-optimisation collectives: int8 gradient compression.

The JAX package's ``distributed/collectives.py``.  ``quantized_mean``
compresses each gradient leaf around the data-parallel reduction: a
per-leaf symmetric scale, int8 quantisation, the mean, dequantisation.  On
one process there is no reduction, and it models the wire format alone
(quantise, then dequantise), the reference's path without an axis name.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the two
packages give the same int8 payload bit for bit.

With an ``axis_name`` the reference all-gathers the int8 payload over a
mesh axis.  The port runs on one card so far: it raises rather than return
the unreduced round trip (ROADMAP.md, multi-device).
"""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation: returns (q, scale), scale an
    fp32 0-d tensor."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def quantized_mean(tree, axis_name: str | None = None):
    """Compress-and-reduce a gradient tree (tensors in nested dicts, lists
    and tuples); each leaf comes back in its own dtype.

    Without ``axis_name``: the round trip (quantise, then dequantise), which
    is what one process can verify numerically.
    """
    if axis_name is not None:
        raise NotImplementedError(
            f"quantized_mean over mesh axis {axis_name!r}: the port runs on one card; the "
            f"all-gather of the int8 payload waits for several (ROADMAP.md, multi-device)"
        )

    def one(g):
        q, s = quantize_int8(g)
        return dequantize_int8(q, s, g.dtype)

    return _tree_map(one, tree)
