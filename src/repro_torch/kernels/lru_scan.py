"""RG-LRU linear-recurrence scan: the recurrent prefill's hot path.

Naming note: ``lru`` here is the *Real-Gated Linear Recurrent Unit* of
Griffin/RecurrentGemma, a model-side recurrence over time, not a
least-recently-used page scan (access heat lives in :mod:`.heat_scan`).

Computes ``h_t = a_t * h_{t-1} + b_t`` over the time axis with an fp32
carry.  ``lru_scan`` wraps the hand-written CUDA kernel ``csrc/lru_scan.cu``,
which replaces the TPU kernel ``lru_scan_pallas`` of the JAX package's
``kernels/lru_scan.py``.  A CUDA tensor launches the kernel on the current
stream; a CPU tensor takes the plain version in :mod:`.ref`.

What bounds it on the card is bytes: a and b read once, the output written
once, 2 flops an element.  Unlike the TPU kernel it takes any T and R (the
Pallas tiling needed ``T % chunk == 0`` and ``R % tile == 0``).

``lru_scan_bwd`` wraps the backward of the same source,
``leap_lru_scan_bwd``: the reverse-time adjoint scan, which the JAX package
gets from autodiff of its scan and has no kernel for.  :class:`LruScan`, an
autograd Function, joins the two: forward the forward kernel, backward the
backward kernel, and on CPU tensors the plain versions of both.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BATCH = 65535  # the kernel's grid y dimension


def _check_operands(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> None:
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(
            f"a and b must share float32 or bfloat16, got {a.dtype} and {b.dtype}"
        )
    if a.ndim != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"a and b must be [B, T, R] alike, got {tuple(a.shape)}, {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    bb, t, r = a.shape
    if not (1 <= bb <= MAX_BATCH and t >= 1 and r >= 1):
        raise ValueError(f"needs 1 <= B <= {MAX_BATCH}, T >= 1 and R >= 1, got {tuple(a.shape)}")
    if tuple(h0.shape) != (bb, r) or not h0.is_floating_point():
        raise ValueError(f"h0 must be a float [{bb}, {r}], got {h0.dtype} {tuple(h0.shape)}")
    for name, x in (("b", b), ("h0", h0)):
        if x.device != a.device:
            raise ValueError(f"{name} lies on {x.device}, a on {a.device}")


def lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """``a, b [B, T, R]``, ``h0 [B, R]`` -> ``h [B, T, R]`` in ``a.dtype``
    (fp32 carry; h0 is cast to fp32 first, as the Pallas kernel casts it)."""
    if a.device.type == "cpu":
        return ref.lru_scan_ref(a, b, h0)
    if not a.is_cuda:
        raise ValueError(f"the CUDA LRU-scan kernel needs CUDA tensors, got {a.device}")
    _check_operands(a, b, h0)
    h0 = h0.to(torch.float32).contiguous()
    out = torch.empty_like(a)
    bb, t, r = a.shape
    with torch.cuda.device(a.device):
        err = _build.load().leap_lru_scan(
            a.data_ptr(),
            b.data_ptr(),
            h0.data_ptr(),
            out.data_ptr(),
            bb,
            t,
            r,
            _DTYPES[a.dtype],
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"leap_lru_scan launch failed: CUDA error {err}")
    lru_scan.launches += 1
    return out


lru_scan.launches = 0  # kernel launches in this process (read by chip_smoke.py)


def lru_scan_bwd(g: torch.Tensor, a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor):
    """The scan's backward: ``g`` the gradient of ``h = lru_scan(a, b, h0)``,
    all ``[B, T, R]`` in ``a.dtype``.  Returns ``(da, db)`` in ``a.dtype`` and
    ``dh0 [B, R]`` fp32, with an fp32 carry (see ``csrc/lru_scan.cu``)."""
    if a.device.type == "cpu":
        return ref.lru_scan_bwd_ref(g, a, h, h0)
    if not a.is_cuda:
        raise ValueError(f"the CUDA LRU-scan kernel needs CUDA tensors, got {a.device}")
    _check_operands(a, h, h0)
    _check_operands(a, g, h0)
    h0 = h0.to(torch.float32).contiguous()
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    bb, t, r = a.shape
    with torch.cuda.device(a.device):
        err = _build.load().leap_lru_scan_bwd(
            g.data_ptr(), a.data_ptr(), h.data_ptr(), h0.data_ptr(), da.data_ptr(),
            db.data_ptr(), dh0.data_ptr(), bb, t, r, _DTYPES[a.dtype],
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"leap_lru_scan_bwd launch failed: CUDA error {err}")
    lru_scan_bwd.launches += 1
    return da, db, dh0


lru_scan_bwd.launches = 0  # kernel launches in this process (read by chip_smoke.py)


class LruScan(torch.autograd.Function):
    """``lru_scan`` with a gradient: the forward kernel, then the backward
    kernel over the saved ``a``, ``h`` and ``h0``.  CPU tensors take the
    plain versions of both, so the CPU tests reach the same backward
    formula.  ``h0``'s gradient comes back in ``h0``'s dtype."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = lru_scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = lru_scan_bwd(g.contiguous(), a, h, h0)
        return da, db, dh0.to(h0.dtype)
