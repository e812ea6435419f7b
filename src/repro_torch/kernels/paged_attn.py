"""Paged flash-decode attention over a leap block table: the serving hot path.

The KV cache lives in a leap pool and a per-sequence block table maps
logical KV blocks to physical slots.  Decode reads through the same table
the migrator flips, so KV blocks leap-migrate between regions while decode
continues.

``paged_decode`` wraps the hand-written CUDA kernel ``csrc/paged_attn.cu``,
which replaces the TPU kernel ``paged_decode_pallas`` of the JAX package's
``kernels/paged_attn.py``.  A CUDA tensor launches the kernel on the current
stream; a CPU tensor takes the plain version in :mod:`.ref`.

What bounds it on the card is the bytes of K and V it reads,
``sum(lens) * KVH * hd * 2 * dtype bytes``; its flops are a few per byte.
The kernel splits each sequence into :data:`SPLIT_TOKENS`-token splits, one
CTA each, and merges the splits' flash partials inside the same launch
(:func:`decode_splits` sizes the grid from ``MAXB * BLK`` alone).

The pool operand is ``[S, 2, BLK, KVH, hd]`` with dense inner dims and any
slot stride: the serving engine hands it one layer of a pool whose slots hold
every layer, as a strided view, and nothing copies it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128, 192)  # 64, 128 and 192 (nemotron) are the models'; 16 the reduced configs'
MAX_GROUP = 16  # query rows per kv head the kernel holds
SPLIT_TOKENS = 64  # tokens per CTA: csrc/paged_attn.cu's kSplit


def decode_splits(maxb: int, blk: int) -> int:
    """Splits per (sequence, kv head) in the kernel's grid: ``ceil(MAXB * BLK
    / SPLIT_TOKENS)``, from the table's width alone (no read of ``lens``)."""
    return max(1, -(-maxb * blk // SPLIT_TOKENS))


# per (device, stream): an int32 ticket per (sequence, kv head), zero
# between launches (the kernel returns each to zero), grown on demand.  A
# buffer that a captured graph may have baked in is never freed: a grown
# one's predecessor stays in _retired.
_tickets: dict[tuple[int, int], torch.Tensor] = {}
_retired: list[torch.Tensor] = []


def reserve_tickets(device: torch.device, stream: int, n: int) -> None:
    """Make the ticket buffer of ``(device, stream)`` hold ``n`` tickets.

    Call it before capturing launches on ``stream``: an allocation inside a
    capture would come from that graph's private pool.
    """
    key = (device.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)


def _ticket_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _tickets.get((device.index, stream))
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"paged decode captured with fewer than {n} tickets reserved on its stream; "
                "call reserve_tickets before the capture")
        reserve_tickets(device, stream, n)
        buf = _tickets[(device.index, stream)]
    return buf


def _check_operands(q, kv_pool, tables, lens) -> None:
    if not q.is_cuda:
        raise ValueError(f"the CUDA paged-decode kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or kv_pool.dtype != q.dtype:
        raise ValueError(
            f"q and kv_pool must share float32 or bfloat16, got {q.dtype} and {kv_pool.dtype}"
        )
    if q.ndim != 4 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous [B, KVH, G, hd], got {tuple(q.shape)}")
    b, kvh, g, hd = q.shape
    if hd not in HEAD_DIMS or not 1 <= g <= MAX_GROUP:
        raise ValueError(f"hd must be one of {HEAD_DIMS} and G in [1, {MAX_GROUP}], got {hd}, {g}")
    if kv_pool.ndim != 5 or kv_pool.shape[1] != 2 or tuple(kv_pool.shape[3:]) != (kvh, hd):
        raise ValueError(
            f"kv_pool must be [S, 2, BLK, {kvh}, {hd}], got {tuple(kv_pool.shape)}"
        )
    blk = kv_pool.shape[2]
    dense = (blk * kvh * hd, kvh * hd, hd, 1)
    if tuple(kv_pool.stride()[1:]) != dense or kv_pool.stride(0) < 2 * blk * kvh * hd:
        raise ValueError(
            f"kv_pool's inner dims must be dense (strides {dense} below the slot), "
            f"got strides {kv_pool.stride()}"
        )
    if q.data_ptr() % 16 or kv_pool.data_ptr() % 16 or (kv_pool.stride(0) * q.element_size()) % 16:
        raise ValueError("q, kv_pool and the slot stride must be 16-byte aligned")
    for name, t, shape in (("tables", tables, (b, tables.shape[-1])), ("lens", lens, (b,))):
        if t.device != q.device or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 on {q.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape}, got {tuple(t.shape)}")


def paged_decode(
    q: torch.Tensor,  # [B, KVH, G, hd]
    kv_pool: torch.Tensor,  # [S, 2, BLK, KVH, hd], inner dims dense
    tables: torch.Tensor,  # [B, MAXB] int32 slot ids; entries below ceil(lens/BLK) valid
    lens: torch.Tensor,  # [B] int32, >= 1
    *,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(out [B,KVH,G,hd] in q.dtype, m [B,KVH,G], l [B,KVH,G])``, m
    and l in fp32: the flash partials of one decode token per sequence."""
    b, kvh, g, hd = q.shape
    if q.device.type == "cpu":
        out, m, l = ref.paged_decode_ref(
            q.reshape(b, kvh * g, hd), kv_pool, tables, lens, softcap=softcap
        )
        return out.reshape(b, kvh, g, hd), m.reshape(b, kvh, g), l.reshape(b, kvh, g)
    _check_operands(q, kv_pool, tables, lens)
    blk, maxb = kv_pool.shape[2], tables.shape[1]
    n_split = decode_splits(maxb, blk)
    out = torch.empty_like(q)
    m = torch.empty((b, kvh, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    # the splits' partials: written by every live split of a sequence with
    # more than one, read by its last; never read before written
    part_o = torch.empty((b * kvh, n_split, g, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b * kvh, n_split, g, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        tickets = _ticket_buffer(q.device, stream, b * kvh)
        err = _build.load().leap_paged_decode(
            q.data_ptr(),
            kv_pool.data_ptr(),
            tables.data_ptr(),
            lens.data_ptr(),
            out.data_ptr(),
            m.data_ptr(),
            l.data_ptr(),
            part_o.data_ptr(),
            part_ml.data_ptr(),
            tickets.data_ptr(),
            b,
            kvh,
            g,
            hd,
            blk,
            maxb,
            n_split,
            kv_pool.stride(0),
            float(np.float32(softcap)),
            float(np.float32(1.0 / (hd**0.5))),  # the fp32 scale the plain version uses
            _DTYPES[q.dtype],
            stream,
        )
    if err:
        raise RuntimeError(f"leap_paged_decode launch failed: CUDA error {err}")
    paged_decode.launches += 1
    paged_decode.launches_by_head_dim[hd] = paged_decode.launches_by_head_dim.get(hd, 0) + 1
    paged_decode.launches_by_group[g] = paged_decode.launches_by_group.get(g, 0) + 1
    return out, m, l


paged_decode.launches = 0  # kernel launches in this process (read by chip_smoke.py)
paged_decode.launches_by_head_dim = {}  # the same, per head_dim (one instance each)
paged_decode.launches_by_group = {}  # the same, per query heads a kv head (G)
