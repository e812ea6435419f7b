"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function computes what its kernel computes, on any device.  The kernel
wrappers use them for CPU tensors; the tests and ``chip_smoke.py`` hold the
kernels against them.  Like the kernels, the copies and the heat scan update
``pool`` / ``heat`` in place and return it (the JAX package's buffer
donation, made explicit); paged decode and the LRU scan return new tensors.
"""

from __future__ import annotations

import numpy as np
import torch

# -- leap_copy ---------------------------------------------------------------


def gather_blocks_ref(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pool[idx]``: a new ``[K, rows, cols]`` staging buffer."""
    return pool[idx]


def scatter_blocks_ref(
    pool: torch.Tensor, idx: torch.Tensor, blocks: torch.Tensor
) -> torch.Tensor:
    """``pool[idx[i]] = blocks[i]`` in place; of duplicate ids the last lane wins.

    Indexed assignment leaves the winner among duplicate ids unspecified, so
    every lane first takes the block of the last lane with its id: duplicate
    lanes then write equal values, in any order, without a host sync.
    """
    lanes = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((pool.shape[0],), -1, dtype=lanes.dtype, device=idx.device)
    last.scatter_reduce_(0, idx, lanes, reduce="amax")
    pool[idx] = blocks[last[idx]]
    return pool


def copy_blocks_ref(
    pool: torch.Tensor, src_idx: torch.Tensor, dst_idx: torch.Tensor
) -> torch.Tensor:
    """``pool[dst_idx[i]] = pool[src_idx[i]]`` over the flat ``[S, rows, cols]`` pool.

    The gather completes before the scatter, so the result does not depend
    on lane order (destinations are disjoint from sources by contract).
    """
    pool[dst_idx] = pool[src_idx]
    return pool


def copy_runs_ref(
    pool: torch.Tensor, src_starts: torch.Tensor, dst_starts: torch.Tensor, run: int
) -> torch.Tensor:
    """``pool[dst:dst+run] = pool[src:src+run]`` per lane (starts ``run``-aligned)."""
    s = pool.shape[0]
    grouped = pool.view((s // run, run) + tuple(pool.shape[1:]))
    grouped[dst_starts // run] = grouped[src_starts // run]
    return pool


def _sink_ids(shard: torch.Tensor, mine: torch.Tensor, slots: torch.Tensor,
              slots_per_region: int) -> torch.Tensor:
    """``slots`` where ``mine``, else the shard's sink row (its last, past
    the region's ``S`` slots), on the shard's device."""
    if shard.shape[0] <= slots_per_region:
        raise ValueError(f"a shard of {shard.shape[0]} rows has no sink row past "
                         f"{slots_per_region} slots")
    return torch.where(mine, slots, shard.shape[0] - 1).to(shard.device)


def copy_shards_ref(shards, src_flat: torch.Tensor, dst_flat: torch.Tensor,
                    slots_per_region: int, run: int = 1) -> None:
    """In place over region shards ``[S + 1, rows, cols]``: flat slot
    ``dst_flat[i]`` (slot ``% S`` of shard ``// S``) takes flat slot
    ``src_flat[i]``; with ``run > 1`` both are starts of ``run`` slots.

    Every lane is first gathered into a buffer on the ids' device, each from
    its own shard (a loop over the shards, other shards' lanes reading slot
    0 and dropped), then written into its destination shard (a loop over
    the shards, other shards' lanes sent to the sink row).  That equals the
    in-place copy, as no destination is a source."""
    s, home = slots_per_region, src_flat.device
    if run > 1:
        ends = torch.arange(run, device=home)
        src_flat = (src_flat[:, None] + ends).reshape(-1)
        dst_flat = (dst_flat[:, None] + ends).reshape(-1)
    buf = None
    for r, shard in enumerate(shards):
        mine = src_flat // s == r
        part = shard[torch.where(mine, src_flat % s, 0).to(shard.device)].to(home)
        buf = part if buf is None else torch.where(mine[:, None, None], part, buf)
    for r, shard in enumerate(shards):
        shard[_sink_ids(shard, dst_flat // s == r, dst_flat % s, s)] = buf.to(shard.device)


def zero_shards_ref(shards, dst_flat: torch.Tensor, slots_per_region: int) -> None:
    """Zero flat slots ``dst_flat`` of region shards in place (other shards'
    lanes zero each shard's sink row)."""
    s = slots_per_region
    for r, shard in enumerate(shards):
        shard.index_fill_(0, _sink_ids(shard, dst_flat // s == r, dst_flat % s, s), 0)


# -- paged decode attention ---------------------------------------------------


def paged_decode_ref(
    q: torch.Tensor,  # [B, H, hd]
    kv_pool: torch.Tensor,  # [S, 2, BLK, KVH, hd], any strides
    tables: torch.Tensor,  # [B, MAXB] int slot ids, every entry a valid slot
    lens: torch.Tensor,  # [B] int tokens per sequence, >= 1
    *,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-precision paged attention for one decode step.

    Returns ``(out [B,H,hd] in q.dtype, m [B,H] fp32, l [B,H] fp32)``: m and l
    are the softmax max and normalizer, so that shard partials combine as::

        m* = max_i m_i;  l* = sum_i l_i exp(m_i - m*)
        out* = sum_i out_i l_i exp(m_i - m*) / l*

    The scale is ``1/sqrt(hd)`` whatever the model's ``attn_scale`` says, as
    in the JAX oracle.
    """
    b, h, hd = q.shape
    _, _, blk, kvh, _ = kv_pool.shape
    maxb = tables.shape[1]
    g = h // kvh
    scale = 1.0 / (hd**0.5)
    idx = tables.long()
    k = kv_pool[idx, 0].reshape(b, maxb * blk, kvh, hd).float()
    v = kv_pool[idx, 1].reshape(b, maxb * blk, kvh, hd).float()
    qg = (q.float() * scale).reshape(b, kvh, g, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k)  # [B, KVH, G, T]
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    valid = torch.arange(maxb * blk, device=q.device)[None, :] < lens[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1)  # [B, KVH, G]
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v) / l[..., None]
    return out.reshape(b, h, hd).to(q.dtype), m.reshape(b, h), l.reshape(b, h)


def combine_partials(
    outs: torch.Tensor,  # [P, B, H, hd] per-shard partial outputs
    ms: torch.Tensor,  # [P, B, H]
    ls: torch.Tensor,  # [P, B, H]
) -> torch.Tensor:
    """Merge flash partials from P shards (sequence-sharded KV)."""
    m_star = ms.amax(dim=0)  # [B, H]
    w = ls * torch.exp(ms - m_star[None])  # [P, B, H]
    l_star = w.sum(dim=0)
    out = (outs.float() * w[..., None]).sum(dim=0) / l_star[..., None]
    return out.to(outs.dtype)


# -- access-heat scan (closed-loop tiering) -----------------------------------


def heat_scan_ref(
    heat: torch.Tensor,  # [L] f32 per-block heat
    ids: torch.Tensor,  # [K] int64 block ids; ids >= L are inert lanes
    w: torch.Tensor,  # [K] f32 per-access weight
    decay: float,
) -> torch.Tensor:
    """``heat = heat * decay + acc`` with ``acc[i] = sum(w[k] for ids[k] == i)``.

    Lanes with ``ids >= L`` land in a trailing trash entry that is dropped,
    the JAX oracle's ``mode="drop"`` without a host-side mask.
    """
    (length,) = heat.shape
    acc = torch.zeros(length + 1, dtype=torch.float32, device=heat.device)
    acc.index_add_(0, ids.clamp(max=length), w.to(torch.float32))
    heat.mul_(np.float32(decay)).add_(acc[:length])
    return heat


# -- RG-LRU linear-recurrence scan --------------------------------------------


def lru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over the time axis of ``a, b [B, T, R]``.

    A sequential loop in fp32 from ``h0 [B, R]``, the Pallas kernel body's
    order: the multiply and the add round separately, as the CUDA kernel
    does them, so fp32 results agree bit for bit.  Returns ``[B, T, R]`` in
    ``a.dtype``.
    """
    a32, b32 = a.float(), b.float()
    h = h0.float()
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out


def lru_scan_bwd_ref(g: torch.Tensor, a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor):
    """The adjoint of :func:`lru_scan_ref`: ``g`` is the gradient of its output
    ``h``.  A reverse loop in fp32 from ``lambda_T = 0``::

        lambda_t = g_t + a_{t+1} * lambda_{t+1}
        db_t = lambda_t,  da_t = lambda_t * h_{t-1}  (h_{-1} = h0),  dh0 = a_0 * lambda_0

    each multiply and add rounded on its own, the CUDA kernel's order.
    Returns ``(da, db)`` in ``a.dtype`` and ``dh0 [B, R]`` fp32.
    """
    g32, a32, h32, h0_32 = g.float(), a.float(), h.float(), h0.float()
    lam = torch.zeros_like(h0_32)
    a_next = torch.zeros_like(h0_32)
    da = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    db = torch.empty_like(da)
    for t in range(a.shape[1] - 1, -1, -1):
        lam = g32[:, t] + a_next * lam
        db[:, t] = lam
        da[:, t] = lam * (h32[:, t - 1] if t else h0_32)
        a_next = a32[:, t]
    return da, db, a_next * lam
