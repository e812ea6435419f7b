"""Kernel dispatch for the migrator's device programs, the serving decode and
the recurrent prefill.

``impl`` picks the implementation:

* ``None`` / ``"auto"``: a CUDA tensor goes to the hand-written CUDA kernel,
  a CPU tensor to the plain PyTorch version;
* ``"cuda"``: the kernel, and a CPU tensor raises;
* ``"ref"``: the plain version, on any device.

Nothing falls back from the kernel to the plain version: a kernel that does
not build or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import heat_scan as heat_mod
from repro_torch.kernels import leap_copy, paged_attn, ref
from repro_torch.kernels import lru_scan as lru_mod

IMPLS = (None, "auto", "cuda", "ref")


def _use_kernel(impl: str | None, t: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ref":
        return False
    if impl == "cuda" and not t.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got one on {t.device}")
    return t.is_cuda


def gather_blocks_impl(pool, idx, *, impl: str | None = None):
    """``pool[idx]``: pack migration blocks into a new contiguous staging buffer."""
    if _use_kernel(impl, pool):
        return leap_copy.gather_blocks(pool, idx)
    return ref.gather_blocks_ref(pool, idx)


def scatter_blocks_impl(pool, idx, blocks, *, impl: str | None = None):
    """Unpack a staging buffer into pool slots, in place; duplicate ids: last wins."""
    if _use_kernel(impl, pool):
        return leap_copy.scatter_blocks(pool, idx, blocks)
    return ref.scatter_blocks_ref(pool, idx, blocks)


def gather_blocks(pool, idx, *, impl: str | None = None):
    """Standalone :func:`gather_blocks_impl` for ids of any integer type."""
    return gather_blocks_impl(pool, idx.long().contiguous(), impl=impl)


def scatter_blocks(pool, idx, blocks, *, impl: str | None = None):
    """Standalone :func:`scatter_blocks_impl` for ids of any integer type."""
    return scatter_blocks_impl(pool, idx.long().contiguous(), blocks.contiguous(), impl=impl)


def copy_blocks_impl(pool, src_idx, dst_idx, *, impl: str | None = None):
    """Intra-pool block copy ``pool[dst_idx[i]] = pool[src_idx[i]]``, in place."""
    if _use_kernel(impl, pool):
        return leap_copy.copy_blocks(pool, src_idx, dst_idx)
    return ref.copy_blocks_ref(pool, src_idx, dst_idx)


def copy_runs_impl(pool, src_starts, dst_starts, *, run: int, impl: str | None = None):
    """Contiguous-run copy: one huge block (``run`` aligned slots) per lane, in place."""
    if _use_kernel(impl, pool):
        return leap_copy.copy_runs(pool, src_starts, dst_starts, run)
    return ref.copy_runs_ref(pool, src_starts, dst_starts, run)


def copy_blocks_shards_impl(shards, src_flat, dst_flat, *, slots_per_region: int,
                            impl: str | None = None) -> None:
    """K1 over region shards, in place: flat slot ``dst_flat[i]`` (slot
    ``% S`` of shard ``// S``) takes flat slot ``src_flat[i]``."""
    if _use_kernel(impl, shards[0]):
        return leap_copy.copy_blocks_shards(shards, src_flat, dst_flat, slots_per_region)
    return ref.copy_shards_ref(shards, src_flat, dst_flat, slots_per_region)


def copy_runs_shards_impl(shards, src_starts, dst_starts, *, slots_per_region: int, run: int,
                          impl: str | None = None) -> None:
    """K2 over region shards, in place: one ``run``-slot move a lane."""
    if _use_kernel(impl, shards[0]):
        return leap_copy.copy_runs_shards(shards, src_starts, dst_starts, slots_per_region, run)
    return ref.copy_shards_ref(shards, src_starts, dst_starts, slots_per_region, run)


def zero_blocks_shards_impl(shards, dst_flat, *, slots_per_region: int,
                            impl: str | None = None) -> None:
    """Zero flat slots of region shards, in place."""
    if _use_kernel(impl, shards[0]):
        return leap_copy.zero_blocks_shards(shards, dst_flat, slots_per_region)
    return ref.zero_shards_ref(shards, dst_flat, slots_per_region)


def heat_scan_impl(heat, ids, w, decay, *, impl: str | None = None):
    """Fused decay + accumulate over the heat plane, in place.

    An empty sample batch leaves the plane untouched (no decay), as the JAX
    dispatcher does; ids ``>= len(heat)`` are inert on every path.
    """
    if ids.shape[0] == 0:
        return heat
    if _use_kernel(impl, heat):
        return heat_mod.heat_scan(heat, ids, w, decay)
    return ref.heat_scan_ref(heat, ids, w, decay)


# -- paged decode attention ----------------------------------------------------


def paged_decode(q, kv_pool, tables, lens, *, kv_heads: int, softcap: float = 0.0,
                 impl: str | None = None):
    """One decode step of paged attention; returns ``out [B, H, hd]``."""
    out, _, _ = paged_decode_partial(
        q, kv_pool, tables, lens, kv_heads=kv_heads, softcap=softcap, impl=impl
    )
    return out


def paged_decode_partial(q, kv_pool, tables, lens, *, kv_heads: int, softcap: float = 0.0,
                         impl: str | None = None):
    """Paged decode returning flash partials ``(out [B,H,hd], m [B,H], l [B,H])``.

    q: [B, H, hd]; kv_pool: [S, 2, BLK, KVH, hd] (a strided per-layer view is
    fine); tables: [B, MAXB] slot ids; lens: [B] tokens per sequence, >= 1.

    Table entries at or past ``ceil(lens / BLK)`` are pad and may hold any
    value.  The kernel never reads them.  The plain version gathers every
    entry, so for it they are set to slot 0 first, as the JAX wrapper does.
    """
    b, h, hd = q.shape
    g = h // kv_heads
    assert g * kv_heads == h, (h, kv_heads)
    if _use_kernel(impl, q):
        out, m, l = paged_attn.paged_decode(
            q.reshape(b, kv_heads, g, hd), kv_pool, tables.to(torch.int32).contiguous(),
            lens.to(torch.int32).contiguous(), softcap=softcap,
        )
        return out.reshape(b, h, hd), m.reshape(b, h), l.reshape(b, h)
    blk = kv_pool.shape[2]
    n_valid = (lens[:, None] + blk - 1) // blk
    pad = torch.arange(tables.shape[1], device=tables.device)[None, :] >= n_valid
    return ref.paged_decode_ref(q, kv_pool, tables.masked_fill(pad, 0), lens, softcap=softcap)


combine_partials = ref.combine_partials


# -- RG-LRU linear-recurrence scan -------------------------------------------------


def lru_scan(a, b, h0, *, impl: str | None = None):
    """``h_t = a_t * h_{t-1} + b_t`` over ``a, b [B, T, R]`` from ``h0 [B, R]``;
    fp32 carry, ``[B, T, R]`` out in ``a.dtype`` (Griffin RG-LRU hot path).

    Differentiable: the default goes through ``lru_scan.LruScan``, whose
    forward and backward are the two kernels on the card and their plain
    versions on the CPU; ``impl="ref"`` is the plain loop under PyTorch's
    own autograd, the oracle."""
    _use_kernel(impl, a)  # checks impl, and that "cuda" gets CUDA tensors
    if impl == "ref":
        return ref.lru_scan_ref(a, b, h0)
    return lru_mod.LruScan.apply(a, b, h0)
