"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``gpu`` and skips without a CUDA device.  The file
imports neither JAX nor the JAX package, so on a machine with a card and no
JAX it runs on its own (the suite's ``conftest.py`` imports JAX)::

    python -m pytest -q -p no:cacheprovider --noconftest -m gpu tests/test_torch_cuda.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (  # noqa: E402
    _build, heat_scan, leap_copy, lru_scan, ops, paged_attn, ref,
)

HEAT_TOL = dict(rtol=1e-6, atol=1e-6)  # sums over duplicate ids may associate differently
# the JAX package's paged-decode kernel tolerances (tests/test_kernels_paged_attn.py)
PAGED_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# the JAX package's LRU-scan tolerance in bf16 (tests/test_kernels_lru_scan.py)
LRU_BF16_TOL = dict(rtol=2e-2, atol=2e-2)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32, torch.uint8])
@pytest.mark.parametrize("shape", [(64, 1, 16384), (64, 3, 5)])  # 16-byte words, bytes
def test_copy_kernels_match_plain(cuda, dtype, shape):
    g = torch.Generator().manual_seed(0)
    pool = torch.randint(0, 100, shape, generator=g).to(dtype).to(cuda)
    perm = torch.randperm(shape[0], generator=g)
    src, dst = perm[:16].to(cuda), perm[16:32].to(cuda)
    want = ref.copy_blocks_ref(pool.clone(), src, dst)
    got = leap_copy.copy_blocks(pool.clone(), src, dst)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    runs = torch.randperm(shape[0] // 8, generator=g).to(cuda) * 8
    want = ref.copy_runs_ref(pool.clone(), runs[:3], runs[3:6], 8)
    got = leap_copy.copy_runs(pool.clone(), runs[:3], runs[3:6], 8)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_heat_scan_matches_plain_and_repeats_bit_for_bit(cuda):
    g = torch.Generator().manual_seed(1)
    L = heat_scan.padded_heat_len(5000)
    heat = torch.rand(L, generator=g).to(cuda)
    ids = torch.randint(0, 300, (2500,), generator=g)
    ids[::7] = L + 3
    ids, w = ids.to(cuda), torch.rand(2500, generator=g).to(cuda)
    want = ref.heat_scan_ref(heat.clone(), ids, w, 0.9)
    got = heat_scan.heat_scan(heat.clone(), ids, w, 0.9)
    again = heat_scan.heat_scan(heat.clone(), ids, w, 0.9)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **HEAT_TOL)
    assert torch.equal(got, again)  # no atomics: bit-identical run to run


def _heat_case(dev, n_heat, k, where, seed):
    """A plane of ``n_heat`` entries and ``k`` samples: ``uniform`` over the
    plane, ``skewed`` into its first 2,048 entries, or ``one_tile`` into
    entries 1024..2047; every 9th lane inert (an id at or past the plane)."""
    g = torch.Generator().manual_seed(seed)
    heat = torch.rand(n_heat, generator=g) * 10
    hi = {"uniform": (0, n_heat), "skewed": (0, 2048), "one_tile": (1024, 2048)}[where]
    ids = torch.randint(*hi, (k,), generator=g)
    ids[::9] = n_heat + torch.arange(len(ids[::9]))
    w = torch.rand(k, generator=g) + 0.5
    return heat.to(dev), ids.to(dev), w.to(dev)


@pytest.mark.parametrize("where", ["uniform", "skewed", "one_tile"])
@pytest.mark.parametrize("k", [128, 1024, 4096])  # 4096 in one tile: the buffer folds in rounds
def test_heat_scan_binned_matches_plain(cuda, where, k):
    heat, ids, w = _heat_case(cuda, heat_scan.padded_heat_len(131072), k, where, seed=k)
    want = ref.heat_scan_ref(heat.clone(), ids, w, 0.9)
    before = heat_scan.heat_scan.launches
    got = heat_scan.heat_scan(heat.clone(), ids, w, 0.9)
    again = heat_scan.heat_scan(heat.clone(), ids, w, 0.9)
    torch.cuda.synchronize()
    assert heat_scan.heat_scan.launches == before + 2
    torch.testing.assert_close(got, want, **HEAT_TOL)
    assert torch.equal(got, again)
    untouched = torch.ones_like(heat, dtype=torch.bool)
    untouched[ids[ids < heat.numel()]] = False
    assert torch.equal(got[untouched], heat[untouched] * 0.9)  # decay alone: no sample


@pytest.mark.parametrize("n_heat, offset", [(3000, 0), (4096, 1)])
def test_heat_scan_ragged_and_unaligned_planes(cuda, n_heat, offset):
    """A plane that is no multiple of the tile, and one that starts off a
    16-byte boundary (the kernel's scalar path)."""
    base, ids, w = _heat_case(cuda, n_heat + offset, 600, "uniform", seed=n_heat)
    ids = ids - offset
    ids[ids < 0] = n_heat  # inert
    before = base.clone()
    heat = base[offset:]
    assert (heat.data_ptr() % 16 == 0) == (offset == 0)
    want = ref.heat_scan_ref(heat.clone(), ids, w, 0.5)
    got = heat_scan.heat_scan(heat, ids, w, 0.5)  # in place on the view
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **HEAT_TOL)
    assert torch.equal(base[:offset], before[:offset])  # nothing before the view is written


def test_ops_launch_kernels_on_cuda_and_count_them(cuda):
    pool = torch.zeros(16, 1, 64, device=cuda)
    idx = torch.tensor([0, 1], device=cuda)
    before = leap_copy.copy_blocks.launches
    ops.copy_blocks_impl(pool, idx, idx + 8)
    ops.copy_blocks_impl(pool, idx, idx + 8, impl="cuda")
    ops.copy_blocks_impl(pool, idx, idx + 8, impl="ref")  # the plain version: not counted
    assert leap_copy.copy_blocks.launches == before + 2
    with pytest.raises(ValueError, match="int64"):
        leap_copy.copy_blocks(pool, idx.int(), idx.int() + 8)


# the JAX sweep (tests/test_kernels_leap_copy.py), plus unaligned bytes and
# a region shard of 64 KiB slots
GATHER_SHAPES = [(8, 8, 128), (16, 16, 256), (5, 4, 64), (32, 1, 512), (64, 3, 5)]


def _shard_pool(dev, dtype, shape, regions=3, seed=0):
    """A pool of ``regions`` regions and region 1's flat view, which starts at
    a non-zero storage offset."""
    g = torch.Generator().manual_seed(seed)
    pool = torch.randint(-100, 100, (regions,) + shape, generator=g).to(dtype).to(dev)
    return pool, pool[1:2].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32],
                         ids=["f32", "bf16", "i32"])
@pytest.mark.parametrize("shape", GATHER_SHAPES)
def test_gather_scatter_kernels_match_plain(cuda, dtype, shape):
    pool, shard = _shard_pool(cuda, dtype, shape)
    assert shard.storage_offset() > 0
    g = torch.Generator().manual_seed(1)
    for k in (1, 3, shape[0]):
        idx = torch.randint(0, shape[0], (k,), generator=g).to(cuda)  # duplicates allowed
        before = leap_copy.gather_blocks.launches
        got = ops.gather_blocks_impl(shard, idx)
        want = ops.gather_blocks_impl(shard, idx, impl="ref")
        torch.cuda.synchronize()
        assert leap_copy.gather_blocks.launches == before + 1
        assert torch.equal(got, want)
        ids = torch.randperm(shape[0], generator=g)[:k].to(cuda)
        blocks = torch.randint(-100, 100, (k,) + shape[1:], generator=g).to(dtype).to(cuda)
        before = leap_copy.scatter_blocks.launches
        got = ops.scatter_blocks_impl(pool.clone()[1:2].view(shape), ids, blocks)
        want = ops.scatter_blocks_impl(shard.clone(), ids, blocks, impl="ref")
        torch.cuda.synchronize()
        assert leap_copy.scatter_blocks.launches == before + 1
        assert torch.equal(got, want)
    out = pool.clone()
    leap_copy.scatter_blocks(out[1:2].view(shape), ids, blocks)
    torch.cuda.synchronize()
    assert torch.equal(out[0], pool[0]) and torch.equal(out[2], pool[2])  # other regions untouched


def test_scatter_kernel_last_duplicate_wins(cuda):
    """Lanes with equal ids: the last lane's block lands, every run (CTAs run
    in no order; the kernel, not the schedule, picks the winner)."""
    for shape in ((64, 1, 16384), (64, 3, 5)):  # 16-byte words, bytes
        pool = torch.zeros(shape, device=cuda)
        g = torch.Generator().manual_seed(2)
        idx = torch.randint(0, 8, (256,), generator=g).to(cuda)  # about 32 lanes an id
        blocks = torch.arange(256, dtype=torch.float32, device=cuda)[:, None, None].expand(
            (256,) + shape[1:]).contiguous()
        want = ref.scatter_blocks_ref(pool.clone(), idx, blocks)
        last = {int(i): lane for lane, i in enumerate(idx.tolist())}
        for slot, lane in last.items():
            assert torch.equal(want[slot], blocks[lane])
        for _ in range(20):
            got = leap_copy.scatter_blocks(pool.clone(), idx, blocks)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


def test_gather_scatter_kernels_refuse_what_they_do_not_take(cuda):
    pool = torch.zeros(16, 2, 8, device=cuda)
    idx = torch.tensor([0, 1], device=cuda)
    blocks = torch.ones(2, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="int64"):
        leap_copy.gather_blocks(pool, idx.int())
    with pytest.raises(ValueError, match="contiguous"):
        leap_copy.gather_blocks(pool.transpose(1, 2), idx)
    with pytest.raises(ValueError, match="blocks must be"):
        leap_copy.scatter_blocks(pool, idx, blocks.bfloat16())
    with pytest.raises(ValueError, match="blocks must be"):
        leap_copy.scatter_blocks(pool, idx, blocks[:1])
    with pytest.raises(ValueError, match="share memory"):
        leap_copy.scatter_blocks(pool, idx, pool[4:6])
    with pytest.raises(ValueError, match="int64"):
        leap_copy.scatter_blocks(pool, idx.cpu(), blocks)
    assert leap_copy.gather_blocks(pool, idx[:0]).shape == (0, 2, 8)  # nothing to launch


# K6a's bulk-copy pipeline: lane counts on either side of the card's 132 SMs,
# one drain area and one past it, a tick's budget; slots of whole 16 KiB
# tiles, with a ragged last tile (65,552 B), of 240 and of 512 bytes
BULK_LANES = [1, 3, 131, 132, 133, 256, 257, 1024]
BULK_SLOTS = {"f32-64KiB": (torch.float32, (1, 16384)), "f32-65552B": (torch.float32, (1, 16388)),
              "bf16-240B": (torch.bfloat16, (3, 40)), "i32-512B": (torch.int32, (2, 64))}


def _gather_shard(dev, dtype, slot, n_slots, offset, seed):
    """Region 1 of a 3-region pool: a view whose storage offset is a whole
    number of regions (16-byte aligned, the bulk path) plus ``offset``
    elements (1: not aligned, the byte path)."""
    g = torch.Generator().manual_seed(seed)
    per_region = n_slots * slot[0] * slot[1]
    flat = torch.randint(-1000, 1000, (3 * per_region + offset,), generator=g).to(dtype).to(dev)
    return flat[per_region + offset : 2 * per_region + offset].view((n_slots,) + slot)


def _gather_twice(shard, idx):
    """Two gathers of the same ids, each counted as one launch of its lanes,
    and both bit for bit the plain version's."""
    k = idx.shape[0]
    before = (leap_copy.gather_blocks.launches, leap_copy.gather_blocks.lanes)
    got = leap_copy.gather_blocks(shard, idx)
    assert (leap_copy.gather_blocks.launches, leap_copy.gather_blocks.lanes) == (
        before[0] + 1, before[1] + k)
    again = leap_copy.gather_blocks(shard, idx)
    want = ref.gather_blocks_ref(shard, idx)
    torch.cuda.synchronize()
    assert leap_copy.gather_blocks.launches == before[0] + 2
    assert torch.equal(got, want)
    assert torch.equal(again, got)


@pytest.mark.parametrize("aligned", [True, False], ids=["bulk", "bytes"])
@pytest.mark.parametrize("slot", BULK_SLOTS)
@pytest.mark.parametrize("k", BULK_LANES)
def test_gather_kernel_over_lanes_slots_and_offsets(cuda, k, slot, aligned):
    dtype, shape = BULK_SLOTS[slot]
    shard = _gather_shard(cuda, dtype, shape, 1100, 0 if aligned else 1, seed=k)
    assert (shard.data_ptr() % 16 == 0) == aligned and shard.storage_offset() > 0
    idx = torch.randint(0, 1100, (k,), generator=torch.Generator().manual_seed(k + 1))
    idx[k // 2] = idx[0]  # a duplicate id (k > 1)
    _gather_twice(shard, idx.to(cuda))


@pytest.mark.parametrize("k", [5000, 40000])
def test_gather_kernel_walks_many_lanes_a_cta(cuda, k):
    """16-byte slots: a CTA's share spans more than the 32 lanes whose ids it
    holds, and its ring of stages turns over many times."""
    shard = _gather_shard(cuda, torch.float32, (1, 4), 50000, 0, seed=4)
    idx = torch.randint(0, 50000, (k,), generator=torch.Generator().manual_seed(5))
    _gather_twice(shard, idx.to(cuda))


def test_gather_launches_the_bulk_kernel_on_aligned_operands(cuda):
    """The kernel that runs, by its name in a profiler trace: the bulk-copy
    pipeline for 16-byte-aligned operands, the lane copy's byte instance for
    a shard one element off."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for aligned in (True, False):
        shard = _gather_shard(cuda, torch.float32, (1, 16384), 300, 0 if aligned else 1, seed=6)
        idx = torch.arange(256, device=cuda)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            leap_copy.gather_blocks(shard, idx)
            torch.cuda.synchronize()
        names[aligned] = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert [n for n in names[True] if "gather_bulk_kernel" in n], names[True]
    assert not [n for n in names[True] if "move_lanes_kernel" in n], names[True]
    assert [n for n in names[False] if "move_lanes_kernel" in n and "unsigned char" in n], \
        names[False]


def _paged_inputs(dev, dtype, b, kvh, g, hd, blk=16, maxb=8, n_layers=3, layer=1, seed=0):
    """q, a strided per-layer view of a pool with every layer in each slot,
    tables of distinct slots and lens from 1 to MAXB * BLK."""
    gen = torch.Generator().manual_seed(seed)
    s = b * maxb + 3
    pool = torch.randn((s, n_layers, 2, blk, kvh, hd), generator=gen).to(dtype).to(dev)
    q = torch.randn((b, kvh * g, hd), generator=gen).to(dtype).to(dev)
    tables = torch.randperm(s, generator=gen)[: b * maxb].view(b, maxb).int().to(dev)
    lens = torch.randint(1, maxb * blk + 1, (b,), generator=gen)
    lens[0], lens[-1] = 1, maxb * blk
    return q, pool[:, layer], tables, lens.int().to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [1, 4, 6, 7, 12, 16])  # both G bounds (4, 16); dbrx's 6, nemotron's 12
@pytest.mark.parametrize("hd", [16, 64, 128, 192])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_paged_decode_kernel_matches_plain(cuda, dtype, g, hd, softcap):
    q, view, tables, lens = _paged_inputs(cuda, dtype, b=5, kvh=2, g=g, hd=hd)
    assert not view.is_contiguous()
    before = paged_attn.paged_decode.launches
    got = ops.paged_decode_partial(q, view, tables, lens, kv_heads=2, softcap=softcap)
    again = ops.paged_decode_partial(q, view, tables, lens, kv_heads=2, softcap=softcap)
    want = ops.paged_decode_partial(q, view, tables, lens, kv_heads=2, softcap=softcap,
                                    impl="ref")
    torch.cuda.synchronize()
    assert paged_attn.paged_decode.launches == before + 2  # the plain version is not counted
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)  # no atomics: bit-identical run to run
        torch.testing.assert_close(a.float(), w.float(), **PAGED_TOL[dtype])
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    assert torch.equal(got[2][0], torch.ones_like(got[2][0]))  # lens 1: l is exactly 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_decode_kernel_never_reads_pad_entries(cuda, dtype):
    """The kernel path hands the raw table over; entries at or past
    ceil(lens / BLK) may be anything, and only the plain version needs them
    set to slot 0."""
    q, view, tables, lens = _paged_inputs(cuda, dtype, b=5, kvh=2, g=4, hd=64)
    blk, maxb = view.shape[2], tables.shape[1]
    pad = torch.arange(maxb, device=cuda)[None, :] >= (lens[:, None] + blk - 1) // blk
    assert pad.any()
    garbage = tables.masked_fill(pad, 2**31 - 1)  # out of range: any read would fault
    got = ops.paged_decode_partial(q, view, garbage, lens, kv_heads=2)
    clean = ops.paged_decode_partial(q, view, tables, lens, kv_heads=2)
    want = ops.paged_decode_partial(q, view, garbage, lens, kv_heads=2, impl="ref")
    torch.cuda.synchronize()
    for a, c, w in zip(got, clean, want):
        assert torch.equal(a, c)
        torch.testing.assert_close(a.float(), w.float(), **PAGED_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_decode_kernel_at_nemotrons_width(cuda, dtype):
    """nemotron_4_340b's decode: 8 kv heads of 192, G 12, a 1,024-token table,
    lens from 1 to 1,024; the hd-192 instance is counted apart."""
    b, kvh, g, hd, blk, maxb = 8, 8, 12, 192, 16, 64
    q, view, tables, lens = _paged_inputs(cuda, dtype, b=b, kvh=kvh, g=g, hd=hd, blk=blk,
                                          maxb=maxb, n_layers=2, seed=5)
    before = paged_attn.paged_decode.launches_by_head_dim.get(192, 0)
    got = ops.paged_decode_partial(q, view, tables, lens, kv_heads=kvh)
    again = ops.paged_decode_partial(q, view, tables, lens, kv_heads=kvh)
    want = ops.paged_decode_partial(q, view, tables, lens, kv_heads=kvh, impl="ref")
    torch.cuda.synchronize()
    assert paged_attn.paged_decode.launches_by_head_dim[192] == before + 2
    for a, c, w in zip(got, again, want):
        assert torch.equal(a, c)
        torch.testing.assert_close(a.float(), w.float(), **PAGED_TOL[dtype])


def _split_lens(maxb, blk, b):
    """Lens on and around the kernel's split boundaries, 1 and MAXB * BLK."""
    split = paged_attn.SPLIT_TOKENS
    lens = [1, split - 1, split, split + 1, 2 * split, 3 * split + 1, maxb * blk]
    return torch.tensor((lens * b)[:b], dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128, 192])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_paged_decode_kernel_at_split_boundaries(cuda, dtype, hd, softcap):
    b, kvh, g, blk, maxb = 7, 2, 4, 16, 16
    q, view, tables, _ = _paged_inputs(cuda, dtype, b=b, kvh=kvh, g=g, hd=hd, blk=blk, maxb=maxb)
    lens = _split_lens(maxb, blk, b).to(cuda)
    assert [-(-n // paged_attn.SPLIT_TOKENS) for n in lens.tolist()] == [1, 1, 1, 2, 2, 4, 4]
    got = ops.paged_decode_partial(q, view, tables, lens, kv_heads=kvh, softcap=softcap)
    again = ops.paged_decode_partial(q, view, tables, lens, kv_heads=kvh, softcap=softcap)
    want = ops.paged_decode_partial(q, view, tables, lens, kv_heads=kvh, softcap=softcap,
                                    impl="ref")
    torch.cuda.synchronize()
    for a, c, w in zip(got, again, want):
        assert torch.equal(a, c)  # the merge runs in split order: bit-identical
        torch.testing.assert_close(a.float(), w.float(), **PAGED_TOL[dtype])
    assert torch.equal(got[2][0], torch.ones_like(got[2][0]))  # lens 1: l is exactly 1
    # every ticket went back to zero for the next launch
    assert all(int(t.count_nonzero()) == 0 for t in paged_attn._tickets.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_decode_kernel_mixed_lens_never_reads_pads(cuda, dtype):
    """granite's widths (8 kv heads of 64, G 4) over a 1,024-token table,
    lens from 1 to 1,024, pad entries out of range."""
    b, kvh, g, hd, blk, maxb = 8, 8, 4, 64, 16, 64
    q, view, tables, lens = _paged_inputs(cuda, dtype, b=b, kvh=kvh, g=g, hd=hd, blk=blk,
                                          maxb=maxb, n_layers=2, seed=3)
    pad = torch.arange(maxb, device=cuda)[None, :] >= (lens[:, None] + blk - 1) // blk
    garbage = tables.masked_fill(pad, 2**31 - 1)  # out of range: any read would fault
    got = ops.paged_decode_partial(q, view, garbage, lens, kv_heads=kvh, softcap=20.0)
    clean = ops.paged_decode_partial(q, view, tables, lens, kv_heads=kvh, softcap=20.0)
    want = ops.paged_decode_partial(q, view, tables, lens, kv_heads=kvh, softcap=20.0,
                                    impl="ref")
    torch.cuda.synchronize()
    for a, c, w in zip(got, clean, want):
        assert torch.equal(a, c)
        torch.testing.assert_close(a.float(), w.float(), **PAGED_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_decode_kernel_merges_more_than_32_splits(cuda, dtype):
    """Sequences of 40 and 33 splits: the merge takes its weights 32 splits
    at a time, and its prefetched partials cover only the first few."""
    b, kvh, g, hd, blk, maxb = 2, 2, 4, 64, 16, 160
    q, view, tables, _ = _paged_inputs(cuda, dtype, b=b, kvh=kvh, g=g, hd=hd, blk=blk, maxb=maxb)
    lens = torch.tensor([maxb * blk, 32 * paged_attn.SPLIT_TOKENS + 1], dtype=torch.int32)
    assert [-(-n // paged_attn.SPLIT_TOKENS) for n in lens.tolist()] == [40, 33]  # live splits
    lens = lens.to(cuda)
    got = ops.paged_decode_partial(q, view, tables, lens, kv_heads=kvh, softcap=20.0)
    again = ops.paged_decode_partial(q, view, tables, lens, kv_heads=kvh, softcap=20.0)
    want = ops.paged_decode_partial(q, view, tables, lens, kv_heads=kvh, softcap=20.0,
                                    impl="ref")
    torch.cuda.synchronize()
    for a, c, w in zip(got, again, want):
        assert torch.equal(a, c)
        torch.testing.assert_close(a.float(), w.float(), **PAGED_TOL[dtype])


def test_paged_decode_kernel_refuses_what_it_does_not_take(cuda):
    q, view, tables, lens = _paged_inputs(cuda, torch.float32, b=2, kvh=2, g=4, hd=64)
    qg = q.view(2, 2, 4, 64)
    with pytest.raises(ValueError, match="share"):
        paged_attn.paged_decode(qg.bfloat16(), view, tables, lens)
    sliced = torch.zeros(view.shape[:-1] + (128,), device=cuda)[..., :64]  # rows not dense
    with pytest.raises(ValueError, match="dense"):
        paged_attn.paged_decode(qg, sliced, tables, lens)
    with pytest.raises(ValueError, match="int32"):
        paged_attn.paged_decode(qg, view, tables.long(), lens)
    q96, view96, t96, l96 = _paged_inputs(cuda, torch.float32, b=2, kvh=2, g=1, hd=96)
    with pytest.raises(ValueError, match="hd"):
        paged_attn.paged_decode(q96.view(2, 2, 1, 96), view96, t96, l96)


def _lru_inputs(dev, b, t, r, dtype, seed=0):
    """Decays in (0, 1), as the RG-LRU gates make them; inputs and h0 normal."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.sigmoid(torch.randn((b, t, r), generator=gen) + 2.0)
    x = torch.randn((b, t, r), generator=gen)
    h0 = torch.randn((b, r), generator=gen)
    return a.to(dtype).to(dev), x.to(dtype).to(dev), h0.to(dev)


@pytest.mark.parametrize("t", [1, 8, 17, 2048])
@pytest.mark.parametrize("r", [96, 128, 4096])
def test_lru_scan_kernel_matches_plain(cuda, t, r):
    b = 8 if t * r <= 2048 * 128 else 2
    a, x, h0 = _lru_inputs(cuda, b, t, r, torch.float32, seed=t + r)
    before = lru_scan.lru_scan.launches
    got = ops.lru_scan(a, x, h0)
    again = ops.lru_scan(a, x, h0, impl="cuda")
    want = ops.lru_scan(a, x, h0, impl="ref")  # the plain version: not counted
    torch.cuda.synchronize()
    assert lru_scan.lru_scan.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == a.shape
    assert torch.equal(got, want)  # no FMA contraction: bit for bit
    assert torch.equal(got, again)
    a16, x16 = a.bfloat16(), x.bfloat16()
    got16 = lru_scan.lru_scan(a16, x16, h0.bfloat16())
    want16 = ref.lru_scan_ref(a16, x16, h0.bfloat16())
    torch.cuda.synchronize()
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16.float(), want16.float(), **LRU_BF16_TOL)


def test_lru_scan_kernel_at_batch_one_full_width(cuda):
    """recurrentgemma_9b's prefill_32k shape: 128 CTAs of one warp, f32 bit
    for bit, bit-identical run to run, one launch a call; bf16 in tolerance."""
    a, x, h0 = _lru_inputs(cuda, 1, 32768, 4096, torch.float32, seed=34)
    before = lru_scan.lru_scan.launches
    got = lru_scan.lru_scan(a, x, h0)
    again = lru_scan.lru_scan(a, x, h0)
    want = ref.lru_scan_ref(a, x, h0)
    torch.cuda.synchronize()
    assert lru_scan.lru_scan.launches == before + 2
    plan = lru_scan.lru_scan.last_plan
    assert plan.sms >= 128 and plan.route == "tma" and plan.in_flight_per_sm >= 32768
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    a16, x16 = a.bfloat16(), x.bfloat16()
    got16 = lru_scan.lru_scan(a16, x16, h0)
    want16 = ref.lru_scan_ref(a16, x16, h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got16.float(), want16.float(), **LRU_BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 17, 300])
@pytest.mark.parametrize("r", [33, 50, 100])
def test_lru_scan_kernel_ragged_edges(cuda, dtype, t, r):
    """A ragged last channel group, the tail of T, and rows off 16 bytes (f32
    R = 33 and 50, every bf16 R here) on the narrow route."""
    a, x, h0 = _lru_inputs(cuda, 3, t, r, dtype, seed=t * r)
    before = lru_scan.lru_scan.launches
    got = lru_scan.lru_scan(a, x, h0)
    assert lru_scan.lru_scan.launches == before + 1
    route = "tma" if (r * a.element_size()) % 16 == 0 else "narrow"
    assert lru_scan.lru_scan.last_plan.route == route
    again = lru_scan.lru_scan(a, x, h0)
    want = ref.lru_scan_ref(a, x, h0)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), **LRU_BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_scan_kernel_operands_off_16_bytes(cuda, dtype):
    """Contiguous views one element into their storage take the narrow route."""
    b, t, r = 2, 40, 128
    a, x, h0 = _lru_inputs(cuda, b, t, r, dtype, seed=5)
    store_a = torch.empty(a.numel() + 1, dtype=dtype, device=cuda)
    store_x = torch.empty(a.numel() + 1, dtype=dtype, device=cuda)
    va, vx = store_a[1:].view(b, t, r), store_x[1:].view(b, t, r)
    va.copy_(a)
    vx.copy_(x)
    got = lru_scan.lru_scan(va, vx, h0)
    assert lru_scan.lru_scan.last_plan.route == "narrow"
    want = lru_scan.lru_scan(a, x, h0)
    assert lru_scan.lru_scan.last_plan.route == "tma"
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_lru_scan_kernel_refused_plan_raises(cuda, monkeypatch):
    """A plan the kernel cannot run comes back as a CUDA error, and the
    wrapper raises: no step down to another kernel or the plain version."""
    b, t, r = 2, 40, 128
    a, x, h0 = _lru_inputs(cuda, b, t, r, torch.float32, seed=6)
    store = torch.empty(a.numel() + 1, device=cuda)
    off = store[1:].view(b, t, r)
    off.copy_(a)
    plan = lru_scan.plan_lru_scan(b, t, r, 4, lru_scan.sm_count(cuda), aligned=True)
    lib = _build.load()
    assert lru_scan.launch(lib, off, x, h0, torch.empty_like(a), plan) != 0  # tma off 16 B
    too_big = dataclasses.replace(plan, grid=plan.tiles + 1)
    assert lru_scan.launch(lib, a, x, h0, torch.empty_like(a), too_big) != 0
    monkeypatch.setattr(lru_scan, "plan_lru_scan", lambda *args, **kw: plan)
    before = lru_scan.lru_scan.launches
    with pytest.raises(RuntimeError, match="leap_lru_scan"):
        lru_scan.lru_scan(off, x, h0)
    assert lru_scan.lru_scan.launches == before


def test_lru_scan_kernel_refuses_what_it_does_not_take(cuda):
    a, x, h0 = _lru_inputs(cuda, 2, 16, 128, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        lru_scan.lru_scan(a.transpose(1, 2), x.transpose(1, 2), h0)
    with pytest.raises(ValueError, match="share"):
        lru_scan.lru_scan(a, x.bfloat16(), h0)
    with pytest.raises(ValueError, match="share"):
        lru_scan.lru_scan(a.half(), x.half(), h0)
    with pytest.raises(ValueError, match="h0"):
        lru_scan.lru_scan(a, x, h0[:, :64])
    with pytest.raises(ValueError, match="lies on"):
        lru_scan.lru_scan(a, x, h0.cpu())


@pytest.mark.parametrize("t", [1, 8, 17, 2048])
@pytest.mark.parametrize("r", [96, 4096])
def test_lru_scan_backward_kernel_matches_plain(cuda, t, r):
    b = 8 if t * r <= 2048 * 128 else 2
    a, x, h0 = _lru_inputs(cuda, b, t, r, torch.float32, seed=t + r)
    g = torch.randn(a.shape, generator=torch.Generator().manual_seed(t)).to(cuda)
    h = ref.lru_scan_ref(a, x, h0)
    before = lru_scan.lru_scan_bwd.launches
    got = lru_scan.lru_scan_bwd(g, a, h, h0)
    again = lru_scan.lru_scan_bwd(g, a, h, h0)
    want = ref.lru_scan_bwd_ref(g, a, h, h0)
    torch.cuda.synchronize()
    assert lru_scan.lru_scan_bwd.launches == before + 2
    for k, w, z in zip(got, want, again):
        assert k.dtype == w.dtype == torch.float32 and k.shape == w.shape
        assert torch.equal(k, w)  # no FMA contraction: bit for bit
        assert torch.equal(k, z)
    a16, g16 = a.bfloat16(), g.bfloat16()
    h16 = ref.lru_scan_ref(a16, x.bfloat16(), h0)
    got16 = lru_scan.lru_scan_bwd(g16, a16, h16, h0)
    want16 = ref.lru_scan_bwd_ref(g16, a16, h16, h0)
    torch.cuda.synchronize()
    assert got16[0].dtype == got16[1].dtype == torch.bfloat16
    for k, w in zip(got16, want16):
        torch.testing.assert_close(k.float(), w.float(), **LRU_BF16_TOL)


def test_lru_scan_function_launches_both_kernels(cuda):
    a, x, h0 = _lru_inputs(cuda, 2, 64, 256, torch.float32, seed=3)
    leaves = [v.clone().requires_grad_() for v in (a, x, h0)]
    w = torch.randn(a.shape, generator=torch.Generator().manual_seed(4)).to(cuda)
    before = (lru_scan.lru_scan.launches, lru_scan.lru_scan_bwd.launches)
    got = torch.autograd.grad((ops.lru_scan(*leaves) * w).sum(), leaves)
    torch.cuda.synchronize()
    assert (lru_scan.lru_scan.launches, lru_scan.lru_scan_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    plain = [v.clone().requires_grad_() for v in (a, x, h0)]
    want = torch.autograd.grad((ops.lru_scan(*plain, impl="ref") * w).sum(), plain)
    for k, p in zip(got, want):
        assert torch.equal(k, p)


def test_lru_scan_backward_refuses_what_it_does_not_take(cuda):
    a, x, h0 = _lru_inputs(cuda, 2, 16, 128, torch.float32)
    h = ref.lru_scan_ref(a, x, h0)
    with pytest.raises(ValueError, match="contiguous"):
        lru_scan.lru_scan_bwd(x.transpose(1, 2).contiguous().transpose(1, 2), a, h, h0)
    with pytest.raises(ValueError, match="share"):
        lru_scan.lru_scan_bwd(x.bfloat16(), a, h, h0)
    with pytest.raises(ValueError, match="lies on"):
        lru_scan.lru_scan_bwd(x, a, h, h0.cpu())


@pytest.mark.parametrize("arch", ["granite_3_2b", "recurrentgemma_9b"])
def test_reduced_train_step_on_the_card_like_the_cpu(cuda, arch, monkeypatch):
    """Two train steps of the reduced config (f32, TF32 off) on the card and
    on the CPU from one state: losses within 1e-5."""
    import copy

    from repro_torch.configs.base import get_config
    from repro_torch.configs.smoke import reduce
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import TrainConfig, init_train_state, train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = reduce(get_config(arch))
    tcfg = TrainConfig(n_micro=2, optimizer=OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                                            total_steps=4))
    cpu = init_train_state(torch.Generator().manual_seed(0), cfg, tcfg, "cpu")
    gpu = copy.deepcopy(cpu)
    gpu.params.to(cuda)
    gpu.opt = {k: ({n: t.to(cuda) for n, t in v.items()} if isinstance(v, dict) else v.to(cuda))
               for k, v in gpu.opt.items()}
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 4, seed=1))
    before = (lru_scan.lru_scan.launches, lru_scan.lru_scan_bwd.launches)
    for step in range(2):
        batch = data.batch(step)
        _, mc = train_step(cpu, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, tcfg)
        _, mg = train_step(gpu, {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()},
                           cfg, tcfg)
        torch.testing.assert_close(mg["loss"].cpu(), mc["loss"], rtol=1e-5, atol=1e-5)
    n_rec = cfg.layer_kinds.count("rec")
    # each microbatch runs each rec layer forward twice (the recompute) and back once
    assert (lru_scan.lru_scan.launches - before[0], lru_scan.lru_scan_bwd.launches - before[1]) \
        == (2 * 2 * 2 * n_rec, 2 * 2 * n_rec)


# -- the contenders, the tiering loop and TPC-H on the card ----------------------


def _driver(dev, n, slots, placement, cfg_kw, *, n_regions=2, topology=None, huge=1, seed=0):
    from repro_torch.core import LeapConfig, MigrationDriver, PoolConfig, init_state, leap_write

    pc = PoolConfig(n_regions, slots, (2, 64), topology=topology, huge_factor=huge)
    gen = torch.Generator().manual_seed(seed)
    data = torch.randn((n, 2, 64), generator=gen)
    state = leap_write(init_state(pc, n, placement, device=dev), torch.arange(n), data.to(dev))
    return MigrationDriver(state, pc, LeapConfig(**cfg_kw)), data


@pytest.mark.parametrize("huge", [1, 4])
def test_legacy_matches_megastep_on_the_card(cuda, huge):
    """One seeded drain under writes through the legacy and the megastep
    generation, blocking harvest: pools, tables and flags bit for bit."""
    import numpy as np

    runs = {}
    for mode in ("legacy", "megastep"):
        drv, data = _driver(cuda, 256, 320, np.zeros(256, np.int32), dict(
            initial_area_blocks=16, budget_blocks_per_tick=32, max_attempts_before_force=2,
            tiering=True, fused_dispatch=mode), huge=huge)
        if huge > 1:
            assert drv.adopt_huge(np.arange(256 // huge)) == 256 // huge
        s = drv.default_session()
        s.leap(np.arange(256), 1)
        gen = torch.Generator().manual_seed(1)
        while not drv.done:
            s.tick()
            s.poll(block=True)
            ids = torch.randperm(256, generator=gen)[:12]
            vals = torch.randn((12, 2, 64), generator=gen)
            drv.write(ids, vals.to(cuda))
            data[ids] = vals
        assert s.drain() and drv.verify_mirror()
        assert torch.equal(drv.read(torch.arange(256), note=False).cpu(), data)
        runs[mode] = drv
    for a, b in zip(runs["legacy"].state.to_numpy(), runs["megastep"].state.to_numpy()):
        assert (a == b).all()
    assert runs["legacy"].stats.dirty_rejections == runs["megastep"].stats.dirty_rejections > 0
    assert runs["legacy"].stats.dispatches > runs["megastep"].stats.dispatches


def test_tpch_queries_repeat_bit_for_bit_on_the_card(cuda):
    from repro_torch.data import tpch
    from repro_torch.data.morsels import MorselStore

    data = tpch.gen_lineitem(64 * 2048, seed=0)
    store = MorselStore.create(data, 2048, 2)  # on the card by default
    assert store.driver.state.device.type == "cuda"
    for which, p, want in (("q1", 2400.0, tpch.q1_reference(data, 2400.0)),
                           ("q6", 730.0, tpch.q6_reference(data, 730.0))):
        got = tpch.run_query(store, which, p)
        again = tpch.run_query(store, which, p)
        assert got.is_cuda and torch.equal(got, again)
        want = torch.tensor(want, dtype=torch.float64)
        torch.testing.assert_close(got.double().cpu(), want, rtol=1e-3, atol=0)


def test_sync_resharder_fails_exactly_the_busy_set_on_the_card(cuda):
    import numpy as np

    from repro_torch.core import SyncResharder
    from repro_torch.core.pipeline import busy_mask

    drv, data = _driver(cuda, 64, 128, np.zeros(64, np.int32), dict(initial_area_blocks=8))
    s = drv.default_session()
    s.leap(np.arange(16), 1)
    s.tick()  # epochs open: blocks 0..15 are in flight or claimed
    drv.write(torch.tensor([3, 40]), torch.ones((2, 2, 64), device=cuda))
    data[[3, 40]] = 1.0
    ids = np.arange(64)
    busy = busy_mask(drv.state, ids).cpu().numpy() | drv.in_migration(ids)
    res = SyncResharder(drv.pool_cfg).migrate_driver(drv, ids, 1)
    assert res.failed.tolist() == np.nonzero(busy)[0].tolist()
    assert sorted(res.migrated.tolist() + res.failed.tolist()) == ids.tolist()
    assert s.drain() and (drv.host_placement() == 1).all()
    assert torch.equal(drv.read(torch.arange(64), note=False).cpu(), data)


def test_tiering_policy_promotes_a_hot_far_block_on_the_card(cuda):
    import numpy as np

    from repro_torch.tiering import TieringConfig, TieringPolicy
    from repro_torch.topology import NumaTopology

    before = heat_scan.heat_scan.launches
    drv, _ = _driver(cuda, 48, 64, np.full(48, 2, np.int32), dict(tiering=True),
                     n_regions=3, topology=NumaTopology.cxl_pooled(2, 1))
    pol = TieringPolicy(drv, TieringConfig(hot_watermark=2.0, epoch_ticks=4))
    s = drv.default_session()
    for _ in range(24):
        drv.read(np.array([20]))
        pol.maybe_apply(s)
        s.tick()
    assert s.drain()
    assert drv.host_placement()[20] in (0, 1) and drv.stats.tier_promotions >= 1
    assert heat_scan.heat_scan.launches > before  # the plane the policy read
    txt = s.telemetry().metrics_text()
    assert 'tier_resident_bytes{tier="far"}' in txt


# -- the chaos harness on the card ------------------------------------------------


def _chaos_on(dev, spec, **kw):
    import dataclasses

    from repro_torch.chaos import ChaosDriver

    chaos = ChaosDriver(spec, device=dev, **kw)
    report = dataclasses.asdict(chaos.run())
    stats = dataclasses.asdict(chaos.driver.stats)
    return report, stats, chaos.driver.host_table(), chaos.driver.state.to_numpy()


@pytest.mark.parametrize("mode", ["megastep", "batched", "legacy"])
def test_chaos_seed_matches_cpu_on_the_card(cuda, mode):
    """``sample_spec(2)`` (a 4-region exchange under faults, tiering on)
    through each dispatch generation: the same report, stats, host table
    and state, bit for bit, on the card and on the CPU."""
    import dataclasses

    from repro_torch.chaos import sample_spec

    spec = dataclasses.replace(sample_spec(2), dispatch=mode)
    before = leap_copy.copy_blocks.launches
    got = _chaos_on(cuda, spec)
    assert got[0]["completed"]
    if mode != "legacy":  # legacy copies by plain indexing
        assert leap_copy.copy_blocks.launches > before
    want = _chaos_on("cpu", spec)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:3] + got[3], want[2:3] + want[3]):
        assert (a == b).all()


def test_chaos_sabotage_is_caught_on_the_card(cuda, tmp_path):
    from repro_torch.chaos import InvariantViolation, ScenarioSpec, run_scenario, run_with_repro

    spec = ScenarioSpec(seed=0, ticks=4, n_regions=2, slots_per_region=16, n_blocks=8,
                        placement="spread", scheduler="sync", workload="exchange")
    with pytest.raises(InvariantViolation) as exc:
        run_with_repro(spec, str(tmp_path), sabotage="skip_quarantine")
    assert exc.value.invariant == "payload"
    replayed = ScenarioSpec.from_json((tmp_path / "last_failure.json").read_text())
    with pytest.raises(InvariantViolation, match="payload"):
        run_scenario(replayed, sabotage="skip_quarantine")
    assert run_scenario(replayed).completed


# -- the MoE and xLSTM stacks on the card ------------------------------------------


def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


@pytest.mark.parametrize("factor", [8.0, 1.25])  # the smoke factor, and the published one
@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "dbrx_132b"])
def test_reduced_moe_serves_on_the_card_like_the_cpu(cuda, arch, factor, monkeypatch):
    """The reduced two-layer MoE stack (f32, TF32 off) served on the card and
    on the CPU while one sequence's pages leap, blocking harvest: equal
    tokens, tables and flags; pools and logits within 1e-5."""
    import copy
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.configs.smoke import reduce
    from repro_torch.core import LeapConfig
    from repro_torch.models import lm
    from repro_torch.serving.engine import PagedConfig, PagedEngine

    _no_tf32(monkeypatch)
    cfg = dataclasses.replace(reduce(get_config(arch)), n_layers=2)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
    cpu_model = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(cuda)}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 12)]
    leap = LeapConfig(initial_area_blocks=2, chunk_blocks=1, budget_blocks_per_tick=1,
                      max_attempts_before_force=3, tiering=True)
    pcfg = PagedConfig(block_tokens=4, max_blocks_per_seq=16, n_regions=2, slots_per_region=64,
                       leap=leap)
    engines, tokens = {}, {}
    before = paged_attn.paged_decode.launches
    for name, dev in (("cuda", cuda), ("cpu", torch.device("cpu"))):
        eng = PagedEngine(cfg, models[name], pcfg, device=dev)
        sids = [eng.admit(p, region=0) for p in prompts]
        eng.rebalance(sids[0], dst_region=1)
        for _ in range(8):
            eng.tick()
            eng.session.poll(block=True)
            eng.decode(sids)
        assert eng.drain()
        engines[name], tokens[name] = eng, [eng.seqs[s].tokens for s in sids]
        if name == "cuda":
            assert paged_attn.paged_decode.launches - before == 8 * cfg.n_layers
    gpu, cpu = engines["cuda"], engines["cpu"]
    assert tokens["cuda"] == tokens["cpu"]
    assert np.array_equal(gpu.driver.host_table(), cpu.driver.host_table())
    g_state, c_state = gpu.driver.state.to_numpy(), cpu.driver.state.to_numpy()
    np.testing.assert_allclose(g_state[0], c_state[0], rtol=1e-5, atol=1e-5)
    for a, b in zip(g_state[1:], c_state[1:]):
        assert np.array_equal(a, b)
    torch.testing.assert_close(gpu.last_logits.cpu(), cpu.last_logits, rtol=1e-5, atol=1e-5)
    assert gpu.driver.stats == cpu.driver.stats


@pytest.mark.parametrize("s", [64, 192])  # the sequential mLSTM prefill, then the chunked one
def test_reduced_xlstm_on_the_card_like_the_cpu(cuda, s, monkeypatch):
    """The reduced xlstm_125m (f32, TF32 off): prefill and 4 decode steps in
    lockstep; tokens equal, logits and every layer's cache within 1e-5."""
    import copy

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.configs.smoke import reduce
    from repro_torch.models import lm

    _no_tf32(monkeypatch)
    cfg = reduce(get_config("xlstm_125m"))
    cpu_model = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    prompt = torch.from_numpy(np.random.default_rng(s).integers(0, cfg.vocab_size, (2, s)))
    g = lm.prefill(gpu_model, prompt.to(cuda), cfg, s + 4)
    c = lm.prefill(cpu_model, prompt, cfg, s + 4)
    for pos in range(s, s + 5):
        torch.testing.assert_close(g[0].cpu(), c[0], rtol=1e-5, atol=1e-5)
        for gl, cl in zip(g[1], c[1]):
            assert set(gl) == set(cl)
            for k in gl:
                torch.testing.assert_close(gl[k].cpu(), cl[k], rtol=1e-5, atol=1e-5)
        if pos == s + 4:
            break
        tok = c[0].argmax(-1)[:, None]
        assert torch.equal(g[0].argmax(-1).cpu(), tok[:, 0])
        g = lm.decode_step(gpu_model, g[1], tok.to(cuda), pos, cfg)
        c = lm.decode_step(cpu_model, c[1], tok, pos, cfg)


# -- captured programs: the megastep and the decode step as CUDA graphs ------------


def _graph_drain(dev, huge, capture):
    """A seeded drain under writes and reads, blocking harvest, with the sync
    debug mode raising on every tick (captures included: they wait for
    nothing); returns the driver and the megastep's captures, replays and
    the kernels' launches during the drain."""
    import contextlib

    import numpy as np

    from repro_torch.core import graphs, migrator

    drv, data = _driver(dev, 256, 320, np.zeros(256, np.int32), dict(
        initial_area_blocks=16, budget_blocks_per_tick=32, max_attempts_before_force=2,
        tiering=True), huge=huge)
    if huge > 1:
        assert drv.adopt_huge(np.arange(256 // huge)) == 256 // huge
    prog = migrator.MEGASTEP
    before = (prog.captures, prog.replays, leap_copy.copy_blocks.launches,
              leap_copy.copy_runs.launches, heat_scan.heat_scan.launches)
    s = drv.default_session()
    s.leap(np.arange(256), 1)
    gen = torch.Generator().manual_seed(1)
    with contextlib.nullcontext() if capture else graphs.disable_capture():
        while not drv.done:
            torch.cuda.set_sync_debug_mode("error")
            try:
                s.tick()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            s.poll(block=True)
            ids = torch.randperm(256, generator=gen)[:12]
            drv.write(ids, torch.randn((12, 2, 64), generator=gen).to(dev))
            drv.read(torch.randperm(256, generator=gen)[:8])
        assert s.drain()
    after = (prog.captures, prog.replays, leap_copy.copy_blocks.launches,
             leap_copy.copy_runs.launches, heat_scan.heat_scan.launches)
    return drv, [b - a for a, b in zip(before, after)]


@pytest.mark.parametrize("huge", [1, 4])
def test_graphed_megastep_drain_matches_eager(cuda, huge):
    """Every megastep of the drain is one graph replay; pool, table, flags
    and heat equal the eager drain's bit for bit, and the kernels' launch
    counters advance by the same counts."""
    import numpy as np

    g, (captures, replays, *g_launches) = _graph_drain(cuda, huge, True)
    e, (e_captures, e_replays, *e_launches) = _graph_drain(cuda, huge, False)
    assert replays == g.stats.dispatches == g.stats.ticks > 0 and 0 < captures <= replays
    assert e_captures == e_replays == 0
    for a, b in zip(g.state.to_numpy(), e.state.to_numpy()):
        assert (a == b).all()
    assert np.array_equal(g.heat_snapshot(), e.heat_snapshot())
    assert g_launches == e_launches and g_launches[1 if huge > 1 else 0] > 0
    assert g.stats.dirty_rejections == e.stats.dirty_rejections > 0


def test_graphed_verdict_survives_the_next_replay(cuda):
    """A verdict of one replay, in its ``VerdictFuture``, is unchanged after
    the next replay of the same graph reuses the static buffers."""
    import numpy as np

    from repro_torch.core import LeapState, migrator
    from repro_torch.core.queues import VerdictFuture

    state = LeapState.from_numpy(
        np.zeros((2, 16, 4), np.float32), np.stack([np.zeros(8), np.arange(8)], 1).astype(np.int32),
        np.zeros(8, bool), np.ones(8, bool), cuda)
    empty, ids = torch.zeros(0, dtype=torch.int64), torch.arange(4)
    replays = migrator.MEGASTEP.replays
    futures = []
    for dirty in ([0, 2], [1, 3], [0, 1, 2, 3]):
        state.dirty.zero_()
        state.dirty[torch.tensor(dirty, device=cuda)] = True
        _, verdict, _, _ = migrator.megastep(
            state, ids, torch.ones(4, dtype=torch.int64), ids + 8, *([empty] * 12),
            torch.zeros(0), empty, torch.zeros(0))
        futures.append(VerdictFuture(verdict))
    assert migrator.MEGASTEP.replays == replays + 3
    assert [f.result().tolist() for f in futures] == [
        [True, False, True, False], [False, True, False, True], [True] * 4]


def test_failed_capture_raises_and_the_next_capture_works(cuda):
    """A program that makes the host wait cannot be captured: the call
    raises, nothing runs eagerly in its place, and a later capture works."""
    from repro_torch.core import graphs

    x = torch.zeros(4, device=cuda)
    prog = graphs.Program("probe")

    def waits(v):
        x.add_(v)
        return x.sum().item()  # a device-to-host copy: not capturable

    with pytest.raises(RuntimeError):
        prog("k", waits, [torch.ones(4)], [x])
    torch.cuda.synchronize()
    assert prog.captures == prog.replays == 0 and (x == 0).all()
    out = prog("k2", lambda v: x.add_(v).sum(), [torch.ones(4)], [x])
    out = prog("k2", lambda v: x.add_(v).sum(), [torch.full((4,), 2.0)], [x])
    assert float(out) == 12.0 and prog.captures == 1 and prog.replays == 2


def test_graph_captures_again_over_other_tensors(cuda):
    """Two drivers over equal shapes: the second registers no variant (no
    miss, as in the JAX package) but captures its own graphs, and each
    drain reads back what was written."""
    import numpy as np

    from repro_torch.core import migrator

    runs = []
    for _ in range(2):
        drv, data = _driver(cuda, 64, 128, np.zeros(64, np.int32), dict(initial_area_blocks=8))
        variants, captures = len(migrator.MEGASTEP), migrator.MEGASTEP.captures
        s = drv.default_session()
        s.leap(np.arange(64), 1)
        assert s.drain()
        assert torch.equal(drv.read(torch.arange(64), note=False).cpu(), data)
        runs.append((len(migrator.MEGASTEP) - variants, migrator.MEGASTEP.captures - captures,
                     drv.stats.jit_cache_misses))
        del drv
    (v1, c1, m1), (v2, c2, m2) = runs
    assert v1 == m1 and v2 == m2 == 0 and c2 >= 1


def test_graphed_decode_matches_eager(cuda, monkeypatch):
    """The reduced two-layer granite (f32, TF32 off) under a live rebalance:
    every decode step is one replay of its batch size's graph, and tokens,
    last logits, pool and flags equal the eager engine's bit for bit, with
    one paged-decode launch per layer and step either way."""
    import contextlib
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.configs.smoke import reduce
    from repro_torch.core import LeapConfig, graphs
    from repro_torch.models import lm
    from repro_torch.serving.engine import PagedConfig, PagedEngine

    _no_tf32(monkeypatch)
    cfg = dataclasses.replace(reduce(get_config("granite_3_2b")), n_layers=2)
    model = lm.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 12)]
    pcfg = PagedConfig(block_tokens=4, max_blocks_per_seq=16, n_regions=2, slots_per_region=64,
                       leap=LeapConfig(initial_area_blocks=2, budget_blocks_per_tick=2,
                                       tiering=True))
    out = {}
    for capture in (True, False):
        eng = PagedEngine(cfg, model, pcfg, device=cuda)
        sids = [eng.admit(p, region=0) for p in prompts]
        eng.rebalance(sids[0], dst_region=1)
        before = paged_attn.paged_decode.launches
        with contextlib.nullcontext() if capture else graphs.disable_capture():
            for k in (3, 3, 2, 3, 3, 2):
                eng.tick()
                eng.session.poll(block=True)
                eng.decode(sids[:k])
            assert eng.drain()
        assert paged_attn.paged_decode.launches - before == 6 * cfg.n_layers
        prog = eng._decode_step
        assert (prog.replays, prog.captures, len(prog)) == ((6, 2, 2) if capture else (0, 0, 0))
        out[capture] = ([eng.seqs[s].tokens for s in sids], eng.last_logits,
                        eng.driver.state.to_numpy())
    (gt, gl, gs), (et, el, es) = out[True], out[False]
    assert gt == et and torch.equal(gl, el)
    for a, b in zip(gs, es):
        assert (a == b).all()


def _program_drain(dev, cfg_kw, capture, n_regions=2):
    """A seeded drain (every region's blocks to the next region) under
    writes and reads, blocking harvest, sync debug mode raising on every
    tick; returns the driver and every migration program's captures and
    replays during it."""
    import contextlib

    import numpy as np

    from repro_torch.core import (LeapConfig, MigrationDriver, PoolConfig, graphs, init_state,
                                  leap_write, make_region_mesh, migrator, state_sharding)

    n, slots = 256, 320 if n_regions == 2 else 96
    mesh = make_region_mesh(n_regions, [dev] * n_regions) if n_regions > 2 else None
    pc = PoolConfig(n_regions, slots, (2, 64), region_axis="data" if mesh else None)
    place = (np.arange(n) * n_regions // n).astype(np.int32)
    gen = torch.Generator().manual_seed(3)
    state = init_state(pc, n, place, device=dev)
    if mesh is not None:
        state = state.to(state_sharding(pc, mesh))
    leap_write(state, torch.arange(n), torch.randn((n, 2, 64), generator=gen).to(dev))
    drv = MigrationDriver(state, pc, LeapConfig(**cfg_kw), mesh=mesh)
    progs = migrator.PROGRAMS.values()
    before = (sum(p.captures for p in progs), sum(p.replays for p in progs))
    s = drv.default_session()
    for r in range(n_regions):
        s.leap(np.nonzero(place == r)[0], (r + 1) % n_regions)
    with contextlib.nullcontext() if capture else graphs.disable_capture():
        while not drv.done:
            torch.cuda.set_sync_debug_mode("error")
            try:
                s.tick()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            s.poll(block=True)
            ids = torch.randperm(n, generator=gen)[:12]
            drv.write(ids, torch.randn((12, 2, 64), generator=gen).to(dev))
            drv.read(torch.randperm(n, generator=gen)[:8])
        assert s.drain()
    after = (sum(p.captures for p in progs), sum(p.replays for p in progs))
    return drv, [b - a for a, b in zip(before, after)]


@pytest.mark.parametrize("mode", ["batched", "legacy", "ppermute", "legacy_ppermute"])
def test_graphed_program_drain_matches_eager(cuda, mode):
    """Under the batched and legacy generations and the ppermute backend,
    every program of the drain is one graph replay, and pool, table, flags
    and heat equal the eager drain's bit for bit."""
    import numpy as np

    kw = dict(initial_area_blocks=16, budget_blocks_per_tick=32, max_attempts_before_force=2,
              chunk_blocks=4, tiering=True,
              fused_dispatch="legacy" if mode.startswith("legacy") else "batched")
    regions = 2
    if mode.endswith("ppermute"):
        kw.update(backend="ppermute", axis_name="data")
        regions = 4
    g, (captures, replays) = _program_drain(cuda, kw, True, regions)
    e, (e_captures, e_replays) = _program_drain(cuda, kw, False, regions)
    assert replays == g.stats.dispatches > g.stats.ticks and 0 < captures <= replays
    assert e_captures == e_replays == 0
    for a, b in zip(g.state.to_numpy(), e.state.to_numpy()):
        assert (a == b).all()
    assert np.array_equal(g.heat_snapshot(), e.heat_snapshot())
    import dataclasses

    assert dataclasses.replace(g.stats, jit_cache_misses=0) == dataclasses.replace(
        e.stats, jit_cache_misses=0)
    assert g.stats.dirty_rejections > 0


def test_graphed_force_pins_no_payload(cuda):
    """A captured ``force_areas`` moves its payload with one K1 launch and
    reserves no payload-sized temporary: its graph's memory pool stays far
    below the lanes' bytes (2,048 lanes of 64 KiB: 128 MiB)."""
    import numpy as np

    from repro_torch.core import LeapState, migrator

    n, slots = 2048, 4096
    pool = np.random.default_rng(0).normal(size=(2, slots, 1, 16384)).astype(np.float32)
    table = np.stack([np.zeros(n), np.arange(n)], 1).astype(np.int32)
    state = LeapState.from_numpy(pool, table, np.zeros(n, bool), np.zeros(n, bool), cuda)
    ids = torch.arange(n)
    dst = torch.arange(slots - n, slots)
    def graph_pools():
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))

    migrator.PROGRAMS["force_areas"].clear()
    before = leap_copy.copy_blocks.launches, graph_pools()
    migrator.force_areas(state, ids, torch.ones(n, dtype=torch.int64), dst)
    torch.cuda.synchronize()
    assert leap_copy.copy_blocks.launches == before[0] + 1
    assert migrator.PROGRAMS["force_areas"].captures >= 1
    assert torch.equal(state.pool[1, slots - n:].cpu(), torch.from_numpy(pool[0, :n]))
    assert graph_pools() - before[1] < 32 * 2**20
