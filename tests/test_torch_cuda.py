"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``gpu`` and skips without a CUDA device.  The file
imports neither JAX nor the JAX package, so on a machine with a card and no
JAX it runs on its own (the suite's ``conftest.py`` imports JAX)::

    python -m pytest -q -p no:cacheprovider --noconftest -m gpu tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import heat_scan, leap_copy, lru_scan, ops, paged_attn, ref  # noqa: E402

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
@pytest.mark.parametrize("g", [1, 4, 7])
@pytest.mark.parametrize("hd", [16, 64, 128])
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
