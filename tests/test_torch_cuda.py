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
@pytest.mark.parametrize("g", [1, 4, 7, 16])  # both of the kernel's G bounds (4, 16)
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


def _split_lens(maxb, blk, b):
    """Lens on and around the kernel's split boundaries, 1 and MAXB * BLK."""
    split = paged_attn.SPLIT_TOKENS
    lens = [1, split - 1, split, split + 1, 2 * split, 3 * split + 1, maxb * blk]
    return torch.tensor((lens * b)[:b], dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128])
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
