"""The LRU-scan kernels' launch plans (``kernels/lru_scan.py``
``plan_lru_scan`` and ``plan_lru_scan_bwd``), on the CPU: no kernel runs.

The plans are plain Python that the wrappers hand to the CUDA kernels, so
their arithmetic is held here: every (batch, channel) covered exactly once,
the ring within a block's 227 KB of shared memory, enough bytes in flight
to fill an SM, the copy route by alignment, one repeatable plan, and a
refusal for what the kernel does not take.  For the backward also every
time row once, in reverse, h's box one row down, and a plain-Python model
of the kernel's walk (tiles, the ragged stage first, the ring's slots, the
shifted h box, the carry) against ``ref.lru_scan_bwd_ref``, bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import lru_scan, ref  # noqa: E402

N_SM = 132  # an H100 SXM
SHAPES = {  # name -> (b, t, r)
    "prefill_32k": (1, 32768, 4096),  # chip_smoke.py phase 34
    "prefill_8x2048": (8, 2048, 4096),  # phases 8 and 9
    "train_4x2048": (4, 2048, 4096),  # phase 28
    "reduced": (2, 64, 128),  # the reduced config's lru_width
    "ragged_33": (3, 17, 33),
    "ragged_50": (2, 1, 50),
    "ragged_96": (2, 17, 96),
}
ITEMSIZES = {"f32": 4, "bf16": 2}


def _coverage(plan):
    """(batch, channel) -> how many CTA tiles cover it."""
    seen = {}
    for cta in range(plan.grid):
        for tile in plan.tiles_of(cta):
            batch, chans = plan.channels_of(tile)
            for ch in chans:
                seen[(batch, ch)] = seen.get((batch, ch), 0) + 1
    return seen


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_covers_every_channel_once_and_fits(shape, dtype):
    b, t, r = SHAPES[shape]
    plan = lru_scan.plan_lru_scan(b, t, r, ITEMSIZES[dtype], N_SM)
    seen = _coverage(plan)
    assert len(seen) == b * r and set(seen.values()) == {1}
    assert set(seen) == {(i, ch) for i in range(b) for ch in range(r)}
    assert [len(plan.tiles_of(c)) for c in range(plan.grid)] == sorted(
        (len(plan.tiles_of(c)) for c in range(plan.grid)), reverse=True)  # an even split
    assert sum(len(plan.tiles_of(c)) for c in range(plan.grid)) == plan.tiles
    assert plan.smem_bytes <= lru_scan.MAX_SMEM
    assert plan.smem_bytes >= lru_scan.SMEM_ALIGN + plan.stages * plan.slot_bytes
    assert plan.slot_bytes % (2 * lru_scan.SMEM_ALIGN) == 0
    assert 1 <= plan.rows <= min(t, lru_scan.MAX_ROWS)
    assert plan.steps * plan.rows >= t > (plan.steps - 1) * plan.rows
    assert plan.channels in lru_scan.CHANNEL_CHOICES and plan.warps * 32 == plan.channels
    assert plan.grid <= min(plan.tiles, N_SM)


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_keeps_enough_bytes_in_flight(shape, dtype):
    """At least 32 KiB of a and b in flight an SM on the tma route, unless a
    CTA's whole walk reads less than that."""
    b, t, r = SHAPES[shape]
    plan = lru_scan.plan_lru_scan(b, t, r, ITEMSIZES[dtype], N_SM)
    walk = -(-plan.tiles // plan.grid) * plan.steps * 2 * plan.tile_bytes
    if plan.route == "tma":
        assert plan.in_flight_per_sm >= min(32768, walk)
    else:
        assert plan.in_flight_per_sm == min(1, plan.steps) * 2 * plan.tile_bytes


def test_plan_at_the_long_context_shapes():
    """Batch 1 fills at least 128 SMs, and the batch-8 and batch-4 shapes
    run in one wave of one CTA an SM (no ragged second wave)."""
    one = lru_scan.plan_lru_scan(1, 32768, 4096, 4, N_SM)
    assert one.sms >= 128 and one.channels == 32 and one.route == "tma"
    assert one.in_flight_per_sm >= 32768
    assert one.ctas_per_sm == 1  # the ring is over half an SM's shared memory
    for b in (8, 4):
        plan = lru_scan.plan_lru_scan(b, 2048, 4096, 4, N_SM)
        assert plan.grid == plan.tiles == 128 and plan.ctas_per_sm == 1
        assert plan.sms >= 128
    bf16 = lru_scan.plan_lru_scan(1, 32768, 4096, 2, N_SM)
    assert bf16.sms >= 128 and bf16.in_flight_per_sm >= 32768


@pytest.mark.parametrize(
    "r, itemsize, aligned, route",
    [
        (4096, 4, True, "tma"),
        (100, 4, True, "tma"),  # 400-byte rows: a ragged group, rows on 16 bytes
        (33, 4, True, "narrow"),  # 132-byte rows
        (50, 4, True, "narrow"),  # 200-byte rows
        (33, 2, True, "narrow"),  # 66-byte rows
        (96, 2, True, "tma"),  # 192-byte rows
        (100, 2, True, "narrow"),  # 200-byte rows
        (4096, 4, False, "narrow"),  # an operand off 16 bytes
    ],
)
def test_plan_copy_route(r, itemsize, aligned, route):
    plan = lru_scan.plan_lru_scan(2, 40, r, itemsize, N_SM, aligned=aligned)
    assert plan.route == route


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_repeats(shape):
    b, t, r = SHAPES[shape]
    plans = [lru_scan.plan_lru_scan(b, t, r, 4, N_SM) for _ in range(3)]
    assert plans[0] == plans[1] == plans[2]
    assert plans[0].describe() == plans[2].describe()


@pytest.mark.parametrize(
    "args, kw",
    [
        ((0, 8, 64, 4, N_SM), {}),
        ((1, 0, 64, 4, N_SM), {}),
        ((1, 8, 0, 4, N_SM), {}),
        ((1, 8, 64, 8, N_SM), {}),  # float64
        ((1, 8, 64, 1, N_SM), {}),
        ((1, 8, 64, 4, 0), {}),
        ((1, 2**31, 64, 4, N_SM), {}),  # past a tensor-map coordinate
        ((1, 8, 64, 4, N_SM), dict(channels=48)),
        ((1, 8, 64, 4, N_SM), dict(rows=0)),
        ((1, 512, 64, 4, N_SM), dict(rows=257)),
        ((1, 8, 64, 4, N_SM), dict(stages=2)),  # the tma route needs 3
        ((1, 8, 64, 4, N_SM), dict(stages=lru_scan.MAX_STAGES + 1)),
        ((1, 4096, 4096, 4, N_SM), dict(channels=256, rows=256, stages=4)),  # 2 MiB of ring
    ],
)
def test_plan_refuses_what_the_kernel_does_not_take(args, kw):
    with pytest.raises(ValueError):
        lru_scan.plan_lru_scan(*args, **kw)


def test_plan_overrides_and_one_shot_grid():
    base = lru_scan.plan_lru_scan(8, 2048, 4096, 4, N_SM)
    narrow = lru_scan.plan_lru_scan(8, 2048, 4096, 4, N_SM, aligned=False, stages=2)
    assert narrow.route == "narrow" and narrow.stages == 2
    one_shot = lru_scan.plan_lru_scan(8, 2048, 4096, 4, N_SM, channels=32, persistent=False)
    assert one_shot.grid == one_shot.tiles == 8 * 128
    assert all(len(one_shot.tiles_of(c)) == 1 for c in range(0, one_shot.grid, 97))
    walk = lru_scan.plan_lru_scan(8, 2048, 4096, 4, N_SM, channels=32)
    assert walk.grid == N_SM and max(len(walk.tiles_of(c)) for c in range(walk.grid)) == 8
    assert set(_coverage(walk).values()) == {1}
    assert dataclasses.replace(base, stages=6).smem_bytes > base.smem_bytes


def test_cpu_tensors_take_the_plain_version_and_plan_nothing():
    g = torch.Generator().manual_seed(0)
    a = torch.sigmoid(torch.randn((2, 9, 40), generator=g))
    x = torch.randn((2, 9, 40), generator=g)
    h0 = torch.randn((2, 40), generator=g)
    before = (lru_scan.lru_scan.launches, lru_scan.lru_scan.last_plan)
    lru_scan.lru_scan(a, x, h0)
    assert (lru_scan.lru_scan.launches, lru_scan.lru_scan.last_plan) == before


# -- the backward's plan ----------------------------------------------------------

BWD_SHAPES = {  # name -> (b, t, r): where the main paths launch the backward
    "tp_position": (1, 1024, 2048),  # phase 40(b), 4 x 2: a position's channels
    "tp_group": (1, 1024, 4096),  # phase 40(b), 4 x 1
    "train_4x2048": (4, 2048, 4096),  # phases 28-29
    "timed_8x2048": (8, 2048, 4096),  # phase 26's timed shape
}
BWD_GRIDS = {  # name -> (CTAs, channels a CTA)
    "tp_position": (64, 32), "tp_group": (128, 32), "train_4x2048": (128, 128),
    "timed_8x2048": (128, 256),
}
RAGGED = {"ragged_33": (3, 17, 33), "ragged_50": (2, 1, 50), "ragged_96": (2, 17, 96),
          "reduced": (2, 64, 128)}


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("shape", list(BWD_SHAPES) + list(RAGGED))
def test_bwd_plan_covers_every_channel_once_and_every_row_once_in_reverse(shape, dtype):
    b, t, r = {**BWD_SHAPES, **RAGGED}[shape]
    plan = lru_scan.plan_lru_scan_bwd(b, t, r, ITEMSIZES[dtype], N_SM)
    assert isinstance(plan, lru_scan.LruBwdPlan) and plan.boxes == 3
    seen = _coverage(plan)
    assert len(seen) == b * r and set(seen.values()) == {1}
    assert plan.grid == min(plan.tiles, N_SM)
    walked = []
    for step in range(plan.steps):
        t0, rows = plan.stage(step)
        assert t0 % plan.rows == 0 and 1 <= rows <= plan.rows
        walked += range(t0 + rows - 1, t0 - 1, -1)  # a thread's chain runs down the stage
    assert walked == list(range(t - 1, -1, -1))
    assert plan.stage(0)[1] == t - (plan.steps - 1) * plan.rows  # the ragged stage first
    assert plan.stage(plan.steps - 1)[0] == 0
    for step in (-1, plan.steps):
        with pytest.raises(ValueError):
            plan.stage(step)


@pytest.mark.parametrize("shape", list(BWD_SHAPES) + list(RAGGED))
def test_bwd_h_box_starts_one_row_below_t0(shape):
    plan = lru_scan.plan_lru_scan_bwd(*{**BWD_SHAPES, **RAGGED}[shape], 4, N_SM)
    for step in range(plan.steps):
        assert plan.h_box_start(step) == plan.stage(step)[0] - 1
    assert plan.h_box_start(plan.steps - 1) == -1  # the last stage's box starts before t = 0


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
@pytest.mark.parametrize("shape", list(BWD_SHAPES))
def test_bwd_plan_at_the_main_paths_shapes(shape, dtype):
    """The grids the design expects, 4 stages of three 16 KiB boxes within
    227 KB, and at least 64 KiB of g, a and h in flight an SM."""
    b, t, r = BWD_SHAPES[shape]
    plan = lru_scan.plan_lru_scan_bwd(b, t, r, ITEMSIZES[dtype], N_SM)
    assert (plan.grid, plan.channels) == BWD_GRIDS[shape]
    assert plan.route == "tma" and plan.stages == lru_scan.STAGES
    assert plan.tile_bytes == 16384 and plan.slot_bytes == 3 * 16384
    assert plan.smem_bytes == lru_scan.SMEM_ALIGN + 4 * (3 * 16384 + 8) <= lru_scan.MAX_SMEM
    assert plan.ctas_per_sm == 1 and plan.in_flight_per_sm >= 65536
    assert plan.in_flight_per_sm == (plan.stages - 2) * 3 * plan.tile_bytes


@pytest.mark.parametrize(
    "r, itemsize, aligned, route",
    [(4096, 4, True, "tma"), (100, 4, True, "tma"), (97, 4, True, "narrow"),
     (33, 2, True, "narrow"), (96, 2, True, "tma"), (4096, 4, False, "narrow")],
)
def test_bwd_plan_copy_route(r, itemsize, aligned, route):
    plan = lru_scan.plan_lru_scan_bwd(2, 40, r, itemsize, N_SM, aligned=aligned)
    assert plan.route == route
    assert plan == lru_scan.plan_lru_scan_bwd(2, 40, r, itemsize, N_SM, aligned=aligned)


@pytest.mark.parametrize(
    "args, kw",
    [
        ((0, 8, 64, 4, N_SM), {}),
        ((1, 8, 64, 8, N_SM), {}),  # float64
        ((1, 2**31, 64, 4, N_SM), {}),  # past a tensor-map coordinate
        ((2**31, 8, 64, 4, N_SM), {}),
        ((1, 8, 64, 4, N_SM), dict(channels=16)),
        ((1, 512, 64, 4, N_SM), dict(rows=257)),
        ((1, 8, 64, 4, N_SM), dict(stages=2)),  # the tma route needs 3
        ((1, 4096, 4096, 4, N_SM), dict(rows=128, stages=5)),  # 5 x 48 KiB
        ((1, 4096, 4096, 4, N_SM), dict(channels=256, rows=64)),  # 4 x 192 KiB
    ],
)
def test_bwd_plan_refuses_what_the_kernel_does_not_take(args, kw):
    with pytest.raises(ValueError):
        lru_scan.plan_lru_scan_bwd(*args, **kw)


def test_plans_take_a_batch_past_65535_and_allocate_nothing():
    """The grid is one CTA an SM, so no grid dimension bounds B: both plans
    take 70,000 rows, and the operand check passes on ``meta`` tensors."""
    for plan_fn in (lru_scan.plan_lru_scan, lru_scan.plan_lru_scan_bwd):
        plan = plan_fn(70000, 8, 64, 4, N_SM)
        assert plan.grid == N_SM and plan.tiles == 70000 * 64 // plan.channels
        assert sum(len(plan.tiles_of(c)) for c in (0, N_SM - 1)) >= 2 * (plan.tiles // N_SM)
    a = torch.empty((70000, 8, 64), device="meta")
    lru_scan._check_operands(a, a, torch.empty((70000, 64), device="meta"))


def _box(x, batch, t_start, c0, rows, channels):
    """A tensor-map box of ``x [B, T, R]``: rows from ``t_start`` (negative
    allowed), channels from ``c0``; what lies outside the tensor reads 0."""
    out = np.zeros((rows, channels), np.float32)
    _, t, r = x.shape
    lo, hi = max(t_start, 0), min(t_start + rows, t)
    if hi > lo:
        width = min(channels, r - c0)
        out[lo - t_start:hi - t_start, :width] = x[batch, lo:hi, c0:c0 + width]
    return out


def _walk_model(plan, g, a, h, h0):
    """The backward kernel's tma walk in plain Python, float32 by float32:
    each CTA issues stage j + stages - 2 into its ring before it computes
    stage j; a slot holds g's and a's boxes at t0 and h's at t0 - 1; each
    channel runs down the stage's rows with lambda and a_{t+1} carried
    across stages, writes db over g's box and da over h's, and the two
    boxes are stored at t0 (nothing outside the tensor).  Returns da, db,
    dh0 and how many times each element was written."""
    b, t, r = g.shape
    da, db = np.full(g.shape, np.nan, np.float32), np.full(g.shape, np.nan, np.float32)
    dh0 = np.full((b, r), np.nan, np.float32)
    writes = np.zeros(g.shape, np.int64)
    ahead = plan.stages - 2
    for cta in range(plan.grid):
        walk = [(tile, step) for tile in plan.tiles_of(cta) for step in range(plan.steps)]
        ring = [None] * plan.stages

        def issue(j):
            tile, step = walk[j]
            batch, chans = plan.channels_of(tile)
            t0, _ = plan.stage(step)
            boxes = [_box(x, batch, start, chans.start, plan.rows, plan.channels)
                     for x, start in ((g, t0), (a, t0), (h, plan.h_box_start(step)))]
            ring[j % plan.stages] = (j, boxes)

        for j in range(min(ahead, len(walk))):
            issue(j)
        lam = a_next = None
        for j, (tile, step) in enumerate(walk):
            if j + ahead < len(walk):
                issue(j + ahead)
            tag, (sg, sa, sh) = ring[j % plan.stages]
            assert tag == j  # the slot holds this stage, not one issued over it
            batch, chans = plan.channels_of(tile)
            t0, rows = plan.stage(step)
            if step == 0:
                lam = np.zeros(plan.channels, np.float32)
                a_next = np.zeros(plan.channels, np.float32)
            for k in range(rows - 1, -1, -1):
                hv = h0[batch, chans.start:chans.start + plan.channels] if t0 + k == 0 else sh[k]
                hv = np.pad(hv, (0, plan.channels - hv.shape[0]))
                lam = (sg[k] + a_next * lam).astype(np.float32)
                sg[k], sh[k] = lam, (lam * hv).astype(np.float32)
                a_next = sa[k].copy()
            width, live = len(chans), slice(chans.start, chans.stop)
            top = min(t0 + plan.rows, t)
            db[batch, t0:top, live] = sg[:top - t0, :width]
            da[batch, t0:top, live] = sh[:top - t0, :width]
            writes[batch, t0:top, live] += 1
            if step == plan.steps - 1:
                dh0[batch, live] = (a_next * lam)[:width]
    return da, db, dh0, writes


@pytest.mark.parametrize(
    "shape, kw",
    [
        ((3, 17, 33), dict(rows=5)),  # 17 = 3 x 5 + 2: the ragged stage walked first
        ((3, 17, 33), dict(rows=5, stages=3)),
        ((2, 1, 50), {}),  # one row: h's box wholly before t = 0
        ((2, 23, 96), dict(rows=8, channels=64)),  # a ragged channel group
        ((2, 40, 96), dict(rows=7, stages=6)),
        ((3, 300, 64), {}),  # 300 = 2 x 128 + 44
        ((1, 9, 160), dict(rows=1)),  # a stage a row
    ],
)
def test_bwd_walk_model_matches_plain_bit_for_bit(shape, kw):
    rng = np.random.default_rng(sum(shape))
    b, t, r = shape
    a = (1.0 / (1.0 + np.exp(-(rng.normal(size=shape) + 2.0)))).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    h0 = rng.normal(size=(b, r)).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    h = ref.lru_scan_ref(*(torch.from_numpy(v) for v in (a, x, h0))).numpy()
    plan = lru_scan.plan_lru_scan_bwd(b, t, r, 4, N_SM, **kw)
    da, db, dh0, writes = _walk_model(plan, g, a, h, h0)
    assert (writes == 1).all()
    want = ref.lru_scan_bwd_ref(*(torch.from_numpy(v) for v in (g, a, h, h0)))
    for got, w in zip((da, db, dh0), want):
        assert np.array_equal(got.view(np.int32), w.numpy().view(np.int32))


def test_cpu_tensors_take_the_plain_backward_and_plan_nothing():
    g = torch.Generator().manual_seed(1)
    a = torch.sigmoid(torch.randn((2, 9, 40), generator=g))
    gy, h = torch.randn((2, 9, 40), generator=g), torch.randn((2, 9, 40), generator=g)
    h0 = torch.randn((2, 40), generator=g)
    before = (lru_scan.lru_scan_bwd.launches, lru_scan.lru_scan_bwd.last_plan)
    got = lru_scan.lru_scan_bwd(gy, a, h, h0)
    assert (lru_scan.lru_scan_bwd.launches, lru_scan.lru_scan_bwd.last_plan) == before
    for k, w in zip(got, ref.lru_scan_bwd_ref(gy, a, h, h0)):
        assert torch.equal(k, w)
