"""The forward LRU-scan kernel's launch plan (``kernels/lru_scan.py``
``plan_lru_scan``), on the CPU: no kernel runs.

The plan is plain Python that the wrapper hands to the CUDA kernel, so its
arithmetic is held here: every (batch, channel) covered exactly once, the
ring within a block's 227 KB of shared memory, enough bytes in flight to
fill an SM, the copy route by alignment, one repeatable plan, and a
refusal for what the kernel does not take.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import lru_scan  # noqa: E402

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
