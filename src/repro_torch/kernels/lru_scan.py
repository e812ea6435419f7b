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

:func:`plan_lru_scan` is the forward kernel's launch plan, plain Python:
channel groups (one thread a channel, a warp per 32 channels), the time
rows a shared-memory stage holds, the stage count of the ring, the grid and
the copy route.  The wrapper plans every launch with it and hands the
plan's numbers to the C entry point, which checks them again.

``lru_scan_bwd`` wraps the backward of the same source,
``leap_lru_scan_bwd``: the reverse-time adjoint scan, which the JAX package
gets from autodiff of its scan and has no kernel for.  It runs the
forward's design walked backwards through time, with a plan of its own,
:func:`plan_lru_scan_bwd` (three boxes a stage: g, a and h one row down).
:class:`LruScan`, an autograd Function, joins the two: forward the forward
kernel, backward the backward kernel, and on CPU tensors the plain versions
of both.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# -- the forward kernel's plan (mirrors csrc/lru_scan.cu) ------------------------

CHANNEL_CHOICES = (32, 64, 128, 256)  # channels a CTA: one to eight warps
STAGE_BYTES = 32768  # a and b bytes a stage aims at
BWD_STAGE_BYTES = 49152  # g, a and h bytes a backward stage aims at: three 16 KiB boxes
STAGES = 4  # slots in the ring: two stages of a and b in flight, one computed, one stored
MAX_ROWS = 256  # a tensor-map box dimension
MAX_STAGES = 32
SMEM_ALIGN = 128  # the ring's start and each tile's stride
MAX_SMEM = 232448  # dynamic shared memory a block may opt in to (227 KB)
SM_SMEM = 233472  # shared memory of one SM (228 KB), 1 KB of it reserved per block
MAX_COORD = 2**31 - 1  # tensor-map coordinates are 32-bit signed


@dataclasses.dataclass(frozen=True)
class LruPlan:
    """How one launch of the forward kernel covers ``a, b [b, t, r]``.

    A tile is one (batch row, group of ``channels`` channels); CTA ``c`` of
    ``grid`` takes tiles ``tiles_of(c)``, an even split, and walks each
    through time ``rows`` rows a stage, ``stages`` stages of its ``boxes``
    inputs (a and b) in its shared-memory ring.  ``route`` is ``"tma"``
    (tensor-map copies in and out, 16-byte aligned operands and rows) or
    ``"narrow"`` (each thread loads its own channel's elements into the ring
    and stores its outputs)."""

    boxes: ClassVar[int] = 2  # input boxes a stage: a and b

    b: int
    t: int
    r: int
    itemsize: int
    n_sm: int
    channels: int
    rows: int
    stages: int
    grid: int
    route: str

    @property
    def warps(self) -> int:
        return self.channels // 32

    @property
    def groups(self) -> int:
        """Channel groups a batch row; the last one is ragged when r is not a
        multiple of ``channels``."""
        return -(-self.r // self.channels)

    @property
    def tiles(self) -> int:
        return self.b * self.groups

    @property
    def tile_bytes(self) -> int:
        """Bytes of one array's box in a stage (rows x channels)."""
        return self.rows * self.channels * self.itemsize

    @property
    def slot_bytes(self) -> int:
        """A stage's shared memory: the input boxes one after the other (a's
        then b's), each at a 128-byte stride."""
        return self.boxes * (-(-self.tile_bytes // SMEM_ALIGN) * SMEM_ALIGN)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory a CTA asks for: alignment slack, the ring, one
        8-byte barrier a stage (csrc/lru_scan.cu computes the same)."""
        return SMEM_ALIGN + self.stages * self.slot_bytes + 8 * self.stages

    @property
    def steps(self) -> int:
        """Stages a tile takes through time (the last may be ragged)."""
        return -(-self.t // self.rows)

    @property
    def ctas_per_sm(self) -> int:
        """CTAs of this launch resident on the busiest SM."""
        fit = min(SM_SMEM // (self.smem_bytes + 1024), 2048 // (32 * self.warps), 32)
        return max(1, min(fit, -(-self.grid // self.n_sm)))

    @property
    def sms(self) -> int:
        return min(self.grid, self.n_sm)

    @property
    def in_flight_per_cta(self) -> int:
        """Input bytes a CTA has requested ahead of the stage it computes: on
        the tma route ``stages - 2`` stages of every box (one more slot holds
        the stage whose output store may still read it), fewer when its
        whole walk is shorter; on the narrow route the one stage being
        loaded."""
        longest = -(-self.tiles // self.grid) * self.steps
        ahead = 1 if self.route == "narrow" else self.stages - 2
        return min(ahead, longest) * self.boxes * self.tile_bytes

    @property
    def in_flight_per_sm(self) -> int:
        return self.ctas_per_sm * self.in_flight_per_cta

    def tiles_of(self, cta: int) -> range:
        """The tiles CTA ``cta`` walks: the kernel's even split."""
        q, rem = divmod(self.tiles, self.grid)
        first = cta * q + min(cta, rem)
        return range(first, first + q + (1 if cta < rem else 0))

    def channels_of(self, tile: int) -> tuple[int, range]:
        """Tile ``tile``'s batch row and channels."""
        batch, group = divmod(tile, self.groups)
        lo = group * self.channels
        return batch, range(lo, min(lo + self.channels, self.r))

    def describe(self) -> dict:
        return dict(ctas=self.grid, sms=self.sms, channels_per_cta=self.channels,
                    warps=self.warps, rows=self.rows, stages=self.stages,
                    smem_bytes=self.smem_bytes, in_flight_per_sm=self.in_flight_per_sm,
                    tiles=self.tiles, route=self.route)


@dataclasses.dataclass(frozen=True)
class LruBwdPlan(LruPlan):
    """How one launch of the backward kernel covers ``g, a, h [b, t, r]``:
    the forward's tiles and ring, each tile walked from the top of time
    down.  A stage holds three boxes: g's and a's rows ``[t0, t0 + rows)``
    and h's one row lower, ``[t0 - 1, t0 + rows - 1)``, so that row ``k``
    of h's box is the ``h_{t-1}`` that ``da_t`` needs (at ``t0 = 0`` its row
    0 lies before the tensor: zero-filled, and the kernel takes h0).  The
    outputs go out over the inputs' places: db over g's box, da over h's."""

    boxes: ClassVar[int] = 3  # g, a and h

    def stage(self, step: int) -> tuple[int, int]:
        """Step ``step`` of a tile's walk (0 first): its first time row
        ``t0`` and its rows.  Stages lie on multiples of ``rows`` from t =
        0, so the ragged one, at the top of time, is walked first."""
        if not 0 <= step < self.steps:
            raise ValueError(f"step {step} is outside 0..{self.steps - 1}")
        t0 = (self.steps - 1 - step) * self.rows
        return t0, min(self.rows, self.t - t0)

    def h_box_start(self, step: int) -> int:
        """The time row h's box of step ``step`` starts at: one below t0."""
        return self.stage(step)[0] - 1


def _busiest_sm_channels(b: int, r: int, channels: int, n_sm: int) -> int:
    """Channels the busiest CTA of a one-CTA-an-SM grid walks: what a launch
    waits for, since every CTA moves the same bytes a channel."""
    tiles = b * -(-r // channels)
    return -(-tiles // min(tiles, n_sm)) * channels


def plan_lru_scan(b: int, t: int, r: int, itemsize: int, n_sm: int, *, aligned: bool = True,
                  channels: int | None = None, rows: int | None = None,
                  stages: int | None = None, persistent: bool = True) -> LruPlan:
    """The forward kernel's plan for ``a, b [b, t, r]`` of ``itemsize``-byte
    elements on a card of ``n_sm`` SMs; ``aligned`` says a, b and the output
    start on 16 bytes.

    Channels a CTA: of 32, 64, 128 and 256, the one whose busiest SM walks
    the fewest channels, the widest on a tie (so [1, 32768, 4096] takes 32:
    128 CTAs; [8, 2048, 4096] takes 256: 128 CTAs, one tile each).  Rows:
    a stage of about ``STAGE_BYTES`` of a and b, at most ``MAX_ROWS`` and
    ``t``.  Stages: ``STAGES`` (at least 3 on the tma route, 2 on the
    narrow; all must fit 227 KB of shared memory).  Grid: one CTA an SM
    (``persistent``), each walking an even split of the tiles, or one CTA
    a tile.  Route: ``"tma"`` when the operands and their rows (``r *
    itemsize``) sit on 16 bytes, else ``"narrow"``.  The keywords override
    the choices (``scripts/tune_lru.py`` times such variants).  Raises
    ``ValueError`` for what the kernel does not take."""
    return _plan(LruPlan, STAGE_BYTES, b, t, r, itemsize, n_sm, aligned=aligned,
                 channels=channels, rows=rows, stages=stages, persistent=persistent)


def plan_lru_scan_bwd(b: int, t: int, r: int, itemsize: int, n_sm: int, *,
                      aligned: bool = True, channels: int | None = None,
                      rows: int | None = None, stages: int | None = None,
                      persistent: bool = True) -> LruBwdPlan:
    """The backward kernel's plan for ``g, a, h [b, t, r]``: the forward's
    rules, with ``aligned`` saying that g, a, h, da and db start on 16
    bytes, and rows for a stage of about ``BWD_STAGE_BYTES`` of g, a and h
    (three boxes, so 4 stages fit 227 KB).  [1, 1024, 2048] runs 64 CTAs of
    32 channels, [1, 1024, 4096] 128 of 32, [4, 2048, 4096] 128 of 128 and
    [8, 2048, 4096] 128 of 256."""
    return _plan(LruBwdPlan, BWD_STAGE_BYTES, b, t, r, itemsize, n_sm, aligned=aligned,
                 channels=channels, rows=rows, stages=stages, persistent=persistent)


def _plan(cls, stage_bytes: int, b: int, t: int, r: int, itemsize: int, n_sm: int, *,
          aligned: bool, channels: int | None, rows: int | None, stages: int | None,
          persistent: bool):
    if itemsize not in (2, 4):
        raise ValueError(f"itemsize must be 4 (float32) or 2 (bfloat16), got {itemsize}")
    if not (b >= 1 and t >= 1 and r >= 1 and n_sm >= 1):
        raise ValueError(f"needs b, t, r and n_sm >= 1, got {(b, t, r, n_sm)}")
    if max(b, t, r) > MAX_COORD:
        raise ValueError(f"b, t and r must stay below 2**31 (tensor-map coordinates), "
                         f"got {(b, t, r)}")
    if channels is None:
        channels = min(CHANNEL_CHOICES,
                       key=lambda c: (_busiest_sm_channels(b, r, c, n_sm), -c))
    if channels not in CHANNEL_CHOICES:
        raise ValueError(f"channels must be one of {CHANNEL_CHOICES}, got {channels}")
    if rows is None:
        rows = min(max(1, stage_bytes // (cls.boxes * channels * itemsize)), MAX_ROWS, t)
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"rows must be in 1..{MAX_ROWS}, got {rows}")
    route = "tma" if aligned and (r * itemsize) % 16 == 0 else "narrow"
    slot = cls.boxes * (-(-rows * channels * itemsize // SMEM_ALIGN) * SMEM_ALIGN)
    if stages is None:
        stages = STAGES
    least = 3 if route == "tma" else 2
    if not least <= stages <= MAX_STAGES or SMEM_ALIGN + stages * (slot + 8) > MAX_SMEM:
        raise ValueError(f"{stages} stages of {slot} B do not fit {MAX_SMEM} B of shared "
                         f"memory ({least}..{MAX_STAGES} stages on the {route} route)")
    tiles = b * -(-r // channels)
    grid = min(tiles, n_sm) if persistent else tiles
    if grid > MAX_COORD:
        raise ValueError(f"a grid of {grid} CTAs is too large")
    return cls(b=b, t=t, r=r, itemsize=itemsize, n_sm=n_sm, channels=channels, rows=rows,
               stages=stages, grid=grid, route=route)


_SM_COUNT: dict[int, int] = {}  # device index -> SMs, read once per device


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device (``cudaDeviceGetAttribute``)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNT:
        n = _build.load().leap_sm_count(index)
        if n < 1:
            raise RuntimeError(f"leap_sm_count failed on cuda:{index}: CUDA error {-n}")
        _SM_COUNT[index] = n
    return _SM_COUNT[index]


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
    if not (bb >= 1 and t >= 1 and r >= 1):
        raise ValueError(f"needs B, T and R >= 1, got {tuple(a.shape)}")
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
    aligned = all(x.data_ptr() % 16 == 0 for x in (a, b, out))
    plan = plan_lru_scan(bb, t, r, a.element_size(), sm_count(a.device), aligned=aligned)
    with torch.cuda.device(a.device):
        err = launch(_build.load(), a, b, h0, out, plan)
    if err:
        raise RuntimeError(f"leap_lru_scan launch of {plan.describe()} failed: CUDA error {err}")
    lru_scan.launches += 1
    lru_scan.last_plan = plan
    return out


lru_scan.launches = 0  # kernel launches in this process (read by chip_smoke.py)
lru_scan.last_plan = None  # the plan of the latest launch


def launch(lib, a, b, h0, out, plan: LruPlan) -> int:
    """``leap_lru_scan`` of ``lib`` on checked operands, with ``plan``; the
    CUDA error it returns (0 on success).  Counts nothing: :func:`lru_scan`
    is the wrapper."""
    return lib.leap_lru_scan(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), plan.b, plan.t, plan.r,
        _DTYPES[a.dtype], plan.warps, plan.rows, plan.stages, plan.grid,
        1 if plan.route == "tma" else 0, torch.cuda.current_stream(a.device).cuda_stream,
    )


def lru_scan_bwd(g: torch.Tensor, a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor):
    """The scan's backward: ``g`` the gradient of ``h = lru_scan(a, b, h0)``,
    all ``[B, T, R]`` in ``a.dtype``.  Returns ``(da, db)`` in ``a.dtype`` and
    ``dh0 [B, R]`` fp32, with an fp32 carry (see ``csrc/lru_scan.cu``).  On
    CUDA every launch runs the plan :func:`plan_lru_scan_bwd` makes."""
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
    aligned = all(x.data_ptr() % 16 == 0 for x in (g, a, h, da, db))
    plan = plan_lru_scan_bwd(bb, t, r, a.element_size(), sm_count(a.device), aligned=aligned)
    with torch.cuda.device(a.device):
        err = launch_bwd(_build.load(), g, a, h, h0, da, db, dh0, plan)
    if err:
        raise RuntimeError(
            f"leap_lru_scan_bwd launch of {plan.describe()} failed: CUDA error {err}")
    lru_scan_bwd.launches += 1
    lru_scan_bwd.last_plan = plan
    return da, db, dh0


lru_scan_bwd.launches = 0  # kernel launches in this process (read by chip_smoke.py)
lru_scan_bwd.last_plan = None  # the plan of the latest launch


def launch_bwd(lib, g, a, h, h0, da, db, dh0, plan: LruBwdPlan) -> int:
    """``leap_lru_scan_bwd`` of ``lib`` on checked operands, with ``plan``;
    the CUDA error it returns (0 on success).  Counts nothing:
    :func:`lru_scan_bwd` is the wrapper."""
    return lib.leap_lru_scan_bwd(
        g.data_ptr(), a.data_ptr(), h.data_ptr(), h0.data_ptr(), da.data_ptr(), db.data_ptr(),
        dh0.data_ptr(), plan.b, plan.t, plan.r, _DTYPES[a.dtype], plan.warps, plan.rows,
        plan.stages, plan.grid, 1 if plan.route == "tma" else 0,
        torch.cuda.current_stream(a.device).cuda_stream,
    )


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
