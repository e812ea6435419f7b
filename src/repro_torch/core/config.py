"""Tuning knobs of the migration engine (`LeapConfig`).

Extracted from ``core/driver.py`` when the driver decomposed into the staged
pipeline (``repro.core.pipeline``); ``from repro.core.driver import
LeapConfig`` keeps working through the driver's re-export shim.
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels.ops import IMPLS


@dataclasses.dataclass(frozen=True)
class LeapConfig:
    """Tuning knobs of the migration engine (paper defaults in comments)."""

    initial_area_blocks: int = 64  # "initial area size" (16MB sweet spot)
    reduction_factor: int = 2  # split factor on dirty retry
    min_area_blocks: int = 1
    chunk_blocks: int = 16  # copy-dispatch granularity (legacy dispatch path)
    budget_blocks_per_tick: int = 64  # async migration budget per tick/step
    max_attempts_before_force: int = 8  # write-through escalation (beyond paper)
    backend: str = "xla"  # "xla" | "ppermute"
    axis_name: str | None = None  # region mesh axis (ppermute backend)
    # Dispatch generation (DESIGN.md §3, §12).  True (default) selects the
    # megastep — the whole tick as ONE device program; "batched" selects the
    # previous generation (<=3 bucketed programs per tick); False/"legacy"
    # selects per-area/per-chunk dispatch.  Booleans are accepted for
    # backwards compatibility with every existing call site.
    fused_dispatch: bool | str = True
    # Compile the megastep's steady-state variants when the driver is built
    # (megastep mode only; no-op otherwise), as the JAX package does: the
    # budget-floored shared bucket fixes every steady-state operand shape
    # before any workload runs, so on the card each variant is captured as a
    # CUDA graph then and the first leap() pays no capture.  On the CPU the
    # variants are only registered.  Off by default.
    warm_dispatch: bool = False
    bucket_growth: int = 4  # geometric padding factor for batch shapes
    # Kernel impl: None/"auto" = hand-written CUDA kernel on a CUDA tensor,
    # plain PyTorch on a CPU tensor; "cuda" = the kernel (raises on CPU);
    # "ref" = the plain version.
    copy_impl: str | None = None
    # Two-tier pool knobs (active when PoolConfig.huge_factor > 1):
    demote_after_attempts: int = 2  # huge-commit rejections before demotion (§4.2)
    promote_cold_ticks: int = 0  # ticks since last write required to promote
    promote_per_tick: int = 0  # auto-promotions attempted per tick (0 = manual)
    # Topology-aware scheduling knobs (active when PoolConfig.topology is set):
    link_schedule: bool = True  # charge copies against per-link byte/dispatch budgets
    multi_hop: bool = True  # relay via an intermediate region when 2 hops are cheaper
    link_blocks_per_tick: int | None = None  # per-link block budget at bandwidth 1.0
    # (None: defaults to budget_blocks_per_tick — one full-speed link can
    # absorb the whole tick budget; slower links get proportionally less)
    # Closed-loop tiering (DESIGN.md §13): maintain a per-block exponentially
    # decayed access-heat plane on device, updated as an optional megastep
    # phase (trace-time skipped when off, so disabling tiering is bit-
    # identical to the tiering-less engine).  The heat plane feeds
    # repro.tiering.TieringPolicy's promotion/demotion watermarks.
    tiering: bool = False
    tier_heat_decay: float = 0.9  # per-update exponential decay of heat
    tier_write_weight: float = 1.0  # heat added per write (reads add 1.0)
    # A block re-migrated within this many ticks of its previous migration
    # counts as a ping-pong (MigrationStats.ping_pong_migrations) — the
    # quantity the tiering policy's hysteresis exists to suppress.
    tier_pingpong_window: int = 16
    # Telemetry (repro.obs): off by default — the pipeline then carries the
    # shared NullRecorder and pays only attribute lookups per tick.
    telemetry: bool = False
    telemetry_events: int = 65536  # event ring capacity (oldest evicted)
    telemetry_requests: int = 1024  # resolved request spans retained (LRU)

    _DISPATCH_MODES = (True, False, "legacy", "batched", "megastep")

    def __post_init__(self) -> None:
        if self.fused_dispatch not in self._DISPATCH_MODES:
            raise ValueError(
                f"fused_dispatch must be one of {self._DISPATCH_MODES}, "
                f"got {self.fused_dispatch!r}"
            )
        if self.copy_impl not in IMPLS:
            raise ValueError(f"copy_impl must be one of {IMPLS}, got {self.copy_impl!r}")

    @property
    def dispatch_mode(self) -> str:
        """Resolved dispatch generation: "legacy" | "batched" | "megastep".

        ``fused_dispatch`` is a bool-or-string knob (booleans kept for
        backwards compatibility): False/"legacy" is per-area dispatch,
        "batched" the <=3-programs-per-tick generation, True/"megastep" the
        single-dispatch tick.  The ppermute backend routes point-to-point
        copies through shard_map programs with *static* (src, dst) endpoints,
        which cannot fuse into one variant-stable program — megastep falls
        back to batched there (in the port too, to keep the JAX package's
        program sequence).
        """
        if self.fused_dispatch in (False, "legacy"):
            return "legacy"
        if self.fused_dispatch == "batched":
            return "batched"
        if self.backend == "ppermute":
            return "batched"
        return "megastep"
