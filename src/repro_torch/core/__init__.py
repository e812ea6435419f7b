"""Core: `page_leap()` on one CUDA device — pooled, reliable, adaptive block
migration behind a virtual block table, organized as a staged pipeline
(``repro_torch.core.pipeline``) with pluggable scheduler policies, and the
paper's contenders (``baselines``) as configurations of that pipeline."""

from repro_torch.core.state import (
    REGION,
    SLOT,
    LeapState,
    PoolConfig,
    group_dirty,
    group_in_flight,
    huge_read,
    init_state,
    leap_read,
    leap_write,
    leap_write_rows,
    placement_histogram,
    state_sharding,
)
from repro_torch.core.adaptive import (
    Area,
    area_blocks_for_distance,
    bucket_size,
    decompose_request,
    demote_area,
    pad_to_bucket,
    split_area,
)
from repro_torch.core.config import LeapConfig
from repro_torch.core.stats import MigrationStats, RequestState
from repro_torch.core.queues import AreaQueue, CommitBatch, FreeList
from repro_torch.core.driver import MigrationDriver
from repro_torch.core.pipeline import (
    AdmissionTicket,
    LeapScheduler,
    SamplingConfig,
    SamplingScheduler,
    SchedulerPolicy,
    SyncScheduler,
    make_scheduler,
)
from repro_torch.core.baselines import (
    AutoBalanceConfig,
    AutoBalancer,
    SyncResharder,
    SyncReshardResult,
)
from repro_torch.core import migrator
from repro_torch.launch.mesh import RegionMesh, make_region_mesh

__all__ = [
    "REGION",
    "SLOT",
    "LeapState",
    "PoolConfig",
    "init_state",
    "leap_read",
    "leap_write",
    "leap_write_rows",
    "placement_histogram",
    "state_sharding",
    "RegionMesh",
    "make_region_mesh",
    "group_dirty",
    "group_in_flight",
    "huge_read",
    "Area",
    "area_blocks_for_distance",
    "bucket_size",
    "decompose_request",
    "demote_area",
    "pad_to_bucket",
    "split_area",
    "AreaQueue",
    "CommitBatch",
    "FreeList",
    "LeapConfig",
    "MigrationDriver",
    "MigrationStats",
    "RequestState",
    "AdmissionTicket",
    "LeapScheduler",
    "SamplingConfig",
    "SamplingScheduler",
    "SchedulerPolicy",
    "SyncScheduler",
    "make_scheduler",
    "AutoBalanceConfig",
    "AutoBalancer",
    "SyncResharder",
    "SyncReshardResult",
    "migrator",
]
