"""The staged migration pipeline behind :class:`repro.core.MigrationDriver`.

The paper's `page_leap()` is a sequence of distinct mechanisms; each lives
in its own stage here, composed by the thin driver:

  admission   request decomposition, dedup, huge grouping, cancellation
  routing     topology routes, two-hop relays, link-scaled area sizing
  budget      per-tick block budget, per-link byte/dispatch budgets,
              congestion deferral
  dispatch    epoch opens + shape-bucketed begin/copy/force/commit batching
  verdict     dirty handling, adaptive splits, huge demotion, relay
              re-enqueue
  accounting  per-request credit, completion callbacks, cancel accounting

All stages share one :class:`PipelineContext` (device state, exact host
mirrors, queues, request registry).  The :class:`SchedulerPolicy` protocol
is the strategy seam at admission/budget: the paper's baselines
(move_pages()-style sync, autonuma-style sampling) are configurations of
this one engine — see ``scheduler.py`` and DESIGN.md §8.
"""

from repro_torch.core.pipeline.accounting import AccountingStage
from repro_torch.core.pipeline.admission import AdmissionStage, busy_mask
from repro_torch.core.pipeline.budget import BudgetStage, TickBudget
from repro_torch.core.pipeline.context import PipelineContext
from repro_torch.core.pipeline.dispatch import DispatchStage
from repro_torch.core.pipeline.introspect import AreaView, PipelineSnapshot, snapshot
from repro_torch.core.pipeline.routing import RoutingStage
from repro_torch.core.pipeline.scheduler import (
    AdmissionTicket,
    LeapScheduler,
    SamplingConfig,
    SamplingScheduler,
    SchedulerPolicy,
    SloConfig,
    SloScheduler,
    SyncScheduler,
    make_scheduler,
)
from repro_torch.core.pipeline.verdict import VerdictStage

__all__ = [
    "AccountingStage",
    "AdmissionStage",
    "AdmissionTicket",
    "AreaView",
    "BudgetStage",
    "DispatchStage",
    "LeapScheduler",
    "PipelineContext",
    "PipelineSnapshot",
    "RoutingStage",
    "SamplingConfig",
    "SamplingScheduler",
    "SchedulerPolicy",
    "SloConfig",
    "SloScheduler",
    "SyncScheduler",
    "TickBudget",
    "VerdictStage",
    "busy_mask",
    "make_scheduler",
    "snapshot",
]
