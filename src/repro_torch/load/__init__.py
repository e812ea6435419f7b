"""Serving-scale workload subsystem: deterministic open-loop traffic,
SLO-aware pacing hooks, and autoscaler-style drain/fill — the load side of
DESIGN.md §11.  Pure host code: it drives a
:class:`repro_torch.serving.engine.PagedEngine` on whatever device the
engine lives on.

* :mod:`repro_torch.load.workload` — frozen, JSON round-trippable specs and the
  pre-materialized Poisson :class:`ArrivalStream`.
* :mod:`repro_torch.load.generator` — :class:`LoadGenerator`, the tick loop that
  drives a :class:`repro_torch.serving.PagedEngine` under a modeled clock.
* :mod:`repro_torch.load.autoscale` — :class:`RegionAutoscaler` drain/fill.
"""

from repro_torch.load.autoscale import RegionAutoscaler
from repro_torch.load.generator import LoadGenerator, ServingTimeModel, pow2_chunks
from repro_torch.load.workload import ArrivalStream, Request, TenantSpec, WorkloadSpec

__all__ = [
    "ArrivalStream",
    "LoadGenerator",
    "RegionAutoscaler",
    "Request",
    "ServingTimeModel",
    "TenantSpec",
    "WorkloadSpec",
    "pow2_chunks",
]
