"""Topology layer: machine description for link-aware migration scheduling.

``NumaTopology`` models region-pair distances (SLIT-style), per-link
bandwidth and dispatch budgets, and hop paths; the migration driver charges
every copy against its link's per-tick budget and routes around expensive
links (DESIGN.md §7).  Pure numpy — no dependency on the rest of ``repro``.
"""

from repro_torch.topology.model import (
    LOCAL_DISTANCE,
    NumaTopology,
    modeled_tick_time,
    spill_assignments,
)

__all__ = [
    "LOCAL_DISTANCE",
    "NumaTopology",
    "modeled_tick_time",
    "spill_assignments",
]
