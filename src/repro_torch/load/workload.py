"""Deterministic open-loop serving workloads.

A :class:`WorkloadSpec` describes multi-tenant traffic against a
:class:`repro_torch.serving.PagedEngine`: per-tenant Poisson arrival rates,
prompt/decode phase mix, per-token latency SLOs and priorities, plus an
optional background-churn schedule (periodic rebalances that keep a
sustained migration load on the pool).  Everything downstream derives from
the spec seed — :class:`ArrivalStream` pre-materializes the whole arrival
schedule up front, so the same spec always replays the same trace
(CI-gateable latency percentiles need bit-identical inputs).

Specs are frozen and JSON round-trippable, mirroring the chaos harness's
``ScenarioSpec`` discipline: a failing serving run can be re-fed from its
serialized spec.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One serving class: arrival process, request shape, SLO, placement."""

    name: str
    rate: float  # mean arrivals per tick (Poisson)
    prompt_tokens: int  # prefill length of every request
    decode_tokens: int  # tokens generated per request after the first
    slo_latency: float  # per-token latency target, modeled time units
    priority: int = 0  # admission priority (higher admits first)
    region: int = 0  # home region for admissions

    def validate(self) -> None:
        if not self.name:
            raise ValueError("tenant needs a name")
        if self.rate < 0:
            raise ValueError(f"tenant {self.name}: rate must be >= 0")
        if self.prompt_tokens <= 0 or self.decode_tokens <= 0:
            raise ValueError(f"tenant {self.name}: prompt/decode tokens must be > 0")
        if self.slo_latency <= 0:
            raise ValueError(f"tenant {self.name}: slo_latency must be > 0")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A full open-loop run: tenants, duration, queue bound, churn."""

    tenants: tuple = ()
    ticks: int = 64
    seed: int = 0
    # Pending-admission queue bound; arrivals past it are dropped (and
    # counted) — open-loop traffic never blocks on the server.
    max_queue: int = 64
    # Background churn: every churn_every ticks (0 = never), rebalance
    # churn_count live sequences to the next region round-robin — the
    # sustained migration load the SLO scheduler must pace around.
    churn_every: int = 0
    churn_count: int = 1

    def validate(self) -> None:
        if not self.tenants:
            raise ValueError("workload needs at least one tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError("tenant names must be unique")
        for t in self.tenants:
            t.validate()
        if self.ticks <= 0:
            raise ValueError("ticks must be > 0")
        if self.max_queue <= 0:
            raise ValueError("max_queue must be > 0")
        if self.churn_every < 0 or self.churn_count < 0:
            raise ValueError("churn_every/churn_count must be >= 0")

    # -- JSON round-trip ---------------------------------------------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["tenants"] = [dataclasses.asdict(t) for t in self.tenants]
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "WorkloadSpec":
        d = json.loads(text)
        d["tenants"] = tuple(TenantSpec(**t) for t in d.get("tenants", ()))
        spec = cls(**d)
        spec.validate()
        return spec


@dataclasses.dataclass
class Request:
    """One in-flight request's lifecycle (modeled-clock timestamps)."""

    rid: int
    tenant: str
    priority: int
    region: int
    prompt_tokens: int
    decode_tokens: int
    arrival_tick: int
    arrival_time: float
    sid: int | None = None
    admit_time: float | None = None
    done_time: float | None = None
    tokens_done: int = 0

    @property
    def queue_delay(self) -> float | None:
        if self.admit_time is None:
            return None
        return self.admit_time - self.arrival_time


class ArrivalStream:
    """Pre-materialized Poisson arrival schedule for one spec.

    ``counts[i, t]`` is tenant *i*'s arrival count at tick *t*; each tenant
    draws from its own ``numpy`` PCG64 stream keyed off ``(seed, i)`` so
    adding a tenant never perturbs the others' schedules.
    """

    def __init__(self, spec: WorkloadSpec):
        spec.validate()
        self.spec = spec
        rows = []
        for i, t in enumerate(spec.tenants):
            rng = np.random.Generator(np.random.PCG64(spec.seed * 1_000_003 + i))
            rows.append(rng.poisson(t.rate, size=spec.ticks))
        self.counts = np.stack(rows).astype(np.int64)

    def arrivals(self, tick: int) -> list:
        """``[(tenant_index, TenantSpec), ...]`` arriving at ``tick``, one
        entry per request, tenants in spec order."""
        out = []
        for i, t in enumerate(self.spec.tenants):
            out.extend((i, t) for _ in range(int(self.counts[i, tick])))
        return out

    def total(self) -> int:
        return int(self.counts.sum())
