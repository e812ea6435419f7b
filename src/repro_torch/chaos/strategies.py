"""Scenario sampling: one seeded generator, two consumers.

``sample_spec(seed)`` is a pure numpy function — no optional dependencies —
mapping a seed to a valid :class:`ScenarioSpec`.  The CI smoke jobs sweep a
fixed seed range through it (``python -m repro_torch.chaos --count 50``), so the
matrix is reproducible run to run.

``scenario_specs()`` wraps the same scenario space as a Hypothesis strategy
built from shrinkable components (not a seed), so a failing example
minimizes toward fewer ticks, fewer blocks, and fewer fault events before
being serialized by ``run_with_repro``.  Hypothesis is imported lazily: the
module stays importable in environments without it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.chaos.spec import ScenarioSpec, FaultEvent


def _sample_faults(rng: np.random.Generator, n_regions: int, has_topo: bool) -> tuple:
    kinds = ["drain_region", "cancel_storm", "write_burst", "out_of_slots"]
    if has_topo:
        kinds += ["congest_link", "degrade_link", "restore_topology"]
    out = []
    for _ in range(int(rng.integers(0, 4))):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        args: dict = {}
        if kind == "drain_region":
            args["region"] = int(rng.integers(0, n_regions))
            if rng.random() < 0.3:
                args["scheduler"] = "sync"
        elif kind in ("congest_link", "degrade_link"):
            src = int(rng.integers(0, n_regions))
            dst = int((src + 1 + rng.integers(0, n_regions - 1)) % n_regions)
            args = {"src": src, "dst": dst}
            if kind == "congest_link":
                args["factor"] = float(rng.choice([1.5, 2.0, 4.0]))
            else:
                args["bandwidth"] = float(rng.choice([0.25, 0.5]))
        elif kind == "cancel_storm":
            args["frac"] = float(rng.choice([0.25, 0.5, 1.0]))
        elif kind == "write_burst":
            args["blocks"] = int(rng.integers(1, 6))
        out.append(FaultEvent(kind=kind, tick=-1, args=args))
    return tuple(out)


def sample_spec(seed: int) -> ScenarioSpec:
    """Deterministically map ``seed`` to one valid scenario (pure numpy)."""
    rng = np.random.default_rng(seed)
    n_regions = int(rng.choice([2, 2, 3, 4]))
    slots = int(rng.choice([8, 16, 32]))
    huge = int(rng.choice([1, 1, 1, 4])) if slots % 4 == 0 else 1
    placement = str(rng.choice(["dense", "spread", "random"]))
    adopt = bool(huge > 1 and placement == "dense" and rng.random() < 0.7)
    n_blocks = int(rng.integers(2, slots + 1))
    if huge > 1:
        n_blocks = max(huge, (n_blocks // huge) * huge)  # whole groups
    topology = None
    topology_args: tuple = ()
    if rng.random() < 0.5:
        if n_regions == 2:
            topology = str(rng.choice(["symmetric", "two_socket"]))
        elif n_regions == 4:
            topology = str(rng.choice(["symmetric", "quad_socket", "cxl_pooled"]))
        else:
            topology = str(rng.choice(["symmetric", "cxl_pooled"]))
        if topology == "cxl_pooled":
            n_far = int(rng.integers(1, n_regions))
            topology_args = (n_regions - n_far, n_far)
    # "serving" is deliberately absent from the sampled workloads: it spins
    # up a real model engine per scenario, which would dominate a long seed
    # sweep's budget.  Serving chaos runs as dedicated scenarios instead
    # (tests/test_torch_load.py).
    workload = str(
        rng.choice(["drain", "stream", "stream", "exchange", "working_set_shift"])
    )
    # Closed-loop tiering rides any workload with a topology (heat plane +
    # megastep heat phase); working_set_shift scenarios are steered onto a
    # CXL machine so the policy has a far tier to promote from — and so the
    # tiering_hysteresis invariant actually arms.
    tiering = bool(topology is not None and rng.random() < 0.25)
    if workload == "working_set_shift" and n_regions >= 3 and rng.random() < 0.8:
        topology = "cxl_pooled"
        n_far = int(rng.integers(1, n_regions - 1))  # keep >= 2 near regions
        topology_args = (n_regions - n_far, n_far)
        tiering = True
    spec = ScenarioSpec(
        seed=seed,
        ticks=int(rng.integers(10, 41)),
        n_regions=n_regions,
        slots_per_region=slots,
        n_blocks=n_blocks,
        block_elems=4,
        huge_factor=huge,
        adopt_huge=adopt,
        placement=placement,
        topology=topology,
        topology_args=topology_args,
        scheduler=str(rng.choice(["leap", "leap", "sync", "sampling"])),
        initial_area_blocks=int(rng.choice([2, 4, 8])),
        chunk_blocks=int(rng.choice([1, 2])),
        budget_blocks_per_tick=int(rng.choice([2, 4, 8])),
        max_attempts_before_force=int(rng.integers(2, 5)),
        demote_after_attempts=int(rng.integers(1, 4)),
        workload=workload,
        leap_every=int(rng.integers(1, 5)),
        blocks_per_leap=int(rng.integers(1, max(2, n_blocks // 2 + 1))),
        max_priority=int(rng.integers(0, 4)),
        writes_per_tick=int(rng.choice([0, 0, 1, 2, 4])),
        tiering=tiering,
        tier_epoch=int(rng.choice([2, 4])),
        shift_every=int(rng.choice([6, 8, 12])),
        hot_frac=float(rng.choice([0.25, 0.5])),
        reads_per_tick=int(rng.choice([4, 8])),
        faults=_sample_faults(rng, n_regions, topology is not None),
        payload_every=int(rng.choice([1, 1, 2, 4])),
    )
    if spec.tiering and spec.workload == "working_set_shift":
        # Guarantee the closed loop has work from t=0: blocks spread across
        # ALL regions (far tier populated) and a hot window wide enough to
        # span every region, so the first acting epochs see hot far-resident
        # blocks to promote.  Tiny dense pools otherwise sample scenarios
        # where stray write heat keeps everything warm-and-near and the
        # policy (correctly) never moves a block.  Overridden after
        # construction so the rng draw stream is identical either way.
        n_blocks = max(spec.n_blocks, 2 * spec.n_regions)
        if spec.huge_factor > 1:
            n_blocks = -(-n_blocks // spec.huge_factor) * spec.huge_factor
        spec = dataclasses.replace(
            spec,
            placement="spread",
            adopt_huge=False,
            n_blocks=n_blocks,
            hot_frac=0.5,
        )
    spec.validate()
    return spec


def scenario_specs(max_faults: int = 3):
    """Hypothesis strategy over the same scenario space, built from
    shrinkable components (smaller pools, fewer ticks/faults first)."""
    from hypothesis import strategies as st  # deferred optional dependency

    def build(draw):
        n_regions = draw(st.sampled_from([2, 3, 4]))
        slots = draw(st.sampled_from([8, 16, 32]))
        huge = draw(st.sampled_from([1, 4])) if slots % 4 == 0 else 1
        placement = draw(st.sampled_from(["dense", "spread", "random"]))
        adopt = huge > 1 and placement == "dense" and draw(st.booleans())
        n_blocks = draw(st.integers(2, slots))
        if huge > 1:
            n_blocks = max(huge, (n_blocks // huge) * huge)
        topo_choices = [None, "symmetric"]
        if n_regions == 2:
            topo_choices.append("two_socket")
        if n_regions == 4:
            topo_choices.append("quad_socket")
        topology = draw(st.sampled_from(topo_choices))
        fault_kinds = ["drain_region", "cancel_storm", "write_burst", "out_of_slots"]
        if topology is not None:
            fault_kinds += ["congest_link", "restore_topology"]

        def event(kind, region, frac, factor):
            if kind == "drain_region":
                return FaultEvent(kind, args={"region": region % n_regions})
            if kind == "cancel_storm":
                return FaultEvent(kind, args={"frac": frac})
            if kind == "write_burst":
                return FaultEvent(kind, args={"blocks": 2})
            if kind == "congest_link":
                return FaultEvent(
                    kind, args={"src": 0, "dst": 1 + region % (n_regions - 1),
                                "factor": factor}
                )
            return FaultEvent(kind, args={})

        faults = tuple(
            draw(
                st.lists(
                    st.builds(
                        event,
                        st.sampled_from(fault_kinds),
                        st.integers(0, n_regions - 1),
                        st.sampled_from([0.5, 1.0]),
                        st.sampled_from([2.0, 4.0]),
                    ),
                    max_size=max_faults,
                )
            )
        )
        spec = ScenarioSpec(
            seed=draw(st.integers(0, 2**31 - 1)),
            ticks=draw(st.integers(5, 30)),
            n_regions=n_regions,
            slots_per_region=slots,
            n_blocks=n_blocks,
            huge_factor=huge,
            adopt_huge=adopt,
            placement=placement,
            topology=topology,
            scheduler=draw(st.sampled_from(["leap", "sync", "sampling"])),
            initial_area_blocks=draw(st.sampled_from([2, 4])),
            budget_blocks_per_tick=draw(st.sampled_from([2, 4])),
            workload=draw(st.sampled_from(["drain", "stream", "exchange"])),
            leap_every=draw(st.integers(1, 4)),
            blocks_per_leap=draw(st.integers(1, max(1, n_blocks // 2))),
            writes_per_tick=draw(st.sampled_from([0, 1, 2])),
            faults=faults,
        )
        spec.validate()
        return spec

    return st.composite(build)()


def sabotage_specs():
    """Hypothesis strategy over scenarios that reliably exercise the forced
    same-tick slot-reuse window: sync-scheduler exchanges over spread blocks
    (every area escalates to the force path in one bidirectional tick)."""
    from hypothesis import strategies as st  # deferred optional dependency

    def build(draw):
        slots = draw(st.sampled_from([8, 16]))
        spec = ScenarioSpec(
            seed=draw(st.integers(0, 2**31 - 1)),
            ticks=draw(st.integers(2, 8)),
            n_regions=2,
            slots_per_region=slots,
            n_blocks=draw(st.integers(2, slots)),
            placement="spread",
            scheduler="sync",
            workload="exchange",
            initial_area_blocks=draw(st.sampled_from([2, 4])),
            budget_blocks_per_tick=8,
        )
        spec.validate()
        return spec

    return st.composite(build)()
