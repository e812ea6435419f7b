"""Chaos CLI: seeded scenario sweeps and deterministic replay.

Sweep (a fixed seed range is the reproducible scenario matrix):

    python -m repro_torch.chaos --count 50 --start 0 --repro-dir .chaos-repro
    python -m repro_torch.chaos --seeds 0-7

Replay one serialized failing spec:

    python -m repro_torch.chaos --replay .chaos-repro/last_failure.json

Exit status is non-zero iff any scenario violated a standing invariant;
each failing spec is serialized under ``--repro-dir`` before the sweep
continues, so one bad seed never hides another.  Scenarios run on the
current CUDA device unless ``--device cpu`` (or another device) is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.chaos.driver import run_scenario, run_with_repro
from repro_torch.chaos.invariants import InvariantViolation
from repro_torch.chaos.spec import DISPATCH_MODES, ScenarioSpec
from repro_torch.chaos.strategies import sample_spec


def _describe(report) -> str:
    s = report.spec
    return (
        f"seed={s.seed} {s.workload}/{s.scheduler} R={s.n_regions} "
        f"S={s.slots_per_region} B={s.n_blocks} huge={s.huge_factor} "
        f"topo={s.topology or '-'} faults={len(s.faults)} | "
        f"ticks={report.ticks_run} checks={report.checks_run} "
        f"req={report.blocks_requested} mig={report.blocks_migrated} "
        f"forced={report.blocks_forced} cancelled={report.blocks_cancelled} "
        f"events={len(report.events_fired)} refusals={report.drain_refusals}"
    )


def _seed_range(text: str) -> range:
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.chaos", description=__doc__)
    p.add_argument("--replay", metavar="SPEC_JSON", help="re-run one serialized spec")
    p.add_argument("--start", type=int, default=0, help="first seed of the sweep")
    p.add_argument("--count", type=int, default=10, help="number of seeds to sweep")
    p.add_argument(
        "--seeds", type=_seed_range, default=None, metavar="A-B",
        help="sweep seeds A..B inclusive (instead of --start/--count)",
    )
    p.add_argument(
        "--device", default=None, help="torch device (default: the current CUDA device)"
    )
    p.add_argument(
        "--repro-dir", default=".chaos-repro", help="where failing specs serialize"
    )
    p.add_argument(
        "--sabotage", default=None, help="deliberately inject a known bug (testing)"
    )
    p.add_argument(
        "--dispatch",
        default=None,
        choices=DISPATCH_MODES,
        help="override every scenario's dispatch generation "
        "(e.g. sweep under megastep, then legacy)",
    )
    args = p.parse_args(argv)

    if args.replay:
        with open(args.replay) as f:
            spec = ScenarioSpec.from_json(f.read())
        if args.dispatch:
            spec = dataclasses.replace(spec, dispatch=args.dispatch)
        try:
            report = run_scenario(spec, sabotage=args.sabotage, device=args.device)
        except InvariantViolation as e:
            print(f"VIOLATION {e}", file=sys.stderr)
            return 1
        print(f"OK {_describe(report)} completed={report.completed}")
        return 0

    seeds = args.seeds or range(args.start, args.start + args.count)
    failures = 0
    for seed in seeds:
        spec = sample_spec(seed)
        if args.dispatch:
            spec = dataclasses.replace(spec, dispatch=args.dispatch)
        try:
            report = run_with_repro(
                spec, args.repro_dir, sabotage=args.sabotage, device=args.device
            )
        except InvariantViolation as e:
            failures += 1
            print(f"FAIL seed={seed}: {e}", file=sys.stderr)
            continue
        print(f"ok {_describe(report)} completed={report.completed}")
        if not report.completed:
            failures += 1
            print(f"FAIL seed={seed}: final drain did not terminate", file=sys.stderr)
    print(f"{len(seeds) - failures}/{len(seeds)} scenarios passed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
