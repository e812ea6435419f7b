"""Generate the dry-run, roofline and measured tables from the port's dry-run
artifacts.

    PYTHONPATH=src python -m repro_torch.roofline.report [--mesh h100]

The JAX package's ``roofline/report.py`` over the artifacts that
``launch/dryrun.py`` writes under ``ART_DIR`` (``<DRYRUN_ART_DIR, else
artifacts/dryrun>/torch``); this module holds where they go and the
statuses the tables read, and ``launch/dryrun.py`` takes them from here.  The roofline terms are the port's
(``roofline/model.py``, the H100's constants).  Rows of the production
meshes are accounting only (status ``ACCOUNTED``): ``dryrun_table`` shows
their argument bytes and marks them so, and the roofline tables skip them,
as every row without a ``roofline`` entry.  ``measured_table`` shows the
cells measured on a card, with their cut; ``leap_table`` the two leap cells.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs.base import ARCH_IDS
from repro_torch.configs.shapes import SHAPES
from repro_torch.roofline.model import terms_from_artifact

ART_DIR = os.path.abspath(os.path.join(
    os.environ.get("DRYRUN_ART_DIR",
                   os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                                "dryrun")),
    "torch"))
MESHES = ("h100", "pod", "multipod")
OK = "OK"  # a cell built and run on a card
ACCOUNTED = "ACCOUNTED"  # a production-mesh cell: argument bytes only, no program
SKIP_ONE_CARD = "SKIP(one card)"
LEAP_BACKENDS = ("xla", "ppermute")


def load(mesh: str) -> dict[tuple[str, str], dict]:
    out = {}
    for p in glob.glob(os.path.join(ART_DIR, mesh, "*.json")):
        with open(p) as f:
            a = json.load(f)
        out[(a["arch"], a["shape"])] = a
    return out


def fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def _cells(arts: dict):
    for arch in ARCH_IDS + ("leap_migration",):
        for shape in (SHAPES if arch != "leap_migration" else LEAP_BACKENDS):
            if (arch, shape) in arts:
                yield arch, shape, arts[(arch, shape)]


def dryrun_table(mesh: str) -> str:
    lines = [
        f"### Mesh `{mesh}`",
        "",
        "| arch | shape | status | build+first step (s) | bytes/device | n_micro |",
        "|---|---|---|---|---|---|",
    ]
    for arch, shape, a in _cells(load(mesh)):
        status = a.get("status", "?")
        if status == ACCOUNTED:
            lines.append(
                f"| {arch} | {shape} | {status} | - "
                f"| {fmt_bytes(a['memory']['argument_bytes'])} (arguments only) "
                f"| {a.get('n_micro', '-')} |"
            )
            continue
        if status != OK:
            lines.append(f"| {arch} | {shape} | {status} | - | - | - |")
            continue
        mem = a["memory"]["per_device_total"]
        lines.append(
            f"| {arch} | {shape} | OK | {a['build_s'] + a['first_step_s']:.1f} "
            f"| {'not measured' if mem is None else fmt_bytes(mem)} | {a.get('n_micro', '-')} |"
        )
    return "\n".join(lines)


def roofline_table(mesh: str) -> str:
    lines = [
        f"### Mesh `{mesh}` — roofline terms (per step)",
        "",
        "| arch | shape | compute (s) | memory (s) | collective (s) | dominant "
        "| MODEL_FLOPS | useful ratio | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch, shape, a in _cells(load(mesh)):
        if "roofline" not in a:
            continue
        t = terms_from_artifact(a)
        lines.append(
            f"| {arch} | {shape} | {t.compute_s:.4g} | {t.memory_s:.4g} "
            f"| {t.collective_s:.4g} | **{t.dominant}** "
            f"| {t.model_flops:.3g} | {t.useful_flops_ratio:.2f} "
            f"| {t.roofline_fraction:.4f} |"
        )
    return "\n".join(lines)


def _cut(a: dict) -> str:
    r = a.get("reduced")
    if not r:
        return "none"
    return (f"batch {r['batch']} of {r['of_batch']}, layers {r['layers']} of {r['of_layers']} "
            f"({', '.join(r['by'])})")


def measured_table(mesh: str, arts: dict | None = None) -> str:
    """The cells measured on a card: their cut, the median step, the
    profiled step's device ms and its share of the median step (busy), the
    peak, the step at its roofline bound and the measured step over it, and
    the three kernel classes with the most device time.  ``arts`` (keyed as
    :func:`load` keys them) in place of every artifact under ``ART_DIR``."""
    lines = [
        f"### Mesh `{mesh}` — measured",
        "",
        "| arch | shape | device | cut | step ms | steps (min–max ms) | device ms | busy "
        "| peak GiB | bound ms (dominant) | step / bound | top kernel classes (ms, launches) |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch, shape, a in _cells(load(mesh) if arts is None else arts):
        m = a.get("measured")
        if m is None or "roofline" not in a:  # a leap cell: leap_table
            continue
        bound_ms = terms_from_artifact(a).step_time_s * 1e3
        top = "; ".join(f"{k} {c['device_ms']:.1f} ({c['launches']})"
                        for k, c in list(m["kernel_classes"].items())[:3])
        if m["device_ms"] is None:  # a CPU run: no device time, no card to hold to the bound
            dev = busy = peak = ratio = "not measured"
        else:
            dev, busy = f"{m['device_ms']:.2f}", f"{m['busy']:.3f}"
            peak = f"{m['peak_bytes'] / 2**30:.2f}"
            ratio = f"{m['step_ms'] / bound_ms:.1f}"
        lines.append(
            f"| {arch} | {shape} | {m['device']} | {_cut(a)} | {m['step_ms']:.2f} "
            f"| {len(m['steps_ms'])} ({min(m['steps_ms']):.2f}–{max(m['steps_ms']):.2f}) | {dev} "
            f"| {busy} | {peak} | {bound_ms:.2f} ({a['roofline']['dominant']}) | {ratio} "
            f"| {top or '-'} |"
        )
    return "\n".join(lines)


def leap_table(mesh: str, arts: dict | None = None) -> str:
    """The leap cells: on a card their step (median, device ms, busy share)
    beside its byte bound and the kernels the trace names; on a production
    mesh their per-device argument bytes.  ``arts`` as for
    :func:`measured_table`."""
    lines = [
        f"### Mesh `{mesh}` — leap cells",
        "",
        "| backend | status | device | step ms | device ms | busy | bound ms | step / bound "
        "| bytes/device | kernels (ms, launches) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    arts = load(mesh) if arts is None else arts
    for backend in LEAP_BACKENDS:
        a = arts.get(("leap_migration", backend))
        if a is None:
            continue
        m = a.get("measured")
        if a["status"] == ACCOUNTED:
            lines.append(f"| {backend} | {ACCOUNTED} | - | - | - | - | - | - "
                         f"| {fmt_bytes(a['memory']['argument_bytes'])} (arguments only) | - |")
            continue
        if m is None:
            lines.append(f"| {backend} | {a['status']} | - | - | - | - | - | - | - | - |")
            continue
        if m["device_ms"] is None:  # a CPU run: no device time to hold to the bound
            dev = busy = ratio = "not measured"
        else:
            dev, busy = f"{m['device_ms']:.4f}", f"{m['busy']:.3f}"
            ratio = f"{m['step_ms'] / a['bound_ms']:.2f}"
        args = a["memory"]["argument_bytes"]
        kernels = "; ".join(f"{k} {c['device_ms']:.4f} ({c['launches']})"
                            for k, c in m["kernels_by_name"].items()) or "-"
        lines.append(
            f"| {backend} | {a['status']} | {m['device']} | {m['step_ms']:.4f} | {dev} | {busy} "
            f"| {a['bound_ms']:.4f} ({a['bound_by']}) | {ratio} "
            f"| {'not measured' if args is None else fmt_bytes(args)} | {kernels} |")
    return "\n".join(lines)


def worst_cells(mesh: str, k: int = 6) -> list[tuple]:
    rows = []
    for key, a in load(mesh).items():
        if "roofline" not in a:
            continue
        t = terms_from_artifact(a)
        rows.append((t.roofline_fraction, key, t.dominant))
    rows.sort()
    return rows[:k]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None, choices=MESHES)
    args = ap.parse_args(argv)
    for m in [args.mesh] if args.mesh else MESHES:
        print(dryrun_table(m))
        print()
        print(roofline_table(m))
        print()
        print(measured_table(m))
        print()
        print(leap_table(m))
        print()
        print(f"worst cells ({m}):")
        for frac, key, dom in worst_cells(m):
            print(f"  {frac:.5f}  {key}  dom={dom}")
        print()


if __name__ == "__main__":
    main()
