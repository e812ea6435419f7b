"""The port's ``roofline/report.py`` against the JAX package's, on the CPU.

On the same artifact files (the port's keys ``build_s`` and
``first_step_s`` written as the reference's ``lower_s`` and ``compile_s``
in its copy), ``dryrun_table`` gives the reference's rows; only the
timing column's title differs, and accounting-only rows are the port's own
("arguments only").  ``roofline_table`` rows equal the port's
``terms_from_artifact`` (the H100's constants) and skip rows without a
``roofline`` entry; ``measured_table`` renders each cell's cut, and says
"not measured" for a CPU run's device figures.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.roofline import report as jreport  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.model import terms_from_artifact  # noqa: E402

GIB = 2**30
REPO = Path(__file__).resolve().parents[1]


def _ok(arch, shape, mesh, *, n_micro=None, reduced=None, device="NVIDIA H100 80GB HBM3",
        device_ms=812.5):
    art = {
        "arch": arch, "shape": shape, "mesh": mesh, "n_chips": 1, "status": "OK",
        "build_s": 3.25, "first_step_s": 1.5,
        "memory": {"argument_bytes": 48 * GIB, "output_bytes": GIB, "temp_bytes": 3 * GIB,
                   "alias_bytes": GIB, "per_device_total": 51 * GIB},
        "flops_per_device": 2.5e14, "bytes_per_device": 4.8e10, "wire_bytes_per_device": 0.0,
        "model_flops": 2.0e14, "reduced": reduced,
        "measured": {"device": device, "step_ms": 1000.0, "steps_ms": [990.0, 1000.0, 1012.5],
                     "device_ms": device_ms, "window_ms": 1100.0,
                     "busy": None if device_ms is None else device_ms / 1000.0,
                     "busy_profiled": None if device_ms is None else device_ms / 1100.0,
                     "peak_bytes": None if device_ms is None else 51 * GIB, "kernels": 7,
                     "kernel_classes": {"GEMM": {"device_ms": 600.0, "launches": 4},
                                        "elementwise": {"device_ms": 200.0, "launches": 2},
                                        "reduction": {"device_ms": 12.5, "launches": 1},
                                        "other": {"device_ms": 0.001, "launches": 1}},
                     "trace": "x.trace.json.gz"},
    }
    t = terms_from_artifact(art)
    art["roofline"] = {"compute_s": t.compute_s, "memory_s": t.memory_s,
                       "collective_s": t.collective_s, "dominant": t.dominant,
                       "step_time_s": t.step_time_s, "useful_flops_ratio": t.useful_flops_ratio,
                       "roofline_fraction": t.roofline_fraction}
    if n_micro is not None:
        art["n_micro"] = n_micro
    return art


def _artifacts(mesh):
    cut = {"batch": 16, "of_batch": 128, "layers": 40, "of_layers": 40, "by": ["memory"]}
    return [
        _ok("granite_3_2b", "decode_32k", mesh, reduced=cut),
        _ok("granite_3_2b", "train_4k", mesh, n_micro=2,
            reduced={"batch": 4, "of_batch": 256, "layers": 40, "of_layers": 40,
                     "by": ["step tokens"]}),
        _ok("xlstm_125m", "decode_32k", mesh, device="cpu", device_ms=None),
        {"arch": "granite_3_2b", "shape": "long_500k", "mesh": mesh, "status": "SKIP(full-attn)"},
        {"arch": "gemma2_27b", "shape": "prefill_32k", "mesh": mesh,
         "status": "FAIL: RuntimeError: out of memory"},
        {"arch": "nemotron_4_340b", "shape": "train_4k", "mesh": mesh,
         "status": "SKIP(one card)", "reason": "too large"},
        {"arch": "leap_migration", "shape": "ppermute", "mesh": mesh, "status": "SKIP(one card)"},
    ]


@pytest.fixture()
def dirs(tmp_path, monkeypatch):
    ours, theirs = tmp_path / "torch", tmp_path / "jax"
    for mesh in ("h100",):
        (ours / mesh).mkdir(parents=True)
        (theirs / mesh).mkdir(parents=True)
        for a in _artifacts(mesh):
            name = f"{a['arch']}__{a['shape']}.json"
            (ours / mesh / name).write_text(json.dumps(a))
            ref = dict(a)
            if "build_s" in ref:  # the reference's keys for the same times
                ref["lower_s"], ref["compile_s"] = ref.pop("build_s"), ref.pop("first_step_s")
            (theirs / mesh / name).write_text(json.dumps(ref))
    monkeypatch.setattr(report, "ART_DIR", str(ours))
    monkeypatch.setattr(jreport, "ART_DIR", str(theirs))
    return ours


def test_load_and_fmt_bytes_equal_the_reference(dirs):
    mine = report.load("h100")
    assert {k: {kk: vv for kk, vv in v.items() if kk not in ("build_s", "first_step_s")}
            for k, v in mine.items()} == {
        k: {kk: vv for kk, vv in v.items() if kk not in ("lower_s", "compile_s")}
        for k, v in jreport.load("h100").items()}
    for n in (0, 1023, 1024, 5 * GIB + 7, 3.5 * 2**40, 2**60):
        assert report.fmt_bytes(n) == jreport.fmt_bytes(n)


def test_dryrun_table_equals_the_reference(dirs):
    ours, theirs = report.dryrun_table("h100").split("\n"), jreport.dryrun_table("h100").split("\n")
    assert len(ours) == len(theirs) == 4 + 7
    assert ours[2] == theirs[2].replace("lower+compile (s)", "build+first step (s)")
    assert [ours[i] for i in (0, 1, 3)] == [theirs[i] for i in (0, 1, 3)]
    assert ours[4:] == theirs[4:]
    assert "| granite_3_2b | train_4k | OK | 4.8 | 51.0GB | 2 |" in ours


def test_accounting_rows_show_arguments_only(tmp_path, monkeypatch):
    (tmp_path / "pod").mkdir()
    art = {"arch": "granite_3_2b", "shape": "decode_32k", "mesh": "pod", "n_chips": 256,
           "status": "ACCOUNTED", "layout": "inference",
           "memory": {"argument_bytes": 1.75 * GIB, "arguments": {"params": GIB}}}
    (tmp_path / "pod" / "granite_3_2b__decode_32k.json").write_text(json.dumps(art))
    monkeypatch.setattr(report, "ART_DIR", str(tmp_path))
    table = report.dryrun_table("pod")
    assert "| granite_3_2b | decode_32k | ACCOUNTED | - | 1.8GB (arguments only) | - |" in table
    assert report.roofline_table("pod").count("\n") == 3  # header only: no roofline entry
    assert report.measured_table("pod").count("\n") == 3
    assert report.worst_cells("pod") == []


def test_roofline_table_rows_are_the_ports_terms(dirs):
    rows = [r for r in report.roofline_table("h100").split("\n")[4:]]
    arts = report.load("h100")
    with_terms = [(a, s) for (a, s), art in arts.items() if "roofline" in art]
    assert len(rows) == len(with_terms) == 3
    for row in rows:
        cells = [c.strip() for c in row.strip("|").split("|")]
        t = terms_from_artifact(arts[(cells[0], cells[1])])
        assert cells[2:] == [f"{t.compute_s:.4g}", f"{t.memory_s:.4g}", f"{t.collective_s:.4g}",
                             f"**{t.dominant}**", f"{t.model_flops:.3g}",
                             f"{t.useful_flops_ratio:.2f}", f"{t.roofline_fraction:.4f}"]
    assert report.worst_cells("h100")[0][0] == min(
        terms_from_artifact(arts[k]).roofline_fraction for k in with_terms)


def test_measured_table_renders_the_cut(dirs, capsys):
    table = report.measured_table("h100")
    rows = {tuple(c.strip() for c in r.strip("|").split("|"))[:2]: r
            for r in table.split("\n")[4:]}
    assert len(rows) == 3
    row = rows[("granite_3_2b", "decode_32k")]
    t = terms_from_artifact(report.load("h100")[("granite_3_2b", "decode_32k")])
    bound_ms = t.step_time_s * 1e3
    assert "batch 16 of 128, layers 40 of 40 (memory)" in row
    assert "| 1000.00 | 3 (990.00–1012.50) | 812.50 | 0.812 | 51.00 |" in row
    assert f"| {bound_ms:.2f} ({t.dominant}) | {1000.0 / bound_ms:.1f} |" in row
    assert "GEMM 600.0 (4); elementwise 200.0 (2); reduction 12.5 (1) |" in row
    assert "batch 4 of 256, layers 40 of 40 (step tokens)" in rows[("granite_3_2b", "train_4k")]
    cpu = rows[("xlstm_125m", "decode_32k")]
    assert "| cpu | none |" in cpu and cpu.count("not measured") == 4
    # the artifacts given, in place of those under ART_DIR
    only = {("granite_3_2b", "train_4k"): report.load("h100")[("granite_3_2b", "train_4k")]}
    given = report.measured_table("h100", only).split("\n")[4:]
    assert len(given) == 1 and given[0].startswith("| granite_3_2b | train_4k |")
    report.main(["--mesh", "h100"])
    out = capsys.readouterr().out
    assert "— measured" in out and "worst cells (h100)" in out


def test_the_report_imports_nothing_of_the_launch_layer():
    code = ("import sys; import repro_torch.roofline.report; "
            "print(sorted(m for m in sys.modules if m.startswith(('repro_torch.launch', "
            "'repro_torch.models', 'repro_torch.train'))))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"
