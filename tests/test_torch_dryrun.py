"""The port's ``launch/dryrun.py`` against the JAX package's, on the CPU.

The reference's dry-run sets ``XLA_FLAGS`` to 512 host devices when it is
imported, which would leak into every later subprocess of this test worker
(``tests/conftest.py`` holds the suite to one JAX device).  So its figures
are taken in a subprocess with its own environment and a timeout: the
statuses, ``n_micro`` and MoE groups of all 40 cells on the pod and
multi-pod meshes and at dp 1, and the per-device argument bytes of every
``train_4k`` and ``decode_32k`` cell on both meshes, from the reference's
own sharding rules (``param_shardings``, ``_cache_shardings``,
``_batch_sharding``, the 2D decode switch) on the structures its
``build_cell`` builds.  The port's accounting sweep runs on ``meta`` and
must equal them; its cut on the H100 and a measured run of a ``reduce()`` d
config on the CPU, which writes the full artifact schema, are checked
against what they must hold.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import shapes as shp  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.smoke import reduce  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.roofline import flops as fl  # noqa: E402
from repro_torch.roofline import trace as T  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

_REFERENCE = textwrap.dedent("""
    import json, math, sys
    from repro.launch import dryrun as D  # sets the 512-device flag before jax starts
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import shapes as shp
    from repro.configs.base import ARCH_IDS, get_config
    from repro.distributed.sharding import (
        _EXPERT_LEAVES, make_ctx, make_decode_2d_ctx, param_shardings)
    from repro.launch.mesh import make_production_mesh
    from repro.models import lm
    from repro.train.optimizer import OptimizerConfig
    from repro.train.train_step import TrainConfig, init_train_state

    def per_device(struct, shardings):
        leaves = jax.tree.leaves(struct)
        shards = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
        assert len(leaves) == len(shards)
        return sum(math.prod(s.shard_shape(l.shape)) * l.dtype.itemsize
                   for l, s in zip(leaves, shards))

    def plan(cfg, shape, dp):  # build_cell's n_micro and MoE groups
        sp = shp.SHAPES[shape]
        if sp.kind == "train":
            n_micro = max(1, sp.global_batch // (dp * cfg.microbatch_per_device))
            tokens = (sp.global_batch // n_micro) * sp.seq_len
            return n_micro, D._with_moe_groups(cfg, tokens, dp)
        if sp.kind == "prefill":
            return None, D._with_moe_groups(cfg, sp.global_batch * sp.seq_len, dp)
        return None, D._with_moe_groups(cfg, sp.global_batch, dp, mode="tokens")

    def train_bytes(cfg, n_micro, mesh, ctx):
        tcfg = TrainConfig(n_micro=n_micro, accum_dtype=cfg.grad_accum_dtype,
                           optimizer=OptimizerConfig(state_dtype=cfg.opt_state_dtype))
        state = jax.eval_shape(lambda: init_train_state(jax.random.key(0), cfg, tcfg))
        batch = shp.input_specs(cfg, "train_4k")
        return (per_device(state.params, param_shardings(state.params, mesh, ctx))
                + per_device(state.opt["m"], param_shardings(state.opt["m"], mesh, ctx))
                + per_device(state.opt["v"], param_shardings(state.opt["v"], mesh, ctx))
                + per_device(state.opt["step"], NamedSharding(mesh, P()))
                + per_device(batch, D._batch_sharding(cfg, mesh, ctx, batch)))

    def decode_bytes(cfg, mesh, ctx):
        params = jax.eval_shape(lambda: lm.init_params(jax.random.key(0), cfg))
        dense = sum(leaf.size * leaf.dtype.itemsize
                    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
                    if getattr(path[-1], "key", None) not in _EXPERT_LEAVES)
        if dense / mesh.shape.get("model", 1) > 10 * 2**30:
            ctx = make_decode_2d_ctx(mesh)
        sp = shp.SHAPES["decode_32k"]
        specs = shp.input_specs(cfg, "decode_32k")
        cache = jax.eval_shape(lambda: lm.init_cache(cfg, sp.global_batch, sp.seq_len))
        inp = specs["inputs"]
        inp_sh = NamedSharding(mesh, D.sanitize_spec(
            P(ctx.dp, *([None] * (inp.ndim - 1))), inp.shape, mesh))
        return (per_device(params, param_shardings(params, mesh, ctx, inference=True))
                + per_device(cache, D._cache_shardings(cache, cfg, mesh, ctx, long=False))
                + per_device(inp, inp_sh) + per_device(specs["pos"], NamedSharding(mesh, P())))

    out = {}
    for mesh_name in ("h100", "pod", "multipod"):
        mesh = None if mesh_name == "h100" else make_production_mesh(
            multi_pod=mesh_name == "multipod")
        dp = 1 if mesh is None else D._dp_total(mesh)
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for shape in shp.SHAPES:
                n_micro, c = plan(cfg, shape, dp)
                row = dict(status=shp.cell_status(cfg, shape), n_micro=n_micro,
                           groups=c.moe.groups if c.moe else None)
                if mesh is not None and row["status"] is None and shape == "train_4k":
                    row["bytes"] = train_bytes(c, n_micro, mesh, make_ctx(mesh))
                if mesh is not None and row["status"] is None and shape == "decode_32k":
                    row["bytes"] = decode_bytes(c, mesh, make_ctx(mesh))
                out[f"{mesh_name}/{arch}/{shape}"] = row
    json.dump(out, sys.stdout)
""")


@pytest.fixture(scope="module")
def reference():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", "/tmp")}
    res = subprocess.run([sys.executable, "-c", _REFERENCE], capture_output=True, text=True,
                         env=env, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout)


@pytest.fixture()
def art_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "ART_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
def test_the_accounting_sweep_equals_the_reference(reference, art_dir, mesh_name):
    assert D.main(["--mesh", mesh_name]) == 0
    files = sorted((art_dir / mesh_name).glob("*.json"))
    assert len(files) == 40
    for arch in ARCH_IDS:
        for shape in shp.SHAPES:
            art = json.loads((art_dir / mesh_name / f"{arch}__{shape}.json").read_text())
            want = reference[f"{mesh_name}/{arch}/{shape}"]
            assert art["n_chips"] == (256 if mesh_name == "pod" else 512)
            if want["status"] is not None:
                assert art["status"] == want["status"]
                continue
            assert art["status"] == D.ACCOUNTED and "roofline" not in art
            assert art.get("n_micro") == want["n_micro"], (arch, shape)
            assert art.get("moe_groups") == want["groups"], (arch, shape)
            if "bytes" in want:
                assert art["memory"]["argument_bytes"] == want["bytes"], (arch, shape)
            assert art["memory"]["argument_bytes"] == sum(art["memory"]["arguments"].values())
    # the layout the reference picks for decode: flat 2D for the dense 340B
    nemo = json.loads((art_dir / mesh_name / "nemotron_4_340b__decode_32k.json").read_text())
    granite = json.loads((art_dir / mesh_name / "granite_3_2b__decode_32k.json").read_text())
    assert (nemo["layout"], granite["layout"]) == ("decode_2d", "inference")


def test_the_h100_plan_and_cut_on_meta(reference):
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in shp.SHAPES:
            want = reference[f"h100/{arch}/{shape}"]
            assert shp.cell_status(cfg, shape) == want["status"]
            if want["status"] is not None:
                continue
            cell = D.plan_cell(cfg, shape, dp=1)
            assert cell.n_micro == want["n_micro"]
            assert (cell.cfg.moe.groups if cell.cfg.moe else None) == want["groups"]
            try:
                cut, full, reduced = D.cut_cell(cfg, shape)
            except D.DoesNotFit:
                assert (arch, shape) == ("nemotron_4_340b", "train_4k")
                continue
            args, peak = D.estimate_peak_bytes(cut)
            assert peak <= D.FIT_BYTES and full["argument_bytes"] >= args
            sp = shp.SHAPES[shape]
            assert sp.global_batch % cut.spec.global_batch == 0
            assert cut.spec.global_batch * sp.seq_len <= D.STEP_TOKENS.get(sp.kind, 10**12) or \
                cut.spec.global_batch == 1
            assert (reduced is None) == (full["fits"] and cut.spec == sp
                                         and cut.cfg.n_layers == cfg.n_layers)
            if cut.cfg.n_layers < cfg.n_layers:
                assert cut.spec.global_batch == 1 and "memory" in reduced["by"]
    # the phase-34 cells keep every layer; the batch is cut as stated
    cuts = {s: D.cut_cell(get_config("granite_3_2b"), s)[2]
            for s in ("decode_32k", "prefill_32k", "train_4k")}
    assert [(r["batch"], r["layers"], r["by"]) for r in cuts.values()] == [
        (16, 40, ["memory"]), (1, 40, ["step tokens"]), (4, 40, ["step tokens"])]
    recur = get_config("recurrentgemma_9b")
    assert D.cut_cell(recur, "prefill_32k")[2]["layers"] == 38
    assert D.cut_cell(recur, "long_500k")[2] is None


def test_step_cost_keywords_default_to_the_reference_counts():
    for arch in ("granite_3_2b", "qwen3_moe_235b_a22b", "recurrentgemma_9b"):
        cfg = get_config(arch)
        for shape, sp in shp.SHAPES.items():
            for n, dp in ((256, 16), (512, 32)):
                a = fl.step_cost(cfg, shape, n)
                b = fl.step_cost(cfg, sp, n, dp=dp)
                assert (a.total_flops, a.hbm_bytes, a.detail) == (b.total_flops, b.hbm_bytes,
                                                                  b.detail)
        cut = dataclasses.replace(shp.SHAPES["train_4k"], global_batch=4)
        c = fl.step_cost(cfg, cut, 1, dp=1)
        full = fl.step_cost(cfg, "train_4k", 1, dp=1)
        assert c.total_flops * 64 == pytest.approx(full.total_flops, rel=1e-12)


def test_the_leap_cells_and_a_cell_too_large_for_one_card(art_dir):
    assert D.main(["--leap", "--mesh", "pod"]) == 0
    for backend in D.LEAP_BACKENDS:
        art = json.loads((art_dir / "pod" / f"leap_migration__{backend}.json").read_text())
        assert art["status"] == D.ACCOUNTED and art["memory"]["regions"] == 16
        assert art["memory"]["pool_shard_bytes"] == 64 * 46 * 2 * 64 * 16 * 128 * 2
    art = D.run_cell("nemotron_4_340b", "train_4k", "h100", device="cpu")
    assert art["status"] == D.SKIP_ONE_CARD and "batch 1" in art["reason"]
    assert D.run_cell("granite_3_2b", "long_500k", "h100", device="cpu")["status"] == shp.SKIP


def test_the_h100_mesh_needs_the_card(art_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.run_cell("granite_3_2b", "decode_32k", "h100", force=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.main(["--arch", "granite_3_2b", "--shape", "decode_32k"])


def test_a_measured_cpu_run_writes_the_full_schema(art_dir, monkeypatch):
    monkeypatch.setattr(D, "FIT_BYTES", 100 * 2**20)  # cut a reduced cell to a few sequences
    cfg = reduce(get_config("granite_3_2b"))
    monkeypatch.setattr(D, "get_config", lambda arch: cfg)
    art = D.run_cell("granite_3_2b", "decode_32k", "h100", force=True, device="cpu")
    assert art["status"] == "OK", art.get("traceback")
    assert art["config"] == cfg.name and art["n_chips"] == 1
    red = art["reduced"]
    assert red["of_batch"] == 128 and 1 <= red["batch"] < 128 and red["by"] == ["memory"]
    assert art["full"]["fits"] is False and art["full"]["n_layers"] == cfg.n_layers
    for k in ("build_s", "first_step_s", "flops_per_device", "bytes_per_device",
              "model_flops", "wire_bytes_per_device", "hbm_detail", "accounting"):
        assert k in art, k
    assert set(art["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes", "per_device_total"}
    # the allocator's counts exist on the card only
    assert art["memory"]["argument_bytes"] is None and art["memory"]["alias_bytes"] > 0
    assert set(art["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant",
                                    "step_time_s", "useful_flops_ratio", "roofline_fraction"}
    assert art["roofline"]["collective_s"] == 0 and art["roofline"]["dominant"] == "memory"
    assert art["wire_bytes_per_device"] == 0 and art["collectives"]["n_ops"] == 0
    m = art["measured"]
    assert m["device"] == "cpu" and len(m["steps_ms"]) == D.TIMED_STEPS["decode"]
    assert m["step_ms"] == sorted(m["steps_ms"])[len(m["steps_ms"]) // 2]
    assert art["first_step_s"] > 0  # the warm-up, timed on its own
    assert m["device_ms"] is None and m["busy"] is None and m["busy_profiled"] is None
    assert m["kernel_classes"] == {}
    trace = T.read(str(art_dir / "h100" / m["trace"]))
    assert any(e.get("name") == "aten::bmm" or e.get("name") == "aten::einsum"
               for e in trace["traceEvents"])
    sp = dataclasses.replace(shp.SHAPES["decode_32k"], global_batch=red["batch"])
    assert art["flops_per_device"] == fl.step_cost(cfg, sp, 1, dp=1).total_flops
    # idempotent: the artifact is read back unless forced
    assert D.run_cell("granite_3_2b", "decode_32k", "h100", device="cpu") == art
