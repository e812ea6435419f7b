"""The model's sharding over a device mesh, on the CPU, against the JAX package.

The JAX side runs in one subprocess on 8 host devices (``tests/conftest.py``
holds this process to one JAX device); the port's side runs on a
``DeviceMesh`` of 8 CPU positions in this process.  Both start from the same
state: the JAX ``init_train_state`` leaves, written by this process and
read by the subprocess, carried into the port with ``train_state_from_numpy``.

* the sharded train step (4 x 2 ``("data", "model")``, ``n_micro=2``, batch
  8 x 32, two steps) of reduced granite, recurrentgemma_9b and
  qwen3_moe_235b_a22b (``moe.groups=8``: 8 routing groups of a microbatch's
  128 tokens, two a data-parallel group), and of granite with labels at
  -100 spread unevenly over the data-parallel groups: the losses within
  2e-4 and the parameters within rtol 3e-3 / atol 3e-4, the tolerances of
  the reference's ``tests/test_multidevice.py:73``;
* gemma2 reduced to 4 layers, placed with ``inference=True``, decoding
  under ``make_ctx`` and ``make_decode_2d_ctx``: logits within 1e-5 of the
  JAX single-device ``decode_step`` (f32; the data-parallel groups' products
  over fewer rows sum in another order);
* a checkpoint restored across mesh shapes (``tests/test_elastic.py:35``):
  written by the JAX package under 4 x 2 and by the port under 4 x 2, each
  restored onto a port 2 x 4 mesh bit for bit, then one finite step;
* ``quantized_mean`` over the data axis against the reference's
  ``shard_map`` path: each position's gathered int8 payload bit for bit,
  its scales bit for bit against the reference's ``quantize_int8`` and
  within 1 ulp of its jitted ``shard_map`` (XLA turns the division by 127
  into a product with the reciprocal under jit), the means within 1 ulp of
  f32;
* trap (b): a grouping that does not split over the data-parallel groups
  raises naming ``moe.groups``, and the MoE aux term is the mean over the
  reference's global groups; trap (c): the model axis computes
  tensor-parallel (a position gathers half of what a 4 x 1 lead gathers)
  and the step agrees with the 4 x 1 step to f32 rounding;
* placement: the bytes each position holds equal the dry-run's ``account``
  on ``meta``, ``shard`` then ``gather`` is the identity (Hypothesis: meshes
  of 1 to 3 axes, specs with dims they do not divide), and a mesh with the
  wrong number of devices raises.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from test_torch_driver import REPO  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.smoke import reduce as jax_reduce  # noqa: E402
from repro.distributed import collectives as jcol  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.base import get_config as torch_config  # noqa: E402
from repro_torch.configs.smoke import reduce as torch_reduce  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_device_mesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

LOSS_ATOL = 2e-4
PARAM_TOL = dict(rtol=3e-3, atol=3e-4)
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, SEQ, N_MICRO, STEPS = 8, 32, 2, 2
# the full rate from the first step: under the default 100-step warmup the
# two updates move a parameter by less than the parameter tolerance
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
# (case id, arch, config overrides, whether some labels are masked)
CASES = [
    ("granite", "granite_3_2b", dict(n_layers=2), False),
    ("recurrentgemma", "recurrentgemma_9b", {}, False),
    ("qwen3_moe", "qwen3_moe_235b_a22b", dict(moe_groups=8), False),
    ("granite_masked", "granite_3_2b", dict(n_layers=2), True),
]
ELASTIC = ("qwen2_7b", dict(n_layers=2))


def _cfgs(arch, overrides):
    kw = dict(overrides)
    groups = kw.pop("moe_groups", None)
    out = []
    for reduce, config in ((jax_reduce, jax_config), (torch_reduce, torch_config)):
        cfg = dataclasses.replace(reduce(config(arch)), **kw)
        if groups:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, groups=groups))
        out.append(cfg)
    return out


def _tcfgs():
    return (jts.TrainConfig(n_micro=N_MICRO, optimizer=jopt.OptimizerConfig(**OPT)),
            tts.TrainConfig(n_micro=N_MICRO, optimizer=topt.OptimizerConfig(**OPT)))


def _batch(cfg, seed: int, masked: bool) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    if masked:
        # each microbatch's four rows are one a data-parallel group: mask
        # most of one group's row, part of another's, none of the rest
        labels[0, 2:] = -100
        labels[1, ::3] = -100
        labels[6, 10:] = -100
    return {"inputs": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
            "labels": labels}


def _leaves(tree) -> list[np.ndarray]:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# Runs in a fresh process with 8 host devices and writes every result.
JAX_SIDE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import ckpt
from repro.configs.base import get_config
from repro.configs.smoke import reduce
from repro.distributed.collectives import quantize_int8, quantized_mean
from repro.distributed.sharding import make_ctx, param_shardings, use_ctx
from repro.train.optimizer import OptimizerConfig
from repro.train.train_step import TrainConfig, TrainState, init_train_state, train_step

d, p = np.load(sys.argv[1]), json.loads(sys.argv[2])
out = {}


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def config(arch, overrides):
    kw = dict(overrides)
    groups = kw.pop("moe_groups", None)
    cfg = dataclasses.replace(reduce(get_config(arch)), **kw)
    if groups:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, groups=groups))
    return cfg


def state_of(name, cfg, tcfg):
    shape = jax.eval_shape(lambda: init_train_state(jax.random.key(0), cfg, tcfg))
    leaves, treedef = jax.tree.flatten(shape)
    return jax.tree.unflatten(treedef, [jnp.asarray(d[f"{name}_init_{i}"])
                                        for i in range(len(leaves))])


def shardings(state, mesh):
    ctx = make_ctx(mesh)
    return ctx, TrainState(
        params=param_shardings(state.params, mesh, ctx),
        opt={"m": param_shardings(state.opt["m"], mesh, ctx),
             "v": param_shardings(state.opt["v"], mesh, ctx),
             "step": NamedSharding(mesh, P())})


mesh = mesh_of((4, 2))
for name, arch, overrides, _ in p["cases"]:
    cfg = config(arch, overrides)
    tcfg = TrainConfig(n_micro=p["n_micro"], optimizer=OptimizerConfig(**p["opt"]))
    ctx, ssh = shardings(state_of(name, cfg, tcfg), mesh)
    bsh = {k: NamedSharding(mesh, P(("data",), None)) for k in ("inputs", "labels")}
    batch = {k: jnp.asarray(d[f"{name}_{k}"]) for k in ("inputs", "labels")}
    state = jax.device_put(state_of(name, cfg, tcfg), ssh)
    with use_ctx(ctx), jax.set_mesh(mesh):
        step = jax.jit(lambda s, b: train_step(s, b, cfg, tcfg), in_shardings=(ssh, bsh))
        for i in range(p["steps"]):
            state, metrics = step(state, jax.device_put(batch, bsh))
            out[f"{name}_loss_{i}"] = np.asarray(metrics["loss"])
    for i, x in enumerate(jax.tree.leaves(state.params)):
        out[f"{name}_params_{i}"] = np.asarray(x)

# a checkpoint written under 4 x 2 (f32 leaves: ROADMAP.md R6)
arch, overrides = p["elastic"]
cfg = config(arch, overrides)
tcfg = TrainConfig(optimizer=OptimizerConfig())
_, ssh = shardings(state_of("elastic", cfg, tcfg), mesh)
ckpt.save(p["ckpt_dir"], 7, jax.device_put(state_of("elastic", cfg, tcfg), ssh))

# quantized_mean over the data axis, inside shard_map
from jax import shard_map


def local(x):
    # each position's gathered payload [n, *local] as its block [1, 1, n, ...]
    q, s = quantize_int8(x)
    q = jax.lax.all_gather(q, "data")
    return (q.reshape((1, 1, q.shape[0]) + x.shape[2:]),
            jax.lax.all_gather(s, "data").reshape(1, 1, -1),
            quantized_mean({"g": x}, "data")["g"])


spec = P("data", "model")
fn = jax.jit(shard_map(local, mesh=mesh, in_specs=spec, out_specs=(spec, spec, spec)))
for key in ("qm_f32", "qm_bf16"):
    x = jax.device_put(jnp.asarray(d[key]).astype(jnp.bfloat16 if key == "qm_bf16"
                                                    else jnp.float32),
                       NamedSharding(mesh, spec))
    q, s, mean = fn(x)
    out[f"{key}_q"], out[f"{key}_s"] = np.asarray(q), np.asarray(s)
    out[f"{key}_mean"] = np.asarray(mean.astype(jnp.float32))
np.savez(sys.argv[3], **out)
"""


def _port_mesh(shape=(4, 2)):
    return make_device_mesh(shape, ("data", "model"), ["cpu"] * 8)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread, as in ``tests/test_torch_train.py``: beside other
    pytest workers the tiny models' threads wait on one another at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Every case on both packages: the JAX package's in one 8-device
    subprocess, the port's in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("model_sharding")
    inputs, port_cases = {}, {}
    for name, arch, overrides, masked in CASES:
        jcfg, _ = _cfgs(arch, overrides)
        jstate = jts.init_train_state(jax.random.key(0), jcfg, _tcfgs()[0])
        inputs.update({f"{name}_init_{i}": x for i, x in enumerate(_leaves(jstate))})
        batch = _batch(jcfg, 0, masked)
        inputs.update({f"{name}_{k}": v for k, v in batch.items()})
    ecfg = _cfgs(*ELASTIC)[0]
    estate = jts.init_train_state(jax.random.key(0), ecfg, jts.TrainConfig())
    inputs.update({f"elastic_init_{i}": x for i, x in enumerate(_leaves(estate))})
    rng = np.random.default_rng(3)
    inputs["qm_f32"] = rng.normal(size=(4, 2, 16, 8)).astype(np.float32)
    inputs["qm_bf16"] = rng.normal(size=(4, 2, 6)).astype(np.float32)
    np.savez(tmp / "in.npz", **inputs)
    params = dict(cases=CASES, n_micro=N_MICRO, steps=STEPS, elastic=ELASTIC, opt=OPT,
                  ckpt_dir=str(tmp / "jax_ckpt"))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(tmp / "in.npz"),
         json.dumps(params), str(tmp / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"},
    )
    for name, arch, overrides, masked in CASES:
        port_cases[name] = _port_case(name, arch, overrides, masked, inputs)
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return inputs, port_cases, dict(np.load(tmp / "jax.npz")), tmp


def _jax_tree(name: str, arrays: dict, key: str, cfg, tcfg):
    """The JAX state (``key="init"``) or its params (``"params"``) from the
    flat leaves ``<name>_<key>_<i>``."""
    shape = jax.eval_shape(lambda: jts.init_train_state(jax.random.key(0), cfg, tcfg))
    tree = shape if key == "init" else shape.params
    leaves, treedef = jax.tree.flatten(tree)
    return jax.tree.unflatten(treedef, [arrays[f"{name}_{key}_{i}"] for i in range(len(leaves))])


def _port_case(name, arch, overrides, masked, inputs) -> dict:
    jcfg, cfg = _cfgs(arch, overrides)
    jtcfg, tcfg = _tcfgs()
    state = tts.train_state_from_numpy(_jax_tree(name, inputs, "init", jcfg, jtcfg), cfg, "cpu")
    mesh = _port_mesh()
    ctx = sh.make_ctx(mesh)
    placed = sh.place(state, mesh, ctx)
    batch = {k: torch.from_numpy(inputs[f"{name}_{k}"]) for k in ("inputs", "labels")}
    losses = []
    with sh.use_ctx(ctx):
        for _ in range(STEPS):
            losses.append(float(tts.train_step(placed, batch, cfg, tcfg)[1]["loss"]))
    return dict(losses=losses, params={n: sh.gather(x, "cpu").numpy()
                                       for n, x in placed.params.leaves.items()},
                bytes=sh.position_bytes(placed))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_train_step_matches_the_jax_sharded_step(both, case):
    name, arch, overrides, _ = case
    _, port, jax_out, _ = both
    jcfg, cfg = _cfgs(arch, overrides)
    got = port[name]
    for i in range(STEPS):
        assert abs(got["losses"][i] - float(jax_out[f"{name}_loss_{i}"])) < LOSS_ATOL, (
            name, i, got["losses"][i], float(jax_out[f"{name}_loss_{i}"]))
    want = tlm.named_leaves(_jax_tree(name, jax_out, "params", jcfg, _tcfgs()[0]), cfg)
    assert sorted(want) == sorted(got["params"])
    for n, w in want.items():
        np.testing.assert_allclose(got["params"][n], w, err_msg=n, **PARAM_TOL)


def test_masked_labels_take_the_global_mean(both):
    """Trap (a): with the labels at -100 spread unevenly, the loss is the
    global masked mean, and a mean of the groups' own means is not."""
    inputs, port, jax_out, _ = both
    jcfg, cfg = _cfgs("granite_3_2b", dict(n_layers=2))
    labels = inputs["granite_masked_labels"]
    assert len({int((part >= 0).sum()) for part in np.split(labels[:4], 4)}) > 1
    state = tts.train_state_from_numpy(_jax_tree("granite_masked", inputs, "init", jcfg,
                                                 _tcfgs()[0]), cfg, "cpu")
    batch = {k: torch.from_numpy(inputs[f"granite_masked_{k}"]) for k in ("inputs", "labels")}
    per_group = []
    with torch.no_grad():
        for mb in range(N_MICRO):
            rows = slice(mb * 4, mb * 4 + 4)
            per_group.append(np.mean([float(state.params.train_loss(
                {k: v[rows][g:g + 1] for k, v in batch.items()})[0]) for g in range(4)]))
    wrong = float(np.mean(per_group))
    want = float(jax_out["granite_masked_loss_0"])
    assert abs(port["granite_masked"]["losses"][0] - want) < LOSS_ATOL
    assert abs(wrong - want) > 10 * LOSS_ATOL


def test_per_position_bytes_equal_the_dryrun_account(both):
    from repro_torch.launch import dryrun as D

    _, port, _, _ = both
    mesh = _port_mesh()
    for name, arch, overrides, _ in CASES:
        _, cfg = _cfgs(arch, overrides)
        acc = D.account(D.plan_cell(cfg, "train_4k", 4), mesh)["arguments"]
        want = acc["params"] + acc["m"] + acc["v"] + acc["step"]
        assert port[name]["bytes"] == [want] * mesh.size, name


def test_gemma2_decode_on_a_mesh_matches_the_single_device_step():
    jcfg, cfg = _cfgs("gemma2_27b", dict(n_layers=4))
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    model = tlm.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32) for _ in range(3)]
    jcache, want = jlm.init_cache(jcfg, BATCH, 64), []
    for pos, t in enumerate(toks):
        logits, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(t), pos, jcfg)
        want.append(np.asarray(logits))
    mesh = _port_mesh()
    for make in (sh.make_ctx, sh.make_decode_2d_ctx):
        ctx = make(mesh)
        placed = sh.place(model, mesh, ctx, inference=True)
        assert placed.leaves["blocks.0.attn.wq"].spec == (None, ctx.tp)
        with sh.use_ctx(ctx):
            caches = tlm.init_group_caches(placed, BATCH, 64)
            assert len(caches) == len(sh.dp_leads(ctx))
            for pos, t in enumerate(toks):
                logits, caches = tlm.decode_step(placed, caches, torch.from_numpy(t), pos, cfg)
                np.testing.assert_allclose(logits.numpy(), want[pos], err_msg=make.__name__,
                                           **DECODE_TOL)


def _elastic_template(cfg, tcfg):
    model = tlm.CausalLM(cfg, device="meta")
    return tts.TrainState(params=model, opt=topt.init_opt_state(model, tcfg.optimizer))


def _restore_on_2x4_and_step(directory, cfg, want: dict):
    tcfg = tts.TrainConfig()
    host, step = ckpt.restore(directory, _elastic_template(cfg, tcfg), device="cpu")
    assert step == 7
    mesh = _port_mesh((2, 4))
    ctx = sh.make_ctx(mesh)
    placed = sh.place(host, mesh, ctx)
    for n, w in want.items():
        np.testing.assert_array_equal(sh.gather(placed.params.leaves[n], "cpu").numpy(), w,
                                      err_msg=n)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32))
             for k in ("inputs", "labels")}
    with sh.use_ctx(ctx):
        assert np.isfinite(float(tts.train_step(placed, batch, cfg, tcfg)[1]["loss"]))


def test_checkpoints_restore_across_mesh_shapes(both, tmp_path):
    inputs, _, _, tmp = both
    jcfg, cfg = _cfgs(*ELASTIC)
    jstate = _jax_tree("elastic", inputs, "init", jcfg, jts.TrainConfig())
    want = tlm.named_leaves(jstate.params, cfg)
    # written by the JAX package under 4 x 2
    _restore_on_2x4_and_step(str(tmp / "jax_ckpt"), cfg, want)
    # written by the port under 4 x 2
    mesh = _port_mesh()
    state = tts.train_state_from_numpy(jstate, cfg, "cpu")
    ckpt.save(str(tmp_path), 7, sh.place(state, mesh, sh.make_ctx(mesh)))
    _restore_on_2x4_and_step(str(tmp_path), cfg, want)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


def test_quantized_mean_over_the_data_axis_matches_shard_map(both):
    inputs, _, jax_out, _ = both
    mesh = _port_mesh()
    with sh.use_ctx(sh.make_ctx(mesh)):
        for key, dtype in (("qm_f32", torch.float32), ("qm_bf16", torch.bfloat16)):
            x = sh.shard(torch.from_numpy(inputs[key]).to(dtype), ("data", "model"), mesh)
            gathered = col.all_gather_int8(x, "data")
            mean = col.quantized_mean({"g": x}, "data")["g"]
            assert mean.dtype == dtype and mean.spec == x.spec
            for pos in range(mesh.size):
                d, m = sh.coords(mesh, pos)
                q, s = gathered[pos]
                np.testing.assert_array_equal(q.flatten(0, 2).numpy(), jax_out[f"{key}_q"][d, m])
                # the reference's own quantize_int8 on each gathered block, bit
                # for bit; its jitted shard_map within 1 ulp, since under jit
                # XLA multiplies by 1/127 where eager JAX and the port divide
                blocks = [jax.device_put(np.asarray(inputs[key][d2:d2 + 1, m:m + 1]))
                          for d2 in range(4)]
                if dtype == torch.bfloat16:
                    blocks = [b.astype(jnp.bfloat16) for b in blocks]
                eager = np.stack([np.asarray(jcol.quantize_int8(b)[1]) for b in blocks])
                np.testing.assert_array_equal(s.numpy(), eager)
                assert _ulps(s.numpy(), jax_out[f"{key}_s"][d, m]) <= 1, (key, pos)
                got = mean.shards[pos].float().numpy()
                assert _ulps(got, jax_out[f"{key}_mean"][d:d + 1, m:m + 1]) <= 1, (key, pos)


def test_quantized_mean_refuses_an_axis_the_mesh_lacks():
    mesh = _port_mesh()
    x = sh.shard(torch.ones(4, 2), ("data", "model"), mesh)
    with sh.use_ctx(sh.make_ctx(mesh)):
        with pytest.raises(ValueError, match="no axis 'pod'"):
            col.quantized_mean({"g": x}, "pod")
        with pytest.raises(TypeError, match="Sharded leaves"):
            col.quantized_mean({"g": torch.ones(3)}, "data")
    with pytest.raises(ValueError, match="DeviceMesh"):
        col.quantized_mean({"g": x}, "data")  # no ctx


def test_moe_groups_that_do_not_split_over_the_data_groups_raise():
    """Trap (b): 2 routing groups of a microbatch cannot split over 4
    data-parallel groups; the step raises naming ``moe.groups``."""
    _, cfg = _cfgs("qwen3_moe_235b_a22b", dict(moe_groups=2))
    _, tcfg = _tcfgs()
    mesh = _port_mesh()
    ctx = sh.make_ctx(mesh)
    state = sh.place(tts.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg, "cpu"),
                     mesh, ctx)
    batch = {k: torch.zeros((BATCH, SEQ), dtype=torch.int32) for k in ("inputs", "labels")}
    with sh.use_ctx(ctx), pytest.raises(ValueError, match="moe.groups=2"):
        tts.train_step(state, batch, cfg, tcfg)
    assert tmoe.dp_config(cfg, 128, 1) is cfg


@pytest.mark.parametrize("groups", [4, 8, 16])
def test_moe_aux_is_the_mean_over_the_global_groups(groups):
    """Each data-parallel group routes the reference's groups in its rows:
    the outputs equal the reference's ``moe_ffn`` over the whole batch, and
    the mean of the groups' aux terms equals its aux term."""
    jcfg, cfg = _cfgs("qwen3_moe_235b_a22b", dict(moe_groups=groups))
    dp = 4
    rng = np.random.default_rng(groups)
    x = rng.normal(size=(BATCH, 16, cfg.d_model)).astype(np.float32)
    jparams = jlm.init_params(jax.random.key(1), jcfg)
    jmoe_params = jparams["period"][0]["moe"]
    want_y, want_aux = jmoe.moe_ffn(jnp.asarray(x), jax.tree.map(lambda a: a[0], jmoe_params),
                                    jcfg)
    layer = tlm.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu").blocks[0].moe
    local = tmoe.dp_config(cfg, BATCH * 16, dp)
    ys, auxes = zip(*(tmoe.moe_ffn(part, layer, local)
                      for part in torch.from_numpy(x).chunk(dp)))
    np.testing.assert_allclose(torch.cat(ys).numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(torch.stack(auxes).mean()), float(want_aux), rtol=1e-6)


def test_tensor_parallel_specs_change_no_value():
    """Trap (c): the rules' model-axis specs now split the products.  The same
    step on a 4 x 2 and on a 4 x 1 mesh (the same four data-parallel
    groups, the model axis gone): on 4 x 2 a group's second position gathers
    its half of every split leaf (the lead its half and the leaves that stay
    whole), short of what the 4 x 1 lead gathers; the loss agrees within
    rtol 1e-6, the gradient norm within rtol 1e-5 and the parameters within
    rtol 1e-4 / atol 5e-5 (f32: the split products add their partial sums
    in another order, and Adam's first step moves an element whose
    gradient sits near eps by up to lr, 1e-3, on a last-bit difference)."""
    from repro_torch.distributed import collectives as tcol

    _, cfg = _cfgs("granite_3_2b", dict(n_layers=2))
    _, tcfg = _tcfgs()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 5, False).items()}
    out = []
    for shape in ((4, 2), (4, 1)):
        mesh = make_device_mesh(shape, ("data", "model"), ["cpu"] * (4 * shape[1]))
        ctx = sh.make_ctx(mesh)
        assert sh.tp_worthwhile((BATCH, SEQ, cfg.d_model), 10**9) is False  # no ctx yet
        state = sh.place(tts.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg, "cpu"),
                         mesh, ctx)
        sh.gathered_bytes.clear()
        tcol.counts.clear()
        with sh.use_ctx(ctx):
            metrics = tts.train_step(state, batch, cfg, tcfg)[1]
        out.append((metrics, {n: sh.gather(x, "cpu") for n, x in state.params.leaves.items()},
                    dict(sh.gathered_bytes), tcol.counts["all_reduce"]))
    (tp_metrics, tp_params, tp_bytes, tp_reduces), (dp_metrics, dp_params, dp_bytes,
                                                    dp_reduces) = out
    assert tp_reduces > 0 and dp_reduces == 0
    assert sorted(dp_bytes) == [0, 1, 2, 3] and sorted(tp_bytes) == list(range(8))
    for d in range(4):  # a group's positions against the 4 x 1 lead
        assert max(tp_bytes[2 * d], tp_bytes[2 * d + 1]) < 0.6 * dp_bytes[d]
    torch.testing.assert_close(tp_metrics["loss"], dp_metrics["loss"], rtol=1e-6, atol=0)
    torch.testing.assert_close(tp_metrics["grad_norm"], dp_metrics["grad_norm"], rtol=1e-5,
                               atol=0)
    for n, p in tp_params.items():
        torch.testing.assert_close(p, dp_params[n], rtol=1e-4, atol=5e-5, msg=n)


def test_a_mesh_needs_one_device_a_position():
    with pytest.raises(ValueError, match="7 devices for a mesh of 8 positions"):
        make_device_mesh((4, 2), ("data", "model"), ["cpu"] * 7)
    with pytest.raises(ValueError, match="not on this host"):
        make_device_mesh((2,), ("data",), ["cpu", f"cuda:{torch.cuda.device_count()}"])
    with pytest.raises(ValueError, match="no devices"):
        sh.shard(torch.ones(4), ("data",), sh.MeshShape((4,), ("data",)))


AXES = ("pod", "data", "model")


@st.composite
def _layouts(draw):
    """A mesh of 1 to 3 axes, a tensor of rank 0 to 3 and a spec that uses
    each axis at most once (dims it does not divide among them)."""
    n = draw(st.integers(1, 3))
    names = AXES[-n:]
    sizes = tuple(draw(st.sampled_from((1, 2, 3, 4))) for _ in names)
    shape = tuple(draw(st.lists(st.sampled_from((1, 2, 3, 4, 6, 8, 12)), max_size=3)))
    free, spec = list(draw(st.permutations(names))), []
    for _ in shape:
        k = draw(st.integers(0, min(2, len(free))))
        taken, free = free[:k], free[k:]
        spec.append(None if not taken else taken[0] if k == 1 else tuple(taken))
    dtype = draw(st.sampled_from((torch.float32, torch.bfloat16, torch.int32)))
    return sizes, names, shape, tuple(spec), dtype


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_layouts())
def test_shard_then_gather_is_the_identity(layout):
    sizes, names, shape, spec, dtype = layout
    mesh = make_device_mesh(sizes, names, ["cpu"] * math.prod(sizes))
    t = (torch.arange(math.prod(shape), dtype=torch.float32) - 7).reshape(shape).to(dtype)
    x = sh.shard(t, spec, mesh)
    assert x.spec == sh.sanitize_spec(spec, shape, mesh)
    want_local = sh.shard_shape(shape, x.spec, mesh)
    for pos, s in enumerate(x.shards):
        assert tuple(s.shape) == want_local and s.dtype == dtype
        assert torch.equal(s, t[x.slices[pos]])
    assert torch.equal(sh.gather(x, "cpu"), t)


def test_a_vocab_the_axes_do_not_divide_is_copied():
    """49,155 rows (granite's vocabulary) do not split 2 ways: the rule's
    model axis is dropped from the embedding's rows, which every model
    position then holds whole, and the bytes a position equal the dry-run's
    reckoning on ``meta``."""
    mesh = _port_mesh()
    ctx = sh.make_ctx(mesh)
    t = torch.arange(49155 * 8, dtype=torch.float32).reshape(49155, 8)
    x = sh.place({"embed": t}, mesh, ctx)["embed"]
    assert x.spec == (None, "data")
    assert x.owners == [0, 2, 4, 6]
    assert torch.equal(sh.gather(x, "cpu"), t)
    assert sh.position_bytes({"embed": x}) == [49155 * 2 * 4] * 8


def test_constrain_params_reduces_into_shards():
    """Under a ``DeviceMesh`` ctx ``constrain_params`` reduces whole gradients
    into the accumulator's shards in its dtype, each position adding its
    slice; without an accumulator it changes no value."""
    mesh = _port_mesh()
    ctx = sh.make_ctx(mesh)
    g = {"blocks.0.attn.wq": torch.randn(8, 6), "blocks.0.norm1": torch.randn(8)}
    acc = {n: x.zeros(torch.float64) for n, x in sh.place(g, mesh, ctx).items()}
    assert (acc["blocks.0.attn.wq"].spec, acc["blocks.0.norm1"].spec) == (("data", "model"),
                                                                          (None,))
    with sh.use_ctx(ctx):
        assert sh.constrain_params(g) is g
        for _ in range(2):
            assert sh.constrain_params(g, into=acc) is acc
    assert torch.equal(sh.gather(acc["blocks.0.attn.wq"], "cpu"), 2 * g["blocks.0.attn.wq"].double())
    assert torch.equal(sh.gather(acc["blocks.0.norm1"], "cpu"), 2 * g["blocks.0.norm1"].double())
    assert all(torch.equal(s, acc["blocks.0.norm1"].shards[0])
               for s in acc["blocks.0.norm1"].shards)
    with pytest.raises(ValueError, match="DeviceMesh"):
        sh.constrain_params(g, into=acc)  # no ctx


def test_a_batch_the_data_groups_do_not_divide_raises():
    """A microbatch's rows split evenly over the data-parallel groups or the
    step raises naming the dim; no path gathers onto one position instead."""
    _, cfg = _cfgs("granite_3_2b", dict(n_layers=2))
    _, tcfg = _tcfgs()
    mesh = _port_mesh()
    ctx = sh.make_ctx(mesh)
    state = sh.place(tts.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg, "cpu"),
                     mesh, ctx)
    batch = {k: torch.zeros((6, SEQ), dtype=torch.int32) for k in ("inputs", "labels")}
    with sh.use_ctx(ctx), pytest.raises(ValueError, match=r"3 rows of 'inputs' \(dim 0\)"):
        tts.train_step(state, batch, cfg, tcfg)
    with pytest.raises(ValueError, match="ctx over that mesh"):
        tts.train_step(state, {k: v[:4] for k, v in batch.items()}, cfg, tcfg)  # no ctx
