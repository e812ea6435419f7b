"""Expert-stationary MoE decode on the CPU, against the JAX package.

The port's side runs on the 8-position CPU ``DeviceMesh`` of
``tests/test_torch_seq_parallel.py`` (4 x 2 ``("data", "model")``), the
model placed with ``inference=True``: each data-parallel group's positions
hold the group's block of the experts (``E`` over the data axis) and each
position its block of their hidden dim (``d_ff`` over the model axis), the
reference's ``_EXPERT_INFERENCE``.  ``moe.groups`` is set as the dry-run
sets it for a decode cell, ``max(dp, B // 512)`` with
``dispatch_mode="tokens"``.  The JAX side runs on this process's one JAX
device (``tests/conftest.py``), where ``constrain`` is the identity, so its
``decode_step`` computes the ``"tokens"`` branch's arithmetic, from the same
seeded parameters (carried with ``lm.params_from_numpy``):

* reduced qwen3_moe_235b_a22b and dbrx_132b (4 experts, top 2) in f32: the
  JAX ``prefill``'s cache carried in with ``lm.place_group_caches``, then
  10 decode steps under ``make_ctx`` (experts over the 4 groups, ``d_ff``
  over 2 positions, two all-to-alls a MoE layer a step) and
  ``make_decode_2d_ctx`` (experts whole, ``d_ff`` over 8 positions, none):
  logits within 1e-5 of the jitted single-device ``decode_step``;
* capacity factor 0.5: picks dropped, each routing group's dispatch equal
  to the reference's ``route`` on the same gates, logits within 1e-5;
* 6 experts over 4 groups: the experts whole on every group, ``d_ff``
  still split, no all-to-all;
* binding: each position's expert regions are exactly its own shard,
  bound without a copy, never a whole leaf on a lead, and their bytes
  equal the dry-run's per-device expert bytes of a decode cell of the same
  shape (``launch/dryrun.py`` ``account``'s rule);
* a MoE layer laid out in neither layout raises, and so does training a
  model placed for decode;
* ``collectives.all_to_all`` against a plain block transpose;
* reduced qwen3_moe under ``make_ctx`` against the reference's own sharded
  decode step on 8 host devices in a subprocess (``param_shardings(...,
  inference=True)`` and the dry-run's cache and input shardings).
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
from test_torch_driver import REPO  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.smoke import reduce as jax_reduce  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import make_device_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import tensor_parallel as tp  # noqa: E402

DECODE_TOL = dict(rtol=1e-5, atol=1e-5)
# a prompt of 4, then 10 steps (positions 4-13) in 16 slots
BATCH, PROMPT, STEPS, MAX_LEN, DP = 8, 4, 10, 16, 4
EXPERT_LEAVES = ("e_gate", "e_in", "e_out")
ARCHS = ("qwen3_moe_235b_a22b", "dbrx_132b")
CTXS = [sh.make_ctx, sh.make_decode_2d_ctx]
# the dry-run's decode-cell grouping: max(dp, B // 512) routing groups
GROUPS = max(DP, BATCH // 512)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe_cfg(cfg, **moe_overrides):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, groups=GROUPS, dispatch_mode="tokens", **moe_overrides))


def _cfgs(arch, **moe_overrides):
    return (_moe_cfg(jax_reduce(jax_config(arch)), **moe_overrides),
            _moe_cfg(reduce(get_config(arch)), **moe_overrides))


def _mesh():
    return make_device_mesh((4, 2), ("data", "model"), ["cpu"] * 8)


def _layer_caches(jcache, cfg) -> list[dict]:
    """The JAX cache in layer order, period entries unstacked, as tensors."""
    per = len(cfg.layer_pattern)
    layers = [{k: v[rep] for k, v in jcache["period"][pos].items()}
              for rep in range(cfg.repeats) for pos in range(per)] + list(jcache["tail"])
    return [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()} for layer in layers]


_CASES = {}


def _case(arch, **moe_overrides):
    """Configs, the port's model, a prompt's JAX cache in layer order, the
    steps' tokens and the JAX single-device logits of each step (cached: the
    contexts share them)."""
    key = (arch, tuple(sorted(moe_overrides.items())))
    if key not in _CASES:
        jcfg, cfg = _cfgs(arch, **moe_overrides)
        jparams = jlm.init_params(jax.random.key(0), jcfg)
        model = lm.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
        rng = np.random.default_rng(2)
        prompt = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
        toks = [rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
                for _ in range(STEPS)]
        _, jcache = jax.jit(lambda p, x: jlm.prefill(p, x, jcfg, MAX_LEN))(jparams,
                                                                         jnp.asarray(prompt))
        cache, want = _layer_caches(jcache, cfg), []
        step = jax.jit(lambda p, c, x, pos: jlm.decode_step(p, c, x, pos, jcfg))
        for i, t in enumerate(toks):
            logits, jcache = step(jparams, jcache, jnp.asarray(t), jnp.int32(PROMPT + i))
            want.append(np.asarray(logits))
        _CASES[key] = (jcfg, cfg, model, cache, toks, want)
    return _CASES[key]


def _decode(cfg, model, cache, toks, make, per_step=None):
    """10 placed decode steps from ``cache`` under ``make``'s ctx: each
    step's logits, and ``per_step()`` read after each step (the collectives
    counted from 0 just before it)."""
    mesh = _mesh()
    ctx = make(mesh)
    placed = sh.place(model, mesh, ctx, inference=True)
    out, seen = [], []
    with sh.use_ctx(ctx):
        caches = lm.place_group_caches(placed, [dict(layer) for layer in cache])
        for i, t in enumerate(toks):
            col.counts.clear()
            logits, caches = lm.decode_step(placed, caches, torch.from_numpy(t), PROMPT + i, cfg)
            out.append(logits.numpy())
            if per_step is not None:
                seen.append(per_step())
    return out, seen


def _moe_layers(cfg) -> int:
    return cfg.layer_kinds.count("moe")


@pytest.mark.parametrize("make", CTXS, ids=[m.__name__ for m in CTXS])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch, make):
    _, cfg, model, cache, toks, want = _case(arch)
    got, a2a = _decode(cfg, model, cache, toks, make, lambda: col.counts["all_to_all"])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"{make.__name__} step {i}", **DECODE_TOL)
    # E = 4 over 4 groups: a token all-to-all to the experts and one back, a
    # MoE layer a step; on 8 flat positions the experts are whole, none
    n = 2 * _moe_layers(cfg) if make is sh.make_ctx else 0
    assert a2a == [n] * STEPS


@pytest.mark.parametrize("make", CTXS, ids=[m.__name__ for m in CTXS])
def test_picks_dropped_over_capacity_are_the_references(make, monkeypatch):
    """Capacity factor 0.5 (one slot an expert for a routing group's 2
    tokens x 2 picks): picks drop, each routing group's dispatch equals the
    reference's ``route`` on the same gates, and the logits still agree."""
    jcfg, cfg, model, cache, toks, want = _case("qwen3_moe_235b_a22b", capacity_factor=0.5)
    seen, real = [], moe.route_slots

    def recording(gates, mc, cap):
        out = real(gates, mc, cap)
        seen.append((gates.clone(), cap))
        return out

    monkeypatch.setattr(moe, "route_slots", recording)
    got, _ = _decode(cfg, model, cache, toks, make)
    monkeypatch.undo()
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"{make.__name__} step {i}", **DECODE_TOL)
    dropped = 0
    for gates, cap in seen:
        assert cap == 1
        for row in gates:  # one routing group's [T, E]
            jd, jc, _ = jmoe.route(jnp.asarray(row.numpy()), jcfg.moe, cap)
            pd, pc, _ = moe.route(row, cfg.moe, cap)
            np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
            np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-6, atol=0)
            dropped += row.shape[0] * cfg.moe.top_k - int(np.asarray(jd).sum())
    assert dropped > 0
    # every routing group of every MoE layer and step: 4 a step on either ctx
    assert len(seen) == STEPS * _moe_layers(cfg) * (DP if make is sh.make_ctx else 1)


@pytest.mark.parametrize("make", CTXS, ids=[m.__name__ for m in CTXS])
def test_experts_the_groups_do_not_divide_stay_whole(make):
    """6 experts do not split over 4 groups: every group holds every expert,
    ``d_ff`` still splits over its positions, and nothing is traded."""
    _, cfg, model, cache, toks, want = _case("qwen3_moe_235b_a22b", n_experts=6)
    mesh = _mesh()
    ctx = make(mesh)
    placed = sh.place(model, mesh, ctx, inference=True)
    n = len(sh.tp_peers(ctx, 0))
    with sh.use_ctx(ctx):
        plan = tp.plan(placed, ctx, (BATCH, 1, cfg.d_model))
    assert sorted(plan.stationary) == [i for i, k in enumerate(cfg.layer_kinds) if k == "moe"]
    for st in plan.stationary.values():
        assert st.experts == [(0, 6)] * len(sh.dp_leads(ctx)) and st.exchanges == []
        f = cfg.moe.d_ff
        assert st.hidden == [(t * f // n, (t + 1) * f // n) for t in range(n)]
    got, a2a = _decode(cfg, model, cache, toks, make, lambda: col.counts["all_to_all"])
    assert a2a == [0] * STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"{make.__name__} step {i}", **DECODE_TOL)


def _dryrun_expert_bytes(cfg, mesh, ctx) -> int:
    """The dry-run's per-device bytes of the expert leaves of a decode cell of
    this batch (``account``'s ``param_shardings(..., inference=True)``
    under ``ctx``); under the ctx ``account`` picks, its ``params`` group
    is that rule's sum over every leaf."""
    cell = D.plan_cell(cfg, "decode_32k", DP, batch=BATCH)
    assert cell.cfg.moe.groups == GROUPS and cell.cfg.moe.dispatch_mode == "tokens"
    params = D.meta_arguments(cell)["params"]
    specs = sh.param_shardings(params, mesh, ctx, inference=True)

    def per_device(names):
        return sum(math.prod(sh.shard_shape(tuple(params[n].shape), specs[n], mesh))
                   * params[n].element_size() for n in names)

    if ctx.dp:  # the layout account picks for a model this size
        assert D.account(cell, mesh)["arguments"]["params"] == per_device(params)
    return per_device([n for n in params if n.rsplit(".", 1)[-1] in EXPERT_LEAVES])


@pytest.mark.parametrize("make", CTXS, ids=[m.__name__ for m in CTXS])
def test_each_position_binds_its_own_expert_shard(make, monkeypatch):
    """The plan's expert region of every position is exactly the shard it
    holds, never a whole leaf where the layout splits it; a step binds each
    of them from that shard without a copy (no ``gather_region`` of an
    expert leaf), and a position's expert bytes equal the dry-run's."""
    _, cfg, model, cache, toks, _ = _case("qwen3_moe_235b_a22b")
    mesh = _mesh()
    ctx = make(mesh)
    placed = sh.place(model, mesh, ctx, inference=True)
    experts = {id(x): n for n, x in placed.leaves.items() if n.rsplit(".", 1)[-1] in EXPERT_LEAVES}
    leads = sh.dp_leads(ctx)
    with sh.use_ctx(ctx):
        plan = tp.plan(placed, ctx, (BATCH, 1, cfg.d_model))
        groups = [tp.group(placed, ctx, lead) for lead in leads]
    planned = [0] * mesh.size
    for i, st in plan.stationary.items():
        for leaf in EXPERT_LEAVES + ("router",):
            assert plan.regions[f"blocks.{i}.moe.{leaf}"] == [None] * plan.n
        for leaf in EXPERT_LEAVES:
            x = placed.leaves[f"blocks.{i}.moe.{leaf}"]
            for g, grp in enumerate(groups):
                for t, pos in enumerate(grp.positions):
                    region = st.region(leaf, x.shape, g, t)
                    assert region == x.slices[pos], (leaf, g, t)
                    assert region != sh.whole(x.shape)
                    planned[pos] += math.prod(sh.region_shape(region)) * x.dtype.itemsize
    assert planned == [_dryrun_expert_bytes(cfg, mesh, ctx)] * mesh.size
    binds, copies = [0] * mesh.size, []
    real_bind, real_gather = sh.bind_region, sh.gather_region

    def bind(x, region, pos):
        if id(x) in experts:
            assert tuple(region) == x.slices[pos]
            binds[pos] += math.prod(sh.region_shape(region)) * x.dtype.itemsize
        return real_bind(x, region, pos)

    def gather(x, region, pos):
        copies.append(experts.get(id(x)))
        return real_gather(x, region, pos)

    monkeypatch.setattr(sh, "bind_region", bind)
    monkeypatch.setattr(sh, "gather_region", gather)
    with sh.use_ctx(ctx):
        caches = lm.place_group_caches(placed, [dict(layer) for layer in cache])
        lm.decode_step(placed, caches, torch.from_numpy(toks[0]), PROMPT, cfg)
    assert binds == planned
    assert set(copies) <= {None}  # no expert leaf copied


def test_a_moe_layer_in_neither_layout_raises():
    """Placed for ``make_ctx``'s inference layout and decoded under
    ``make_decode_2d_ctx``, the expert leaves lie in neither of that ctx's
    layouts: the plan raises rather than run them whole.  A model placed for
    decode does not train."""
    _, cfg = _cfgs(ARCHS[0])
    mesh = _mesh()
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    placed = sh.place(model, mesh, sh.make_ctx(mesh), inference=True)
    ctx = sh.make_decode_2d_ctx(mesh)
    with sh.use_ctx(ctx), pytest.raises(ValueError, match="neither the training nor the "
                                                          "inference layout"):
        tp.plan(placed, ctx, (BATCH, 1, cfg.d_model))
    ctx = sh.make_ctx(mesh)
    batch = {k: torch.zeros((BATCH // DP, 4), dtype=torch.int32) for k in ("inputs", "labels")}
    with sh.use_ctx(ctx):
        plan = tp.plan(placed, ctx, (BATCH, 4, cfg.d_model))
        assert plan.stationary
        with pytest.raises(ValueError, match="inference layout"):
            lm.group_train(placed, batch, cfg, plan, tp.group(placed, ctx, 0), torch.ones(()),
                           0.0, {})


@pytest.mark.parametrize("split_dim,cat_dim", [(1, 0), (0, 1), (2, 2)])
def test_all_to_all_is_a_block_transpose(split_dim, cat_dim):
    mesh = _mesh()
    ctx = sh.make_ctx(mesh)
    for t in range(2):  # the positions of tp index t, one a data-parallel group
        grp = col.Group.along(mesh, sh.position(mesh, {"model": t}), ctx.dp)
        assert len(grp.positions) == 4
        rng = np.random.default_rng(t)
        parts = [torch.from_numpy(rng.normal(size=(4, 8, 12)).astype(np.float32))
                 for _ in range(4)]
        col.counts.clear()
        got = col.all_to_all(parts, grp, split_dim, cat_dim)
        assert col.counts["all_to_all"] == 1
        for j, out in enumerate(got):
            want = torch.cat([p.chunk(4, dim=split_dim)[j] for p in parts], dim=cat_dim)
            assert torch.equal(out, want) and out.device == grp.devices[j]
    with pytest.raises(ValueError, match="does not split over 4"):
        col.all_to_all([torch.ones(3, 2)] * 4, grp, 0, 1)


# Runs in a fresh process with 8 host devices: the reference's sharded decode.
JAX_SIDE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
assert len(jax.devices()) == 8  # the backend is up: the dry-run's import sets no count now
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_config
from repro.configs.smoke import reduce
from repro.distributed.sharding import make_ctx, param_shardings, sanitize_spec, use_ctx
from repro.launch.dryrun import _cache_shardings
from repro.models import lm

p = json.loads(sys.argv[1])
cfg = reduce(get_config(p["arch"]))
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, groups=p["groups"],
                                                       dispatch_mode="tokens"))
params = lm.init_params(jax.random.key(0), cfg)
rng = np.random.default_rng(2)
prompt = rng.integers(0, cfg.vocab_size, (p["batch"], p["prompt"])).astype(np.int32)
toks = [rng.integers(0, cfg.vocab_size, (p["batch"], 1)).astype(np.int32)
        for _ in range(p["steps"])]
_, cache = jax.jit(lambda q, x: lm.prefill(q, x, cfg, p["max_len"]))(params, jnp.asarray(prompt))
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
ctx = make_ctx(mesh)
params_sh = param_shardings(params, mesh, ctx, inference=True)
cache_sh = _cache_shardings(cache, cfg, mesh, ctx, long=False)
inp_sh = NamedSharding(mesh, sanitize_spec(P(ctx.dp, None), (p["batch"], 1), mesh))
out = {}
with use_ctx(ctx), jax.set_mesh(mesh):
    step = jax.jit(lambda q, c, t, pos: lm.decode_step(q, c, t, pos, cfg),
                   in_shardings=(params_sh, cache_sh, inp_sh, NamedSharding(mesh, P())))
    params, cache = jax.device_put(params, params_sh), jax.device_put(cache, cache_sh)
    for i, t in enumerate(toks):
        logits, cache = step(params, cache, jnp.asarray(t), jnp.int32(p["prompt"] + i))
        out[f"logits_{i}"] = np.asarray(logits)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference_sharded(tmp_path_factory):
    """The reference's sharded decode of reduced qwen3_moe, started at once
    in a subprocess while the port's side runs."""
    tmp = tmp_path_factory.mktemp("expert_decode")
    params = dict(arch=ARCHS[0], groups=GROUPS, batch=BATCH, prompt=PROMPT, steps=STEPS,
                  max_len=MAX_LEN)
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), json.dumps(params),
         str(tmp / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"})
    yield proc, tmp / "jax.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_decode_matches_the_reference_sharded_step(reference_sharded):
    proc, path = reference_sharded
    _, cfg, model, cache, toks, want = _case(ARCHS[0])
    got, a2a = _decode(cfg, model, cache, toks, sh.make_ctx, lambda: col.counts["all_to_all"])
    assert a2a == [2 * _moe_layers(cfg)] * STEPS
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    ref = np.load(path)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, ref[f"logits_{i}"], err_msg=f"step {i}", **DECODE_TOL)
        # the reference's sharded step agrees with its single-device one
        np.testing.assert_allclose(ref[f"logits_{i}"], want[i], **DECODE_TOL)
