"""The reference's sharded prefill and decode, on the CPU: ``lm.prefill`` over a
placed model and the placed decode step as one ``graphs.Program`` with the
position an operand.

The port's side runs on the 8-position CPU ``DeviceMesh`` of
``tests/test_torch_seq_parallel.py`` (4 x 2 ``("data", "model")``), each
model placed with ``inference=True`` under ``make_ctx`` and under
``make_decode_2d_ctx``.  The JAX side runs on this process's one JAX device
(``tests/conftest.py``), from the same seeded parameters (carried with
``lm.params_from_numpy``), both its functions jitted:

* reduced gemma2_27b, recurrentgemma_9b (K5's plain version on each
  position's channels), qwen3_moe_235b_a22b (expert-stationary; ``moe.groups``
  4, what the dry-run's prefill and decode cells both set at this shape)
  and xlstm_125m (its blocks split by heads on 4 x 2, whole on the lead
  over 8 positions, which do not divide its 4 heads): the placed prefill's
  logits, and every cache layer gathered whole, within 1e-5 of the JAX
  single-device ``prefill``; its caches laid out exactly as
  ``lm.place_group_caches`` lays out the JAX cache; then 10 decode steps
  (positions 12-21: gemma2's 32 global slots cross from one position's
  slots into the next, its 8 window slots wrap) within 1e-5 of the JAX
  ``decode_step``, one ``PLACED_DECODE`` variant for the whole loop and one
  ``PLACED_PREFILL`` variant;
* qwen3_moe at ``moe.groups`` 8, more than one routing group a
  data-parallel group, with picks dropped over capacity: the same checks;
* the unsharded ``CausalLM.decode_step`` at an int and at a tensor position,
  bit for bit;
* a replay's dataclass outputs (``attention.SeqKV``) handed out fresh;
* the reference's own sharded programs on 8 host devices in a subprocess
  (``src/repro/launch/dryrun.py:159-162`` and ``:194-198``: ``lm.prefill``
  jitted over the parameters' and inputs' shardings, ``lm.decode_step``
  over the inference layout and the cache's shardings with ``pos`` traced,
  the cache donated): the port within 5e-5 of it (the reference's sharded
  prefill itself lies up to 1.5e-5 from its single-device one), and its
  decode jit compiled once for the 10 steps.
"""

import dataclasses
import json
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
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_device_mesh  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import tensor_parallel as tp  # noqa: E402

DECODE_TOL = dict(rtol=1e-5, atol=1e-5)
# the port against the reference's sharded programs on 8 host devices
SHARDED_ATOL = 5e-5
# a prompt of 12, then 10 steps (positions 12-21) in 32 slots
BATCH, PROMPT, STEPS, MAX_LEN = 8, 12, 10, 32
ARCHS = ("gemma2_27b", "recurrentgemma_9b", "qwen3_moe_235b_a22b", "xlstm_125m")
CTXS = [sh.make_ctx, sh.make_decode_2d_ctx]
# the dry-run's routing groups at this shape: max(dp, B S // 512) for the
# prefill cell and max(dp, B // 512) for the decode cell, both 4
GROUPS = 4


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_groups(cfg, **moe_overrides):
    if cfg.moe is None:
        return cfg
    moe_overrides = {"groups": GROUPS, **moe_overrides}
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_overrides))


def _mesh():
    return make_device_mesh((4, 2), ("data", "model"), ["cpu"] * 8)


def _layer_caches(jcache, cfg) -> list[dict]:
    """The JAX cache in layer order, period entries unstacked, as tensors."""
    per = len(cfg.layer_pattern)
    layers = [{k: v[rep] for k, v in jcache["period"][pos].items()}
              for rep in range(cfg.repeats) for pos in range(per)] + list(jcache["tail"])
    return [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()} for layer in layers]


def _tokens(cfg):
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    return prompt, [rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
                    for _ in range(STEPS)]


_CASES = {}


def _case(arch, **moe_overrides):
    """The port's model and config, the prompt and the steps' tokens, and
    the JAX single-device prefill (logits, cache in layer order) and each
    decode step's logits (cached: the contexts share them)."""
    key = (arch, tuple(sorted(moe_overrides.items())))
    if key not in _CASES:
        jcfg = _with_groups(jax_reduce(jax_config(arch)), **moe_overrides)
        cfg = _with_groups(reduce(get_config(arch)), **moe_overrides)
        jparams = jlm.init_params(jax.random.key(0), jcfg)
        model = lm.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
        prompt, toks = _tokens(cfg)
        logits, jcache = jax.jit(lambda p, x: jlm.prefill(p, x, jcfg, MAX_LEN))(
            jparams, jnp.asarray(prompt))
        first, cache, want = np.asarray(logits), _layer_caches(jcache, cfg), []
        step = jax.jit(lambda p, c, x, pos: jlm.decode_step(p, c, x, pos, jcfg))
        for i, t in enumerate(toks):
            out, jcache = step(jparams, jcache, jnp.asarray(t), jnp.int32(PROMPT + i))
            want.append(np.asarray(out))
        _CASES[key] = (cfg, model, prompt, toks, first, cache, want)
    return _CASES[key]


def _whole_layer(kind: str, layer) -> dict:
    """One group's cache of a layer gathered whole: a ``SeqKV``'s slots, or a
    list of positions' pieces of a recurrent state, concatenated."""
    if isinstance(layer, attn.SeqKV):
        return {k: torch.cat([p[k] for p in layer.parts], 1) for k in layer.parts[0]}
    if isinstance(layer, list):
        return {k: torch.cat([p[k] for p in layer], tp._STATE_CUTS[kind][k][0])
                for k in layer[0]}
    return layer


def _whole(caches, cfg) -> list[dict]:
    """Every group's caches gathered into the whole cache, layer by layer."""
    layers = [[_whole_layer(kind, layer) for kind, layer in zip(cfg.layer_kinds, cache)]
              for cache in caches]
    return [{k: torch.cat([g[i][k] for g in layers], 0) for k in layers[0][i]}
            for i in range(len(layers[0]))]


def _placed_run(arch, make, **moe_overrides):
    """The placed prefill and 10 placed decode steps under ``make``'s ctx,
    the programs cleared first: (prefill logits, its caches' whole layers,
    its layout and ``place_group_caches``' layout of the JAX cache, each
    step's logits, the programs' variants)."""
    cfg, model, prompt, toks, _, cache, _ = _case(arch, **moe_overrides)
    mesh = _mesh()
    ctx = make(mesh)
    placed = sh.place(model, mesh, ctx, inference=True)
    lm.PLACED_PREFILL.clear()
    lm.PLACED_DECODE.clear()
    with sh.use_ctx(ctx):
        logits, caches = lm.prefill(placed, torch.from_numpy(prompt), cfg, MAX_LEN)
        whole = [{k: v.clone() for k, v in layer.items()} for layer in _whole(caches, cfg)]
        layout = [[lm._layout(layer) for layer in c] for c in caches]
        want = [[lm._layout(layer) for layer in c]
                for c in lm.place_group_caches(placed, [dict(layer) for layer in cache])]
        steps = []
        for i, t in enumerate(toks):
            pos = PROMPT + i if i % 2 else torch.tensor(PROMPT + i)  # either kind of position
            out, caches = lm.decode_step(placed, caches, torch.from_numpy(t), pos, cfg)
            steps.append(out.numpy())
    return logits.numpy(), whole, layout, want, steps, (len(lm.PLACED_PREFILL),
                                                          len(lm.PLACED_DECODE))


def _check_against_jax(arch, make, **moe_overrides):
    cfg, _, _, _, first, cache, want = _case(arch, **moe_overrides)
    logits, whole, layout, want_layout, steps, variants = _placed_run(arch, make,
                                                                      **moe_overrides)
    np.testing.assert_allclose(logits, first, err_msg="prefill logits", **DECODE_TOL)
    for i, (got, ref) in enumerate(zip(whole, cache)):
        assert sorted(got) == sorted(ref), i
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), err_msg=f"layer {i} {k}",
                                       **DECODE_TOL)
    assert layout == want_layout
    for i, (g, w) in enumerate(zip(steps, want)):
        np.testing.assert_allclose(g, w, err_msg=f"{make.__name__} step {i}", **DECODE_TOL)
    assert variants == (1, 1)  # one prefill variant; one decode variant for the loop


@pytest.mark.parametrize("make", CTXS, ids=[m.__name__ for m in CTXS])
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_prefill_and_decode_match_jax(arch, make):
    _check_against_jax(arch, make)


@pytest.mark.parametrize("make", CTXS, ids=[m.__name__ for m in CTXS])
def test_placed_prefill_with_routing_groups_over_the_data_parallel_groups(make, monkeypatch):
    """qwen3_moe with ``moe.groups`` 8, as the dry-run's prefill cell sets
    ``B S // 512`` routing groups for a prompt past ``512 dp`` tokens: each
    data-parallel group routes 2 (``make_ctx``, dp 4) or 8 (dp 1) routing
    groups, so ``moe_stationary`` trades ``[g / dp > 1, E, C, D]`` buffers.
    Capacity factor 0.5 (3 slots an expert for a routing group's 12 tokens
    x 2 picks) drops picks in the prefill.  The placed prefill, its caches
    and 10 decode steps stay within 1e-5 of the JAX single-device ones."""
    from repro_torch.models import moe

    seen, real = [], moe.route_slots

    def recording(gates, mc, cap):
        out = real(gates, mc, cap)
        seen.append((gates.shape, out[0], cap, mc.n_experts))
        return out

    monkeypatch.setattr(moe, "route_slots", recording)
    _check_against_jax("qwen3_moe_235b_a22b", make, groups=8, capacity_factor=0.5)
    monkeypatch.undo()
    dp = 4 if make is sh.make_ctx else 1
    prefill = [(slot, cap, e) for shape, slot, cap, e in seen
               if shape[1] == BATCH * PROMPT // 8]  # a routing group's tokens
    assert prefill and all(shape[0] == 8 // dp for shape, *_ in seen)
    assert sum(int((slot == e * cap).sum()) for slot, cap, e in prefill) > 0  # picks dropped


@pytest.mark.parametrize("make", CTXS, ids=[m.__name__ for m in CTXS])
def test_layouts_the_positions_take(make):
    """gemma2 under both contexts: its window and global layers by sequence
    (``SeqKV``) over every position of a group; recurrentgemma's RG-LRU
    state by channels; xLSTM's states by heads under ``make_ctx`` (the
    mLSTM's ``c``, ``n`` and ``m`` by their head dim, the sLSTM's states
    and both conv histories by the heads' channels), whole on the lead
    under ``make_decode_2d_ctx``, whose 8 positions do not divide the 4
    heads."""
    n = 2 if make is sh.make_ctx else 8
    mesh = _mesh()
    for arch in ("gemma2_27b", "recurrentgemma_9b", "xlstm_125m"):
        cfg, model, prompt, _, _, _, _ = _case(arch)
        ctx = make(mesh)
        placed = sh.place(model, mesh, ctx, inference=True)
        with sh.use_ctx(ctx):
            _, caches = lm.prefill(placed, torch.from_numpy(prompt), cfg, MAX_LEN)
        assert len(caches) == 8 // n
        for kind, layer in zip(cfg.layer_kinds, caches[0]):
            if kind in ("attn", "win"):
                assert isinstance(layer, attn.SeqKV) and len(layer.parts) == n, (arch, kind)
                slots = MAX_LEN if kind == "attn" else cfg.window
                assert layer.parts[0]["k"].shape[1] == slots // n
            elif kind == "rec":
                assert isinstance(layer, list) and len(layer) == n
                assert layer[0]["h"].shape == (BATCH * n // 8, cfg.d_model // n)
            elif make is sh.make_ctx:
                rows, heads, hd = BATCH * n // 8, 4 // n, 2 * cfg.d_model // 4
                width = 2 * cfg.d_model if kind == "mlstm" else cfg.d_model
                assert isinstance(layer, list) and len(layer) == n, (arch, kind)
                assert layer[0]["conv"].shape == (rows, cfg.conv_width - 1, width // n)
                if kind == "mlstm":
                    assert layer[0]["c"].shape == (rows, heads, hd, hd)
                    assert layer[0]["m"].shape == (rows, heads)
                else:
                    assert layer[0]["h"].shape == (rows, cfg.d_model // n)
            else:
                assert isinstance(layer, dict) and layer["c"].device == mesh.devices[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_an_int_and_a_tensor_position_decode_alike(arch):
    """The unsharded ``CausalLM.decode_step`` at an int and at a 0-dim tensor
    position, 10 steps from one prefill (gemma2's window wraps): logits and
    caches bit for bit."""
    cfg, model, prompt, toks, _, _, _ = _case(arch)
    _, cache = model.prefill(torch.from_numpy(prompt), MAX_LEN)
    runs = []
    for tensor in (False, True):
        c = [{k: v.clone() for k, v in layer.items()} for layer in cache]
        out = []
        for i, t in enumerate(toks):
            pos = torch.tensor(PROMPT + i) if tensor else PROMPT + i
            logits, c = lm.decode_step(model, c, torch.from_numpy(t), pos, cfg)
            out.append(logits)
        runs.append((out, c))
    (a, ca), (b, cb) = runs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for la, lb in zip(ca, cb):
        assert all(torch.equal(la[k], lb[k]) for k in la)


def test_a_replay_hands_out_fresh_dataclasses():
    """``fresh`` copies the tensors inside a dataclass output (a ``SeqKV``'s
    parts), keeping its other fields."""
    grp = col.Group((0, 1), (torch.device("cpu"),) * 2)
    parts = [{"k": torch.ones(2, 2)}, {"k": torch.zeros(2, 2)}]
    seq = attn.SeqKV(parts, grp)
    out = graphs._fresh([seq])
    assert out[0] is not seq and out[0].group == grp
    for a, b in zip(out[0].parts, parts):
        assert a["k"] is not b["k"] and torch.equal(a["k"], b["k"])
    assert [t.data_ptr() for t in graphs.tensors(seq)] == [p["k"].data_ptr() for p in parts]


# Runs in a fresh process with 8 host devices: the reference's sharded
# prefill and decode, as the dry-run jits them.
JAX_SIDE = """
import dataclasses, json, sys
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
assert len(jax.devices()) == 8  # the backend is up: the dry-run's import sets no count now
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_config
from repro.configs.smoke import reduce
from repro.distributed.sharding import (make_ctx, make_decode_2d_ctx, param_shardings,
                                        sanitize_spec, use_ctx)
from repro.launch.dryrun import _cache_shardings, _dp_total, _with_moe_groups
from repro.models import lm

p = json.loads(sys.argv[1])
b, s, max_len = p["batch"], p["prompt"], p["max_len"]
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
dp = _dp_total(mesh)
out = {}
for arch in p["archs"]:
    cfg = reduce(get_config(arch))
    params = lm.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    toks = [rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32) for _ in range(p["steps"])]
    pcfg = _with_moe_groups(cfg, b * s, dp)
    dcfg = _with_moe_groups(cfg, b, dp, mode="tokens")
    for name, make in (("make_ctx", make_ctx), ("make_decode_2d_ctx", make_decode_2d_ctx)):
        ctx = make(mesh)
        tag = f"{arch}/{name}"
        with use_ctx(ctx), jax.set_mesh(mesh):
            params_sh = param_shardings(params, mesh, ctx)
            inp_sh = NamedSharding(mesh, sanitize_spec(P(ctx.dp, None), prompt.shape, mesh))
            pre = jax.jit(lambda q, t: lm.prefill(q, t, pcfg, max_len),
                          in_shardings=(params_sh, inp_sh))
            logits, cache = pre(jax.device_put(params, params_sh), jnp.asarray(prompt))
            out[f"{tag}/prefill"] = np.asarray(logits)
            dparams_sh = param_shardings(params, mesh, ctx, inference=True)
            cache_sh = _cache_shardings(cache, dcfg, mesh, ctx, long=False)
            tok_sh = NamedSharding(mesh, sanitize_spec(P(ctx.dp, None), (b, 1), mesh))
            step = jax.jit(lambda q, c, t, pos: lm.decode_step(q, c, t, pos, dcfg),
                           in_shardings=(dparams_sh, cache_sh, tok_sh, NamedSharding(mesh, P())),
                           donate_argnums=(1,))
            q, cache = jax.device_put(params, dparams_sh), jax.device_put(cache, cache_sh)
            for i, t in enumerate(toks):
                logits, cache = step(q, cache, jnp.asarray(t), jnp.int32(s + i))
                # the cache comes back in an equal layout whose spec drops its
                # trailing Nones, which jit's cache keys apart: put it back in
                # the cache's shardings, as each call of the dry-run takes it
                cache = jax.device_put(cache, cache_sh)
                out[f"{tag}/step_{i}"] = np.asarray(logits)
            out[f"{tag}/compiles"] = np.asarray(step._cache_size())
np.savez(sys.argv[2], **out)
"""
SHARDED_ARCHS = ARCHS


@pytest.fixture(scope="module")
def reference_sharded(tmp_path_factory):
    """The reference's sharded prefill and decode of the reduced gemma2,
    recurrentgemma, qwen3_moe and xlstm_125m under both contexts, started
    at once in a subprocess while the port's side runs."""
    tmp = tmp_path_factory.mktemp("placed_prefill")
    params = dict(archs=SHARDED_ARCHS, batch=BATCH, prompt=PROMPT, steps=STEPS, max_len=MAX_LEN)
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), json.dumps(params),
         str(tmp / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"})
    yield proc, tmp / "jax.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference_outputs(reference_sharded):
    proc, path = reference_sharded
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("make", CTXS, ids=[m.__name__ for m in CTXS])
@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_placed_programs_match_the_reference_sharded_programs(arch, make, reference_sharded,
                                                              reference_outputs):
    logits, _, _, _, steps, _ = _placed_run(arch, make)
    ref, tag = reference_outputs, f"{arch}/{make.__name__}"
    assert int(ref[f"{tag}/compiles"]) == 1  # pos traced: one compile for the loop
    np.testing.assert_allclose(logits, ref[f"{tag}/prefill"], rtol=0, atol=SHARDED_ATOL)
    for i, g in enumerate(steps):
        np.testing.assert_allclose(g, ref[f"{tag}/step_{i}"], rtol=0, atol=SHARDED_ATOL,
                                   err_msg=f"step {i}")
