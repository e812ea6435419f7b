"""The sequence axis over the model axis, on the CPU: sequence parallelism in
the sharded train step, and the decode KV cache split over the sequence.

The port's side runs on the 8-position CPU ``DeviceMesh`` of
``tests/test_torch_model_sharding.py`` (4 x 2 ``("data", "model")``); the
JAX side runs on this process's one JAX device, as that file runs its
decode reference (``tests/conftest.py`` holds this process to one JAX
device), from the same seeded parameters:

* a 4 x 2 step of reduced granite, recurrentgemma and xlstm_125m under
  ``make_ctx(seq_shard=True)``, S = 32 over 2 positions: the step-1 loss
  bit for bit with ``seq_shard=False`` (the forward sees the same products
  and row-wise norms) and within 2e-4 of the JAX package's loss of the
  same parameters and batch; the parameters after two steps within rtol
  3e-3 / atol 3e-4 of ``seq_shard=False``'s; reduce-scatters counted only
  with it on;
* each position saves its ``[B_g, S / 2, D]`` rows of each block's input,
  on its device; an ``S`` the 2 positions do not divide takes the whole
  path, with no reduce-scatter or split counted;
* reduced gemma2, recurrentgemma and xlstm_125m: the JAX package's ``prefill`` carried
  into ``lm.place_group_caches``, then 10 decode steps under ``make_ctx``
  and ``make_decode_2d_ctx``, crossing the slot boundary between positions
  and the window's wrap: logits within 1e-5 of the JAX single-device
  ``decode_step`` (f32; both JAX functions jitted), finite at a step where some position holds no
  written slot; a slot count the positions do not divide keeps that
  layer's cache whole on the lead;
* each position's decode-cache bytes equal the dry-run's ``cache`` group
  (``launch/dryrun.py`` ``cache_specs``, ``account``'s rule) under both
  contexts, but xlstm_125m's under ``make_decode_2d_ctx``, whose 8
  positions do not divide its 4 heads: there its blocks and their states
  stay whole on the lead (ROADMAP D7).
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.smoke import reduce as jax_reduce  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import shapes as shp  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import make_device_mesh  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

LOSS_ATOL = 2e-4
PARAM_TOL = dict(rtol=3e-3, atol=3e-4)
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, SEQ = 8, 32
TCFG = tts.TrainConfig(n_micro=2, optimizer=topt.OptimizerConfig(
    peak_lr=1e-3, warmup_steps=1, total_steps=10))
TRAIN_CASES = [("granite_3_2b", dict(n_layers=2)), ("recurrentgemma_9b", {}), ("xlstm_125m", {})]
# a prompt of 12, then 10 steps (positions 12-21): gemma2's global layers
# hold 32 slots (16 a position on 4 x 2, 4 on 8 positions: the steps cross
# from one position's slots into the next), its window layers 8 (the
# rolling buffer wraps; 4 and 1 a position)
PROMPT, STEPS, MAX_LEN = 12, 10, 32
DECODE_CASES = [("gemma2_27b", dict(n_layers=4)), ("recurrentgemma_9b", {}), ("xlstm_125m", {})]
CTXS = [sh.make_ctx, sh.make_decode_2d_ctx]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, overrides):
    return (dataclasses.replace(jax_reduce(jax_config(arch)), **overrides),
            dataclasses.replace(reduce(get_config(arch)), **overrides))


def _mesh():
    return make_device_mesh((4, 2), ("data", "model"), ["cpu"] * 8)


def _batch(cfg, seq=SEQ) -> dict:
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, seq)).astype(np.int32))
             for k in ("inputs", "labels")}
    batch["labels"][1, 5:] = -100
    return batch


def _jax_state(jcfg):
    return jts.init_train_state(jax.random.key(0), jcfg, jts.TrainConfig(
        n_micro=TCFG.n_micro, optimizer=jopt.OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                                             total_steps=10)))


def _steps(jstate, cfg, batch, seq_shard: bool, steps: int = 2):
    """``steps`` 4 x 2 steps from the JAX package's initial state: (losses,
    whole parameters, the collectives counted)."""
    mesh = _mesh()
    ctx = sh.make_ctx(mesh, seq_shard=seq_shard)
    state = sh.place(tts.train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu"),
                     mesh, ctx)
    col.counts.clear()
    with sh.use_ctx(ctx):
        losses = [float(tts.train_step(state, batch, cfg, TCFG)[1]["loss"])
                  for _ in range(steps)]
    return (losses, {n: sh.gather(x, "cpu") for n, x in state.params.leaves.items()},
            dict(col.counts))


def _jax_loss(jstate, jcfg, batch: dict) -> float:
    """The JAX package's loss of the initial parameters on ``batch``, the mean
    over the two microbatches (the step's loss before its update)."""
    loss = jax.jit(lambda p, mb: jlm.train_loss(p, mb, jcfg)[0])
    out = []
    for rows in (slice(0, BATCH // 2), slice(BATCH // 2, BATCH)):
        mb = {k: jnp.asarray(v[rows].numpy()) for k, v in batch.items()}
        out.append(float(loss(jstate.params, mb)))
    return float(np.mean(out))


@pytest.mark.parametrize("arch,overrides", TRAIN_CASES, ids=[c[0] for c in TRAIN_CASES])
def test_seq_parallel_step_matches_the_whole_stream(arch, overrides):
    jcfg, cfg = _cfgs(arch, overrides)
    batch, jstate = _batch(cfg), _jax_state(jcfg)
    on_losses, on_params, on_counts = _steps(jstate, cfg, batch, True)
    off_losses, off_params, off_counts = _steps(jstate, cfg, batch, False)
    assert on_losses[0] == off_losses[0], (on_losses, off_losses)
    assert abs(on_losses[0] - _jax_loss(jstate, jcfg, batch)) < LOSS_ATOL
    for n, w in off_params.items():
        torch.testing.assert_close(on_params[n], w, msg=n, **PARAM_TOL)
    assert on_counts["reduce_scatter"] > 0 and "reduce_scatter" not in off_counts


def test_each_position_saves_its_rows(monkeypatch):
    """The forward pass saves each block's input: under sequence
    parallelism a list of the group's two positions' ``[B_g, S / 2, D]``
    rows, each on its position's device."""
    jcfg, cfg = _cfgs(*TRAIN_CASES[0])
    seen, real = [], B.block_train

    def recording(x, params, cfg, kind):
        if not torch.is_grad_enabled():  # the forward pass, whose inputs are saved
            seen.append((x, params.group))
        return real(x, params, cfg, kind)

    monkeypatch.setattr(B, "block_train", recording)
    _steps(_jax_state(jcfg), cfg, _batch(cfg), True, steps=1)
    # 4 groups x 2 microbatches x 2 blocks
    assert len(seen) == 16
    for x, grp in seen:
        assert isinstance(x, list) and len(x) == 2
        assert [tuple(xi.shape) for xi in x] == [(1, SEQ // 2, cfg.d_model)] * 2
        assert tuple(xi.device for xi in x) == grp.devices


def test_a_sequence_the_positions_do_not_divide_runs_whole():
    jcfg, cfg = _cfgs(*TRAIN_CASES[0])
    batch, jstate = _batch(cfg, seq=SEQ - 1), _jax_state(jcfg)
    on = _steps(jstate, cfg, batch, True, steps=1)
    off = _steps(jstate, cfg, batch, False, steps=1)
    assert on[0] == off[0]
    assert not {"reduce_scatter", "split"} & set(on[2])
    assert all(torch.equal(on[1][n], w) for n, w in off[1].items())


def _layer_caches(jcache, cfg) -> list[dict]:
    """The JAX cache in layer order, period entries unstacked, as tensors."""
    per = len(cfg.layer_pattern)
    layers = [{k: v[rep] for k, v in jcache["period"][pos].items()}
              for rep in range(cfg.repeats) for pos in range(per)] + list(jcache["tail"])
    return [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()} for layer in layers]


def _decode_case(arch, overrides, max_len):
    """Parameters, a prompt's JAX cache, the steps' tokens and the JAX
    single-device logits of each step."""
    jcfg, cfg = _cfgs(arch, overrides)
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    model = lm.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    toks = [rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32) for _ in range(STEPS)]
    _, jcache = jax.jit(lambda p, x: jlm.prefill(p, x, jcfg, max_len))(jparams,
                                                                     jnp.asarray(prompt))
    cache, want = _layer_caches(jcache, cfg), []
    step = jax.jit(lambda p, c, x, pos: jlm.decode_step(p, c, x, pos, jcfg))
    for i, t in enumerate(toks):
        logits, jcache = step(jparams, jcache, jnp.asarray(t), jnp.int32(PROMPT + i))
        want.append(np.asarray(logits))
    return cfg, model, cache, toks, want


@pytest.mark.parametrize("arch,overrides", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_from_a_prefill_over_the_sequence_matches_jax(arch, overrides):
    cfg, model, whole, toks, want = _decode_case(arch, overrides, MAX_LEN)
    mesh = _mesh()
    for make in CTXS:
        ctx = make(mesh)
        n = len(sh.tp_peers(ctx, 0))
        placed = sh.place(model, mesh, ctx, inference=True)
        with sh.use_ctx(ctx):
            caches = lm.place_group_caches(placed, [dict(layer) for layer in whole])
            rows = BATCH // len(sh.dp_leads(ctx))
            for kind, layer, src in zip(cfg.layer_kinds, caches[0], whole):
                if kind in ("rec", "mlstm", "slstm"):
                    continue
                t = src["k"].shape[1]
                assert isinstance(layer, attn.SeqKV) and len(layer.parts) == n
                assert [tuple(p["k"].shape) for p in layer.parts] == [
                    (rows, t // n, cfg.n_kv_heads, cfg.head_dim)] * n
                # the slots of rows 0..rows-1 of the prefill's cache, position by position
                assert torch.equal(torch.cat([p["v"] for p in layer.parts], 1), src["v"][:rows])
            empty = [not p["k"].any() for layer in caches[0] if isinstance(layer, attn.SeqKV)
                     for p in layer.parts]
            if make is sh.make_decode_2d_ctx and "attn" in cfg.layer_kinds:
                # 32 global slots over 8 positions: slots 16-31 unwritten at step 1
                assert any(empty)
            for i, t in enumerate(toks):
                logits, caches = lm.decode_step(placed, caches, torch.from_numpy(t), PROMPT + i,
                                                cfg)
                assert torch.isfinite(logits).all()
                np.testing.assert_allclose(logits.numpy(), want[i],
                                           err_msg=f"{make.__name__} step {i}", **DECODE_TOL)


def test_a_slot_count_the_positions_do_not_divide_keeps_the_cache_whole():
    """33 slots in gemma2's global layers split neither 2 nor 8 ways: those
    layers' caches stay whole on the lead and the split attention
    combines over the lead's slots alone; the window layers' 8 slots
    still split."""
    cfg, model, whole, toks, want = _decode_case(*DECODE_CASES[0], MAX_LEN + 1)
    mesh = _mesh()
    for make in CTXS:
        ctx = make(mesh)
        placed = sh.place(model, mesh, ctx, inference=True)
        with sh.use_ctx(ctx):
            caches = lm.place_group_caches(placed, [dict(layer) for layer in whole])
            for kind, layer in zip(cfg.layer_kinds, caches[0]):
                assert isinstance(layer, dict if kind == "attn" else attn.SeqKV), kind
                if kind == "attn":
                    assert layer["k"].shape[1] == MAX_LEN + 1
            for i, t in enumerate(toks[:4]):
                logits, caches = lm.decode_step(placed, caches, torch.from_numpy(t), PROMPT + i,
                                                cfg)
                np.testing.assert_allclose(logits.numpy(), want[i], **DECODE_TOL)


@pytest.mark.parametrize("arch,overrides", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_cache_bytes_equal_the_dryrun_account(arch, overrides):
    """Each position's bytes of ``init_group_caches`` against the dry-run's
    per-device cache bytes of a decode cell of the same shape, by
    ``cache_specs`` under each context (``account``'s own under
    ``make_ctx``, which it picks for a reduced model)."""
    _, cfg = _cfgs(arch, overrides)
    mesh = _mesh()
    cell = D.Cell(cfg, dataclasses.replace(shp.SHAPES["decode_32k"], seq_len=MAX_LEN,
                                           global_batch=BATCH), None)
    leaves = D.meta_arguments(cell)["cache"]
    placed = {}
    for make in CTXS:
        ctx = make(mesh)
        placed = sh.place(lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu"), mesh,
                          ctx, inference=True)
        specs = D.cache_specs(cell, leaves, ctx)
        want = sum(math.prod(sh.shard_shape(tuple(t.shape), specs[n], mesh)) * t.element_size()
                   for n, t in leaves.items())
        if make is sh.make_ctx:
            assert D.account(cell, mesh)["arguments"]["cache"] == want
        with sh.use_ctx(ctx):
            got = lm.cache_position_bytes(placed, lm.init_group_caches(placed, BATCH, MAX_LEN))
        if make is sh.make_decode_2d_ctx and arch == "xlstm_125m":  # D7
            total = sum(t.numel() * t.element_size() for t in leaves.values())
            assert got == [total] + [0] * (mesh.size - 1)
        else:
            assert got == [want] * mesh.size, make.__name__
