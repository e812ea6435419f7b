"""Tensor-parallel compute over a device mesh's model axis, on the CPU.

Reduced configs on ``DeviceMesh`` es of CPU positions (``("data",
"model")``), f32.  The JAX package's sharded steps on 8 host devices are the
reference of ``tests/test_torch_model_sharding.py``; here each piece is held
against the port's single-device path, and the RG-LRU block also against the
JAX package's ``rec_block_train`` (one JAX device, this process):

* (a) during a 4 x 2 step every bind of a leaf the model axis splits copies
  exactly its tp block onto a position (half of it), the two positions'
  blocks tile the leaf, and ``gathered_bytes`` adds up what was copied;
* (b) a dense block split over 2 positions runs 2 all-reduces forward (one
  a product) and 2 backward (the gradients of the two broadcast inputs);
  an RG-LRU block adds its all-gather of the conv output;
* (c) attention with MQA (one KV head read by both positions' q heads) and
  with q heads that do not split (whole), a 4 x 2 step against the
  single-device step: losses within rtol 1e-5, parameters within rtol
  1e-4 / atol 5e-5; and a head-split layer's prefill and decode step (a
  global and a window layer) against the whole layer within 1e-5;
* (d) the vocabulary-parallel logits and loss, with gemma2's final softcap
  30, against the whole logits (logits within 1e-5, the loss and its
  gradients within rtol 1e-5); a vocabulary the model axis does not divide
  takes the whole path;
* (e) the RG-LRU block at tp 2 and 4 against the whole block (K5's plain
  version underneath), forward and gradients within 1e-5, and against the
  JAX package's block within 1e-5; its prefill and a decode step, each
  position's cache holding its channels;
* (f) MoE with 4 experts at tp 2 and 4 against the whole layer, output
  within 1e-5, gradients within rtol 3e-4 / atol 1e-5, the aux loss equal;
* (g) at a batch where ``tp_worthwhile`` is false the attention and MLP
  layers run whole (only the vocabulary splits) and the step matches.
"""

import dataclasses
import math
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.smoke import reduce as jax_reduce  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_device_mesh  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402
from repro_torch.models import tensor_parallel as tp  # noqa: E402
from repro_torch.models.common import Split  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_LOSS_RTOL = 1e-5
# Adam's first steps move an element whose gradient sits near eps by up to
# lr: a last-bit difference of such a gradient shows as 1e-5 (5e-5 is 5% of
# an update at lr 1e-3)
STEP_PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
# the MoE input's gradient adds each position's routing and expert terms in
# another order than the whole layer (the router's, of up to 2e4, by 1.2e-4 of
# an element at tp 4)
MOE_GRAD_TOL = dict(rtol=3e-4, atol=1e-5)
TCFG = tts.TrainConfig(n_micro=2, optimizer=topt.OptimizerConfig(
    peak_lr=1e-3, warmup_steps=1, total_steps=10))


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch="granite_3_2b", **kw):
    return dataclasses.replace(reduce(get_config(arch)), **kw)


def _mesh(shape=(4, 2)):
    return make_device_mesh(shape, ("data", "model"), ["cpu"] * math.prod(shape))


def _batch(cfg, rows=8, seq=32, seed=5) -> dict:
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32))
             for k in ("inputs", "labels")}
    batch["labels"][1, 5:] = -100
    return batch


def _steps(cfg, batch, mesh=None, tcfg=TCFG, steps=2):
    """``steps`` train steps from seed 0, on one device or placed on ``mesh``:
    (losses, whole parameters)."""
    state = tts.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg, "cpu")
    if mesh is None:
        losses = [float(tts.train_step(state, batch, cfg, tcfg)[1]["loss"]) for _ in range(steps)]
        return losses, {n: p.detach() for n, p in state.params.named_parameters()}
    ctx = sh.make_ctx(mesh)
    state = sh.place(state, mesh, ctx)
    with sh.use_ctx(ctx):
        losses = [float(tts.train_step(state, batch, cfg, tcfg)[1]["loss"]) for _ in range(steps)]
    return losses, {n: sh.gather(x, "cpu") for n, x in state.params.leaves.items()}


def _plan(cfg, mesh, x_shape):
    ctx = sh.make_ctx(mesh)
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    placed = sh.place(model, mesh, ctx)
    with sh.use_ctx(ctx):
        return placed, ctx, tp.plan(placed, ctx, x_shape)


def _steps_agree(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=STEP_LOSS_RTOL)
    for n, w in want[1].items():
        torch.testing.assert_close(got[1][n], w, msg=n, **STEP_PARAM_TOL)


def test_a_position_gathers_only_its_tp_block(monkeypatch):
    """(a) Every bind of a model-axis leaf copies its tp block, half the leaf,
    the blocks of a group's two positions tile it, and ``gathered_bytes``
    counts the bytes of every bind."""
    cfg = _cfg(n_layers=2)
    mesh = _mesh()
    ctx = sh.make_ctx(mesh)
    state = sh.place(tts.init_train_state(torch.Generator().manual_seed(0), cfg, TCFG, "cpu"),
                     mesh, ctx)
    names = {id(x): n for n, x in state.params.leaves.items()}
    binds, real = [], sh.gather_region

    def recording(x, region, pos):
        binds.append((names[id(x)], x, region, pos))
        return real(x, region, pos)

    monkeypatch.setattr(sh, "gather_region", recording)
    sh.gathered_bytes.clear()
    with sh.use_ctx(ctx):
        tts.train_step(state, _batch(cfg), cfg, TCFG)
    want = {}
    for _, x, region, pos in binds:
        want[pos] = want.get(pos, 0) + math.prod(sh.region_shape(region)) * x.dtype.itemsize
    assert dict(sh.gathered_bytes) == want
    split = [b for b in binds if "model" in b[1].spec]
    assert {n.rsplit(".", 1)[-1] for n, *_ in split} == {
        "embed", "wq", "wk", "wv", "wo", "w_gate", "w_in", "w_out"}
    tiles = {}
    for name, x, region, pos in split:
        assert math.prod(sh.region_shape(region)) * 2 == math.prod(x.shape), name
        d, m = sh.coords(mesh, pos)
        tiles.setdefault((name, d), []).append((m, region))
    for pieces in tiles.values():  # each group binds each block as often
        by_pos = {m: [r for mm, r in pieces if mm == m] for m in (0, 1)}
        assert len(by_pos[0]) == len(by_pos[1]) > 0
        for r0, r1 in zip(by_pos[0], by_pos[1]):
            cut = [i for i, (a, b) in enumerate(zip(r0, r1)) if a != b]
            assert len(cut) == 1 and r0[cut[0]].stop == r1[cut[0]].start
    # a leaf the model axis leaves whole binds on a group's lead alone
    for name, x, _, pos in binds:
        if "model" not in x.spec:
            assert sh.coords(mesh, pos)[1] == 0, name


@pytest.mark.parametrize("arch,kind,fwd,bwd", [
    ("granite_3_2b", "attn", {"broadcast": 2, "all_reduce": 2}, {"all_reduce_grad": 2}),
    ("recurrentgemma_9b", "rec", {"broadcast": 3, "all_gather": 1, "all_reduce": 2},
     {"all_reduce_grad": 3}),
])
def test_collectives_a_block(arch, kind, fwd, bwd):
    """(b) A split block's collectives, forward and backward, over 2
    positions: one all-reduce a row-parallel product forward, one a broadcast
    input backward (Megatron's g and f)."""
    cfg = _cfg(arch)
    placed, ctx, plan = _plan(cfg, _mesh(), (4, 32, cfg.d_model))
    i = cfg.layer_kinds.index(kind)
    assert set(plan.layers[i]) == {"attn" if kind == "attn" else "rec", "mlp"}
    grp = tp.group(placed, ctx, 0)
    skels = lm._skeletons(placed, plan.n)
    x = torch.randn(1, 32, cfg.d_model, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    with sh.use_ctx(ctx), lm._bound(skels, placed, lm._stages(placed)[1][i], plan, grp, True):
        col.counts.clear()
        y, _ = B.block_train(x, tp.block_view(skels, i, plan, grp), cfg, kind)
        assert dict(col.counts) == fwd
        col.counts.clear()
        y.square().sum().backward()
        assert dict(col.counts) == bwd
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("heads,kv,split", [(4, 1, True), (3, 1, False)],
                         ids=["mqa", "q_heads_whole"])
def test_attention_mqa_and_whole_heads_match_one_device(heads, kv, split):
    """(c) MQA: both positions' q heads read the one KV head, which each
    binds whole; 3 q heads do not split over 2 and the layer runs whole.
    Two 4 x 2 steps against two single-device steps."""
    cfg = _cfg(n_layers=2, n_heads=heads, n_kv_heads=kv)
    mesh = _mesh()
    _, _, plan = _plan(cfg, mesh, (4, 32, cfg.d_model))
    assert all(("attn" in layer) == split and "mlp" in layer for layer in plan.layers)
    if split:
        assert [c.n_kv_heads for c in plan.layers[0]["attn"][0]] == [1, 1]
        assert plan.regions["blocks.0.attn.wk"] == [sh.whole((64, 16))] * 2
    batch = _batch(cfg)
    _steps_agree(_steps(cfg, batch, mesh), _steps(cfg, batch))


def test_split_attention_prefill_and_decode_match_the_whole_layer():
    """(c) Attention split by heads over 2 positions (4 q heads, 2 KV heads)
    through prefill and a decode step: outputs within 1e-5; the split
    prefill's cache is the whole layer's, its KV heads gathered on the lead,
    and the decode reads it laid over the positions by sequence (the
    placed layout, ``attention.SeqKV``) at an int and at a tensor
    position."""
    from repro_torch.models import attention as attn

    cfg = _cfg("gemma2_27b", n_layers=4)
    layer = attn.attn_init(torch.Generator().manual_seed(8), cfg, "cpu")
    heads = tp._attn_split(cfg, 2)
    parts = []
    for _, spans in heads:
        q, kv = slice(*spans["q"]), slice(*spans["kv"])
        parts.append(types.SimpleNamespace(wq=layer.wq[:, q], wk=layer.wk[:, kv],
                                           wv=layer.wv[:, kv], wo=layer.wo[q]))
    grp = col.Group((0, 1), (torch.device("cpu"),) * 2)
    split = Split(parts, grp, [c for c, _ in heads], [s for _, s in heads])
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator().manual_seed(9))
    for window in (0, cfg.window):
        want, cache = attn.attn_prefill(x, layer, cfg, window)
        got, whole = attn.attn_prefill(x, split, cfg, window)
        torch.testing.assert_close(got, want, **BLOCK_TOL)
        assert whole["k"].shape[2] == cfg.n_kv_heads
        for k in ("k", "v"):
            torch.testing.assert_close(whole[k], cache[k], **BLOCK_TOL)
        if not window:  # a global layer's 12 slots padded to 16 (a rolling one holds 8)
            cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4)) for k, v in cache.items()}
            whole = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4)) for k, v in whole.items()}
        tn = whole["k"].shape[1] // 2
        for pos in (12, torch.tensor(12)):
            ref = {k: v.clone() for k, v in cache.items()}
            seq = attn.SeqKV([{k: v[:, t * tn:(t + 1) * tn].clone() for k, v in whole.items()}
                              for t in range(2)], grp)
            want, _ = attn.attn_decode(x[:, :1], layer, cfg, ref, pos, window)
            got, _ = attn.attn_decode(x[:, :1], split, cfg, seq, pos, window)
            torch.testing.assert_close(got, want, **BLOCK_TOL)
            for k in ("k", "v"):
                torch.testing.assert_close(torch.cat([p[k] for p in seq.parts], 1), ref[k],
                                           **BLOCK_TOL)


def _head_parts(cfg, head: torch.Tensor, n: int):
    spans = [(t * cfg.vocab_size // n, (t + 1) * cfg.vocab_size // n) for t in range(n)]
    parts = [types.SimpleNamespace(cfg=cfg, head=head[:, v0:v1]) for v0, v1 in spans]
    return parts, spans


def test_vocab_parallel_logits_and_loss_match_the_whole_logits():
    """(d) gemma2's tied head with its final softcap over 2 and 4 positions:
    each position's logits against its columns of the whole logits, the
    loss and its gradients against the whole loss; then a vocabulary the
    model axis does not divide takes the whole path."""
    cfg = _cfg("gemma2_27b", n_layers=4)
    assert cfg.final_softcap == 30.0
    gen = torch.Generator().manual_seed(3)
    x0 = 8 * torch.randn(2, 16, cfg.d_model, generator=gen)
    head0 = torch.randn(cfg.d_model, cfg.vocab_size, generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    labels[0, 3:9] = -100
    x, head = x0.clone().requires_grad_(True), head0.clone().requires_grad_(True)
    whole = lm._head_logits(x, types.SimpleNamespace(cfg=cfg, head=head))
    want = lm.masked_nll_sum(whole, labels)
    want.backward()
    want_gx, want_gh = x.grad, head.grad
    for n in (2, 4):
        grp = col.Group(tuple(range(n)), (torch.device("cpu"),) * n)
        x, head = x0.clone().requires_grad_(True), head0.clone().requires_grad_(True)
        parts, spans = _head_parts(cfg, head, n)
        logits = [lm._head_logits(xi, p) for xi, p in zip(col.broadcast(x, grp), parts)]
        torch.testing.assert_close(torch.cat(logits, -1), whole, **BLOCK_TOL)
        col.counts.clear()
        got = lm.vocab_parallel_nll_sum(logits, labels, spans, grp)
        assert col.counts["all_reduce_max"] == 1 and col.counts["all_reduce"] == 1
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        got.backward()
        torch.testing.assert_close(x.grad, want_gx, **BLOCK_TOL)
        torch.testing.assert_close(head.grad, want_gh, **BLOCK_TOL)
    odd = _cfg(n_layers=2, vocab_size=129)
    mesh = _mesh()
    placed, _, plan = _plan(odd, mesh, (4, 32, odd.d_model))
    assert plan.vocab is None and placed.leaves["embed"].spec == (None, "data")
    assert plan.regions["embed"] == [sh.whole((129, 64)), None]
    batch = _batch(odd)
    _steps_agree(_steps(odd, batch, mesh), _steps(odd, batch))


def _rec_split(layer: rec.RGLRU, n: int, cfg):
    """Each of ``n`` positions' channels of ``layer`` (views of its
    parameters, so gradients reach them) as a ``Split``."""
    r = cfg.rnn_width
    cols = ("w_x", "w_gate_branch", "wi", "wr", "conv_w")
    vecs = ("conv_b", "lam", "bi", "br")
    parts, cfgs = [], []
    for t in range(n):
        c = slice(t * r // n, (t + 1) * r // n)
        p = {k: getattr(layer, k)[:, c] for k in cols}
        p.update({k: getattr(layer, k)[c] for k in vecs})
        p["w_rnn_out"] = layer.w_rnn_out[c]
        parts.append(types.SimpleNamespace(**p))
        cfgs.append(dataclasses.replace(cfg, lru_width=c.stop - c.start))
    grp = col.Group(tuple(range(n)), (torch.device("cpu"),) * n)
    return Split(parts, grp, cfgs, [None] * n)


def _params_grads(module):
    return {n: p.grad.clone() for n, p in module.named_parameters()}


@pytest.mark.parametrize("n", [2, 4])
def test_rglru_block_split_over_channels_matches_the_whole_block(n):
    """(e) The RG-LRU block with its 64 channels over ``n`` positions
    (K5's plain version on each position's [2, 24, 64 / n]), forward and
    every gradient, against the whole block and the JAX package's block."""
    cfg, jcfg = reduce(get_config("recurrentgemma_9b")), jax_reduce(jax_config("recurrentgemma_9b"))
    layer = rec.rglru_init(torch.Generator().manual_seed(2), cfg, "cpu").requires_grad_(True)
    x0 = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(4))
    x = x0.clone().requires_grad_(True)
    want = rec.rec_block_train(x, layer, cfg)
    want.square().sum().backward()
    want_x, want_p = x.grad, _params_grads(layer)
    layer.zero_grad()
    x = x0.clone().requires_grad_(True)
    got = rec.rec_block_train(x, _rec_split(layer, n, cfg), cfg)
    torch.testing.assert_close(got, want, **BLOCK_TOL)
    got.square().sum().backward()
    torch.testing.assert_close(x.grad, want_x, **BLOCK_TOL)
    for name, g in _params_grads(layer).items():
        torch.testing.assert_close(g, want_p[name], msg=name, **BLOCK_TOL)
    jparams = {k: jnp.asarray(v.detach().numpy()) for k, v in layer.named_parameters()}
    jout = jrec.rec_block_train(jnp.asarray(x0.numpy()), jparams, jcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jout), **BLOCK_TOL)
    # prefill, then a decode step: each position's cache holds its channels
    with torch.no_grad():
        split = _rec_split(layer, n, cfg)
        want, cache = rec.rec_block_prefill(x0, layer, cfg)
        got, caches = rec.rec_block_prefill(x0, split, cfg)
        torch.testing.assert_close(got, want, **BLOCK_TOL)
        for k in ("conv", "h"):
            torch.testing.assert_close(torch.cat([c[k] for c in caches], -1), cache[k], **BLOCK_TOL)
        step = x0[:, :1]
        want, cache = rec.rec_block_decode(step, layer, cfg, cache)
        got, caches = rec.rec_block_decode(step, split, cfg, caches)
        torch.testing.assert_close(got, want, **BLOCK_TOL)
        torch.testing.assert_close(torch.cat([c["h"] for c in caches], -1), cache["h"],
                                   **BLOCK_TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_moe_experts_over_the_model_axis_match_the_whole_layer(n):
    """(f) 4 experts over ``n`` positions: every position routes the same
    tokens with the whole router and combines the picks its experts hold;
    the sum of the partial combines, the aux loss and every gradient
    against the whole layer."""
    cfg = _cfg("qwen3_moe_235b_a22b")
    layer = tmoe.moe_init(torch.Generator().manual_seed(6), cfg, "cpu").requires_grad_(True)
    x0 = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(7))
    x = x0.clone().requires_grad_(True)
    want, want_aux = tmoe.moe_ffn(x, layer, cfg)
    (want.square().sum() + want_aux).backward()
    want_x, want_p = x.grad, _params_grads(layer)
    layer.zero_grad()
    e = cfg.moe.n_experts
    spans = [(t * e // n, (t + 1) * e // n) for t in range(n)]
    parts = [types.SimpleNamespace(router=layer.router, **{
        k: getattr(layer, k)[e0:e1] for k in ("e_gate", "e_in", "e_out")}) for e0, e1 in spans]
    grp = col.Group(tuple(range(n)), (torch.device("cpu"),) * n)
    x = x0.clone().requires_grad_(True)
    got, aux = tmoe.moe_ffn(x, Split(parts, grp, [cfg] * n, spans), cfg)
    torch.testing.assert_close(got, want, **BLOCK_TOL)
    assert torch.equal(aux, want_aux)
    (got.square().sum() + aux).backward()
    torch.testing.assert_close(x.grad, want_x, **MOE_GRAD_TOL)
    for name, g in _params_grads(layer).items():
        torch.testing.assert_close(g, want_p[name], msg=name, **MOE_GRAD_TOL)


def test_layers_where_tp_is_not_worthwhile_run_whole():
    """(g) At a microbatch of 8 x 128 tokens (256 a data-parallel group)
    granite's attention (12,288 weights) and MLP (18,432) fall short of
    twice the activations a device (32,768): they run whole on a group's
    lead, only the vocabulary splits, and the step matches one device."""
    cfg = _cfg(n_layers=2)
    mesh = _mesh()
    tcfg = dataclasses.replace(TCFG, n_micro=1)
    placed, ctx, plan = _plan(cfg, mesh, (8, 128, cfg.d_model))
    with sh.use_ctx(ctx):
        assert not sh.tp_worthwhile((8, 128, cfg.d_model), 12288)
    assert plan.layers == [{}, {}] and plan.vocab == [(0, 64), (64, 128)]
    assert all(r[1] is None for n, r in plan.regions.items() if n.startswith("blocks."))
    batch = _batch(cfg, seq=128)
    _steps_agree(_steps(cfg, batch, mesh, tcfg), _steps(cfg, batch, tcfg=tcfg))
