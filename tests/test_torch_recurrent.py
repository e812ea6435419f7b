"""The port's recurrent slice against the JAX package, on the CPU.

K5's plain version (``kernels/ref.py::lru_scan_ref``) and ``ops.lru_scan``
against the JAX kernel body (``lru_scan_pallas`` in interpret mode) and the
JAX oracle; ``models/recurrent.py`` against the JAX module; and the reduced
recurrentgemma_9b through ``prefill`` and ``decode_step`` against the JAX
``lm``.  Inputs are made with numpy from a seed and handed to both.

Tolerances: the JAX kernel tests' own for the scan (rtol = atol = 1e-5 in
f32, 2e-2 in bf16); 1e-5 in f32 for the model (the two frameworks sum matrix
products, and the JAX oracle the recurrence, in other orders).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.smoke import reduce as jax_reduce  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.lru_scan import lru_scan_pallas  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.configs.base import get_config as torch_config  # noqa: E402
from repro_torch.configs.smoke import reduce as torch_reduce  # noqa: E402
from repro_torch.kernels import lru_scan as lru_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402

ARCH = "recurrentgemma_9b"
TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_TOL = {"float32": TOL, "bfloat16": dict(rtol=2e-2, atol=2e-2)}
CASES = [  # (B, T, R, chunk, tile): tests/test_kernels_lru_scan.py's
    (2, 32, 128, 8, 128),
    (1, 64, 256, 16, 128),
    (3, 16, 128, 8, 128),
]
# lru_width 128, so that the JAX rglru_scan takes its ops.lru_scan route at
# T % 8 == 0 (at reduce()'s width of 64 it takes the associative fallback)
R = 128


def _as_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("moe"), d.pop("notes")  # notes are prose
    return d


def _f32(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


# -- K5: the scan ---------------------------------------------------------------


def _scan_inputs(b, t, r, dtype, seed=0):
    """(JAX a, b, h0), (torch a, b, h0): the same f32 draws, cast to dtype alike."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-(rng.normal(size=(b, t, r)) + 2.0)))
    arrs = [x.astype(np.float32) for x in (a, rng.normal(size=(b, t, r)), rng.normal(size=(b, r)))]
    jax_side = tuple(jnp.asarray(x, getattr(jnp, dtype)) for x in arrs)
    torch_side = tuple(torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrs)
    return jax_side, torch_side


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lru_scan_plain_version_matches_the_pallas_kernel_body(case, dtype):
    b, t, r, chunk, tile = case
    (ja, jb, jh), (ta, tb, th) = _scan_inputs(b, t, r, dtype)
    want = lru_scan_pallas(ja, jb, jh, chunk=chunk, tile=tile, interpret=True)
    before = lru_mod.lru_scan.launches
    for got in (ref.lru_scan_ref(ta, tb, th), ops.lru_scan(ta, tb, th)):
        assert got.dtype == ta.dtype and tuple(got.shape) == (b, t, r)
        np.testing.assert_allclose(_f32(got), _f32(want), **SCAN_TOL[dtype])
    assert lru_mod.lru_scan.launches == before  # a CPU tensor launches nothing


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lru_scan_takes_shapes_the_pallas_kernel_does_not_tile(dtype):
    (ja, jb, jh), (ta, tb, th) = _scan_inputs(2, 17, 96, dtype, seed=1)
    want = jref.lru_scan_ref(ja, jb, jh)
    for got in (ref.lru_scan_ref(ta, tb, th), ops.lru_scan(ta, tb, th, impl="ref")):
        np.testing.assert_allclose(_f32(got), _f32(want), **SCAN_TOL[dtype])


def test_lru_scan_plain_version_is_the_sequential_loop():
    """Each step rounds a*h and then +b in fp32, the CUDA kernel's order."""
    _, (ta, tb, th) = _scan_inputs(1, 9, 128, "float32", seed=3)
    an, bn, h = ta.numpy(), tb.numpy(), th.numpy()[0].copy()
    rows = []
    for t in range(9):
        h = (an[0, t] * h).astype(np.float32) + bn[0, t]
        rows.append(h.copy())
    np.testing.assert_array_equal(ref.lru_scan_ref(ta, tb, th).numpy()[0], np.stack(rows))


def test_lru_scan_dispatch_on_the_cpu():
    _, (ta, tb, th) = _scan_inputs(2, 8, 128, "float32")
    with pytest.raises(ValueError, match="cuda"):
        ops.lru_scan(ta, tb, th, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.lru_scan(ta, tb, th, impl="pallas")
    assert torch.equal(lru_mod.lru_scan(ta, tb, th), ref.lru_scan_ref(ta, tb, th))


# -- models/recurrent.py --------------------------------------------------------


def _cfgs(**overrides):
    jc = dataclasses.replace(jax_reduce(jax_config(ARCH)), lru_width=R, **overrides)
    tc = dataclasses.replace(torch_reduce(torch_config(ARCH)), lru_width=R, **overrides)
    return jc, tc


def _rglru_pair(seed=0):
    """JAX ``rglru_init`` params, with random biases so that their paths
    count, and the port's ``RGLRU`` holding the same values."""
    jc, tc = _cfgs()
    tree = {k: np.asarray(v) for k, v in jrec.rglru_init(jax.random.key(seed), jc).items()}
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "bi", "br"):
        tree[name] = (rng.normal(size=tree[name].shape) * 0.5).astype(np.float32)
    params = trec.RGLRU(tc, "cpu")
    with torch.no_grad():
        for name, val in tree.items():
            getattr(params, name).copy_(torch.from_numpy(val.copy()))
    return jc, tc, {k: jnp.asarray(v) for k, v in tree.items()}, params


def _normal(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("t", [16, 17])
def test_gates_conv_and_scan_match_jax(t):
    _, _, jp, tp = _rglru_pair()
    xc = _normal((2, t, R), seed=t)
    h0 = _normal((2, R), seed=t + 100)
    ja, jb = jrec._gates(jnp.asarray(xc), jp)
    ta, tb = trec._gates(torch.from_numpy(xc), tp)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    jconv = jrec.causal_conv(jnp.asarray(xc), jp["conv_w"], jp["conv_b"])
    tconv = trec.causal_conv(torch.from_numpy(xc), tp.conv_w, tp.conv_b)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), **TOL)
    # T = 16 takes the JAX ops.lru_scan route, T = 17 its associative fallback
    for h in (None, h0):
        jy, jh = jrec.rglru_scan(jnp.asarray(xc), jp, None if h is None else jnp.asarray(h))
        ty, th = trec.rglru_scan(torch.from_numpy(xc), tp, None if h is None else torch.from_numpy(h))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        assert th.dtype == torch.float32 and ty.dtype == torch.float32


def test_causal_conv_is_causal_for_any_length():
    """Shorter sequences than the window: each output sees only its past
    (the JAX form needs S > W - 2; the port's takes any S)."""
    _, _, _, tp = _rglru_pair()
    x = torch.from_numpy(_normal((2, 6, R), seed=4))
    full = trec.causal_conv(x, tp.conv_w, tp.conv_b)
    for s in (1, 2, 3):
        torch.testing.assert_close(trec.causal_conv(x[:, :s], tp.conv_w, tp.conv_b), full[:, :s],
                                   rtol=0, atol=0)


def test_rglru_step_matches_jax():
    _, _, jp, tp = _rglru_pair(seed=1)
    xc, h = _normal((3, 1, R), seed=5), _normal((3, R), seed=6)
    jy, jh = jrec.rglru_step(jnp.asarray(xc), jp, jnp.asarray(h))
    ty, th = trec.rglru_step(torch.from_numpy(xc), tp, torch.from_numpy(h))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def _assert_cache(tc_, jc_):
    assert set(tc_) == set(jc_)
    for k in tc_:
        assert tc_[k].shape == tuple(np.shape(jc_[k])), k
        np.testing.assert_allclose(_f32(tc_[k]), _f32(jc_[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("s", [3, 16])
def test_rec_block_prefill_and_decode_match_jax(s):
    jc, tc, jp, tp = _rglru_pair(seed=2)
    x = _normal((2, s, jc.d_model), seed=s)
    jout, jcache = jrec.rec_block_prefill(jnp.asarray(x), jp, jc)
    tout, tcache = trec.rec_block_prefill(torch.from_numpy(x), tp, tc)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    _assert_cache(tcache, jcache)
    for step in range(3):
        xt = _normal((2, 1, jc.d_model), seed=50 + step)
        jout, jcache = jrec.rec_block_decode(jnp.asarray(xt), jp, jc, jcache)
        tout, tcache = trec.rec_block_decode(torch.from_numpy(xt), tp, tc, tcache)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        _assert_cache(tcache, jcache)


def test_rec_block_prefill_shorter_than_the_conv_window():
    """S = 2 < W - 1: the conv tail is left-padded with zeros.  The JAX
    prefill cannot run it (its causal_conv needs S > W - 2), so the port's
    S = 2 prefill, continued by decode, is held against the JAX S = 16
    prefill of the same tokens, position by position."""
    jc, tc, jp, tp = _rglru_pair(seed=3)
    x = _normal((2, 16, jc.d_model), seed=7)
    want, _ = jrec.rec_block_prefill(jnp.asarray(x), jp, jc)
    out, cache = trec.rec_block_prefill(torch.from_numpy(x[:, :2]), tp, tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(want)[:, :2], **TOL)
    z = x[:, :2] @ np.asarray(jp["w_x"])
    np.testing.assert_allclose(cache["conv"].numpy()[:, 1:], z, **TOL)
    assert not cache["conv"][:, 0].any() and cache["h"].dtype == torch.float32
    for pos in range(2, 16):
        out, cache = trec.rec_block_decode(torch.from_numpy(x[:, pos : pos + 1]), tp, tc, cache)
        np.testing.assert_allclose(out.numpy()[:, 0], np.asarray(want)[:, pos], **TOL)


# -- the slice as a whole: prefill -> decode_step ------------------------------------


def _model_pair(seed=0, **overrides):
    jc, tc = _cfgs(**overrides)
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(seed), jc))
    return jc, tc, tree, jax.tree.map(jnp.asarray, tree), tlm.params_from_numpy(tree, tc, "cpu")


def _jax_layer_caches(jcache, cfg):
    """The JAX cache as a list in layer order: period entries unstacked."""
    per = len(cfg.layer_pattern)
    out = [
        {k: v[rep] for k, v in jcache["period"][pos].items()}
        for rep in range(cfg.repeats)
        for pos in range(per)
    ]
    return out + list(jcache["tail"])


def _assert_model_caches(tcache, jcache, cfg):
    jl = _jax_layer_caches(jcache, cfg)
    assert len(tcache) == len(jl) == cfg.n_layers
    for kind, t, j in zip(cfg.layer_pattern * cfg.repeats + cfg.tail_pattern, tcache, jl):
        assert set(t) == ({"conv", "h"} if kind == "rec" else {"k", "v"})
        _assert_cache(t, j)


@pytest.mark.parametrize("shape", [(2, 16), (2, 11)])
def test_prefill_and_decode_match_jax(shape):
    jc, tc, _, jparams, model = _model_pair(seed=1)
    assert tc.layer_kinds.count("rec") == 6 and tc.tail_pattern == ("rec", "rec")
    prompt = np.random.default_rng(shape[1]).integers(0, jc.vocab_size, size=shape).astype(np.int32)
    max_len = shape[1] + 4
    jlog, jcache = jlm.prefill(jparams, jnp.asarray(prompt), jc, max_len)
    tlog, tcache = model.prefill(torch.from_numpy(prompt.astype(np.int64)), max_len)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_model_caches(tcache, jcache, tc)
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jc))
    tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]
    for pos in range(shape[1], shape[1] + 4):
        jlog, jcache = step(jparams, jcache, jnp.asarray(tok), jnp.int32(pos))
        tlog, tcache = tlm.decode_step(model, tcache, torch.from_numpy(tok.astype(np.int64)),
                                       pos, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        _assert_model_caches(tcache, jcache, tc)
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]


def test_teacher_forced_decode_matches_prefill():
    """Feeding the prompt one token at a time through ``decode_step`` from an
    empty cache reproduces the prefill's last logits (tests/test_models_smoke.py's
    check, here in f32 and past the window of 8)."""
    _, tc, _, _, model = _model_pair(seed=4)
    seq = 12
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, tc.vocab_size, size=(1, seq)))
    want, _ = model.prefill(toks, seq + 1)
    cache = model.init_cache(1, seq + 1)
    for i in range(seq):
        got, cache = model.decode_step(cache, toks[:, i : i + 1], i)
    torch.testing.assert_close(got, want, **TOL)


# -- configs, parameters, entry points --------------------------------------------


def test_config_and_reduction_match_jax():
    tc, jc = torch_config(ARCH), jax_config(ARCH)
    assert _as_dict(tc) == _as_dict(jc) and tc.notes == jc.notes
    assert _as_dict(torch_reduce(tc)) == _as_dict(jax_reduce(jc))
    assert tc.param_count() == jc.param_count() == 9_396_408_320
    assert tc.layer_kinds.count("rec") == 26 and tc.layer_kinds.count("win") == 12


def _tree_leaves(tree, cfg):
    """(layer index or None, path, leaf) for every JAX leaf, period leaves
    unstacked, tail included."""
    out = [(None, (name,), tree[name]) for name in ("embed", "lm_head", "final_norm")
           if name in tree]

    def walk(node, layer, path, idx):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, layer, path + (k,), idx)
            else:
                out.append((layer, path + (k,), v if idx is None else v[idx]))

    per = len(cfg.layer_pattern)
    for rep in range(cfg.repeats):
        for pos in range(per):
            walk(tree["period"][pos], rep * per + pos, (), rep)
    for i, sub in enumerate(tree["tail"]):
        walk(sub, cfg.repeats * per + i, (), None)
    return out


def test_params_from_numpy_round_trips_a_bf16_tree_exactly():
    jc, tc, tree, _, model = _model_pair(seed=5, param_dtype="bfloat16",
                                         compute_dtype="bfloat16")
    leaves = _tree_leaves(tree, jc)
    assert len(leaves) == len(list(model.parameters()))
    layers = {layer for layer, _, _ in leaves if layer is not None}
    assert layers == set(range(jc.n_layers))  # the two tail layers included
    fp32 = 0
    for layer, path, want in leaves:
        mod = model if layer is None else model.blocks[layer]
        for name in path:
            mod = getattr(mod, name)
        got = mod.detach()
        assert tuple(got.shape) == want.shape, (layer, path)
        if want.dtype == np.float32:  # lam, bi, br stay fp32 under bf16 params
            fp32 += 1
            assert got.dtype == torch.float32 and path[-1] in ("lam", "bi", "br")
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert got.dtype == torch.bfloat16, (layer, path)
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    assert fp32 == 3 * tc.layer_kinds.count("rec")


def test_serve_launcher_refuses_recurrentgemma_like_jax():
    """``PagedEngine`` serves global-attention stacks only; a recurrent stack
    goes through ``lm.prefill`` / ``lm.decode_step``, in both packages.  The
    JAX engine's refusal is taken from the engine itself: the JAX launcher's
    two-layer ``--smoke`` cut of this config has no full period, which its
    ``init_params`` cannot stack, so it fails before the engine."""
    from repro.serving.engine import PagedConfig as JaxPagedConfig
    from repro.serving.engine import PagedEngine as JaxPagedEngine
    from repro_torch.launch import serve as tserve

    jc = dataclasses.replace(jax_reduce(jax_config(ARCH)), n_layers=2)
    with pytest.raises(ValueError, match="kind 'rec'") as want:
        JaxPagedEngine(jc, None, JaxPagedConfig())
    with pytest.raises(ValueError, match="kind 'rec'") as got:
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_import_guard_walks_the_recurrent_slice():
    """``test_torch_driver``'s import checks walk every port module; the
    recurrent slice's modules are among them."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {
        "repro_torch.configs.recurrentgemma_9b", "repro_torch.models.recurrent",
        "repro_torch.kernels.lru_scan",
    } <= names
