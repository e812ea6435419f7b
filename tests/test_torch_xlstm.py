"""The port's xLSTM cells, blocks and the reduced xlstm_125m stack against
the JAX package, on the CPU.

Inputs and weights come from numpy and the JAX initialisers and cross as
host arrays.  Everything runs in f32; outputs, states and logits agree
within rtol = atol = 1e-5 (the two frameworks sum products in different
orders).  The cell cases are ``tests/test_xlstm_chunked.py``'s chunk sizes
and gate scales.  Prefill lengths sit on both sides of the reference's
chunked-cell threshold (``2 * _CHUNK`` = 128 tokens), so both packages
take the same cell.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.smoke import reduce as jax_reduce  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.configs.base import get_config as torch_config  # noqa: E402
from repro_torch.configs.smoke import reduce as torch_reduce  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _cell_inputs(b=2, s=96, h=4, hd=16, seed=0, gate_scale=1.0):
    """``tests/test_xlstm_chunked.py``'s inputs, as numpy arrays."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32) for _ in range(3))
    logi = (rng.normal(size=(b, s, h)) * gate_scale).astype(np.float32)
    logf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(rng.normal(size=(b, s, h)) + 2.0)),
                      np.float32)
    state = (np.zeros((b, h, hd, hd), np.float32), np.zeros((b, h, hd), np.float32),
             np.full((b, h), -1e30, np.float32))
    return (q, k, v, logi, logf), state


def _both_cells(xs, state, chunk):
    """(JAX, port) of the sequential and the chunked cell on the same inputs."""
    jxs, txs = tuple(map(jnp.asarray, xs)), tuple(map(_t, xs))
    jst, tst = tuple(map(jnp.asarray, state)), tuple(map(_t, state))
    return ((jx.mlstm_cell(*jxs, jst), tx.mlstm_cell(*txs, tst)),
            (jx.mlstm_cell_chunked(*jxs, jst, chunk), tx.mlstm_cell_chunked(*txs, tst, chunk)))


def _assert_cell(pair):
    (jh, jst), (th, tst) = pair
    _close(th, jh)
    for a, b in zip(tst, jst):
        _close(a, b)


@pytest.mark.parametrize("chunk", [16, 32, 96])
@pytest.mark.parametrize("gate_scale", [1.0, 5.0])  # large gates stress the stabiliser
def test_mlstm_cells_match_jax(chunk, gate_scale):
    xs, state = _cell_inputs(gate_scale=gate_scale)
    seq, chunked = _both_cells(xs, state, chunk)
    _assert_cell(seq)
    _assert_cell(chunked)


def test_mlstm_cells_with_nonzero_carry_match_jax():
    """Start from a mid-stream state (a prefill continuing a history)."""
    xs, state = _cell_inputs(s=64)
    head = tuple(jnp.moveaxis(jnp.asarray(x[:, :32]), 1, 0) for x in xs)
    carry, _ = jax.lax.scan(jx._mlstm_cell_step, tuple(map(jnp.asarray, state)), head)
    carry = tuple(np.asarray(c) for c in carry)
    assert (carry[2] > -1e29).all()  # the stabiliser has left its initial value
    seq, chunked = _both_cells(tuple(x[:, 32:] for x in xs), carry, 16)
    _assert_cell(seq)
    _assert_cell(chunked)


def _reduced(arch="xlstm_125m", **overrides):
    return (dataclasses.replace(jax_reduce(jax_config(arch)), **overrides),
            dataclasses.replace(torch_reduce(torch_config(arch)), **overrides))


def _cell_params(kind, jc, tc, seed):
    init = jx.mlstm_init if kind == "mlstm" else jx.slstm_init
    jp = init(jax.random.key(seed), jc)
    mod = tblocks._CELLS[kind][0](tc, CPU)
    tlm._load_tree(mod, jax.tree.map(np.asarray, jp), CPU)
    return jp, mod


def test_slstm_cell_step_and_scan_match_jax():
    jc, tc = _reduced()
    jp, mod = _cell_params("slstm", jc, tc, seed=4)
    rng = np.random.default_rng(4)
    b, d = 2, jc.d_model
    zero = np.zeros((b, d), np.float32)
    state = (zero, zero, np.full((b, d), -1e30, np.float32), zero)  # the prefill's start
    xs = rng.normal(size=(24, b, d)).astype(np.float32)
    jst, (tst,) = tuple(map(jnp.asarray, state)), (tuple(map(_t, state)),)
    jstep = jax.jit(lambda st, x: jx._slstm_cell_step(jp, st, x))
    for t in range(xs.shape[0]):  # the scan, step by step
        jst, jh = jstep(jst, jnp.asarray(xs[t]))
        tst, th = tx._slstm_cell_step(mod, tst, _t(xs[t]))
        _close(th, jh)
        for a, w in zip(tst, jst):
            _close(a, w)
    _close(tx._rec(_t(xs[0]), mod.ri), jx._rec(jnp.asarray(xs[0]), jp["ri"]))


@pytest.mark.parametrize("s", [96, 128])  # the sequential cell, then the chunked one
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_prefill_then_decode_match_jax(kind, s):
    jc, tc = _reduced()
    jp, mod = _cell_params(kind, jc, tc, seed=5)
    jblock, tblock = (jx.mlstm_block, tx.mlstm_block) if kind == "mlstm" else (
        jx.slstm_block, tx.slstm_block)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, s + 3, jc.d_model)).astype(np.float32)
    jy, jcache = jax.jit(lambda p, v: jblock(v, p, jc, mode="prefill"))(jp, jnp.asarray(x[:, :s]))
    ty, tcache = tblock(_t(x[:, :s]), mod, tc, mode="prefill")
    _close(ty, jy)
    jdec = jax.jit(lambda p, c, v: jblock(v, p, jc, c, mode="decode"))
    for t in range(s, s + 3):
        assert set(tcache) == set(jcache)
        for name in jcache:
            _close(tcache[name], jcache[name])
        jy, jcache = jdec(jp, jcache, jnp.asarray(x[:, t : t + 1]))
        ty, tcache = tblock(_t(x[:, t : t + 1]), mod, tc, tcache, mode="decode")
        _close(ty, jy)


def test_short_prefill_matches_jax_decode_from_an_empty_cache():
    """A 2-token prompt is shorter than the conv window (4), which the
    reference's prefill cannot take (ROADMAP R5).  The port's prefill
    left-pads the conv history with zeros, and leaves the cache that two JAX
    decode steps from an empty cache leave."""
    jc, tc = _reduced()
    for kind in ("mlstm", "slstm"):
        jp, mod = _cell_params(kind, jc, tc, seed=6)
        jblock = jx.mlstm_block if kind == "mlstm" else jx.slstm_block
        tblock = tx.mlstm_block if kind == "mlstm" else tx.slstm_block
        init = jx.init_mlstm_cache if kind == "mlstm" else jx.init_slstm_cache
        x = np.random.default_rng(6).normal(size=(1, 2, jc.d_model)).astype(np.float32)
        jcache = init(jc, 1)
        for t in range(2):
            jy, jcache = jblock(jnp.asarray(x[:, t : t + 1]), jp, jc, jcache, mode="decode")
        ty, tcache = tblock(_t(x), mod, tc, mode="prefill")
        _close(ty[:, -1:], jy)
        assert tcache["conv"].shape[1] == tc.conv_width - 1
        assert not tcache["conv"][:, 0].any()
        for name in jcache:
            _close(tcache[name], jcache[name])


def test_init_cache_matches_jax():
    jc, tc = _reduced()
    jcache = jlm.init_cache(jc, 2, 16)
    tcache = tlm.init_cache(tc, 2, 16, CPU)
    per = len(jc.layer_pattern)
    for li, c in enumerate(tcache):
        want = jcache["period"][li % per]
        assert set(c) == set(want)
        for name, v in c.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[name][li // per]))


@pytest.fixture(scope="module")
def stack():
    """The reduced xlstm_125m (8 layers: two periods of mlstm, mlstm,
    mlstm, slstm), its JAX weights and the port's model holding them."""
    jc, tc = _reduced()
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(7), jc))
    model = tlm.params_from_numpy(tree, tc, CPU)
    return jc, tc, tree, jax.tree.map(jnp.asarray, tree), model


def test_params_from_numpy_carries_cell_leaves_exactly(stack):
    jc, _, tree, _, model = stack
    per, n = len(jc.layer_pattern), 0
    for li, blk in enumerate(model.blocks):
        for name, want in tree["period"][li % per]["cell"].items():
            np.testing.assert_array_equal(getattr(blk.cell, name).detach().numpy(),
                                          want[li // per])
            n += 1
    # every parameter but the cells' is a norm1, the tied embedding or the final norm
    assert n == len(list(model.parameters())) - len(model.blocks) - 2


@pytest.mark.parametrize("s", [64, 192])  # sequential and chunked mLSTM prefills
def test_reduced_xlstm_prefill_and_decode_match_jax(stack, s):
    jc, tc, _, jparams, model = stack
    prompt = np.random.default_rng(s).integers(0, jc.vocab_size, size=(2, s)).astype(np.int32)
    jlog, jcache = jax.jit(lambda p, t: jlm.prefill(p, t, jc, s + 4))(jparams, jnp.asarray(prompt))
    tlog, tcache = model.prefill(torch.from_numpy(prompt.astype(np.int64)), s + 4)
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jc))
    per = len(jc.layer_pattern)
    for pos in range(s, s + 5):
        _close(tlog, jlog)
        for li, c in enumerate(tcache):
            for name, v in c.items():
                _close(v, jcache["period"][li % per][name][li // per])
        if pos == s + 4:
            break
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]
        assert torch.equal(tlog.argmax(-1), torch.from_numpy(tok[:, 0].astype(np.int64)))
        jlog, jcache = step(jparams, jcache, jnp.asarray(tok), jnp.int32(pos))
        tlog, tcache = tlm.decode_step(model, tcache, torch.from_numpy(tok.astype(np.int64)),
                                       pos, tc)
