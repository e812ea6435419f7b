"""The port's configs and model stack against the JAX package, on the CPU.

Weights cross from the JAX ``init_params`` tree through
``params_from_numpy``; both packages then run the same tokens, made with
numpy from a seed.  fp32 reduced configs; logits agree within
rtol = atol = 1e-5 (the two frameworks sum matrix products in different
orders).
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
from repro_torch.configs.base import get_config as torch_config  # noqa: E402
from repro_torch.configs.smoke import reduce as torch_reduce  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["granite_3_2b", "qwen2_7b", "gemma2_27b", "nemotron_4_340b", "llava_next_34b",
         "musicgen_large"]


def _as_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("moe"), d.pop("notes")  # notes are prose
    return d


def _pair(arch, seed=0, **overrides):
    """Reduced configs of both packages, the JAX weights and the port's model
    holding them.  QKV biases get random values, so the bias path counts."""
    jc = dataclasses.replace(jax_reduce(jax_config(arch)), **overrides)
    tc = dataclasses.replace(torch_reduce(torch_config(arch)), **overrides)
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(seed), jc))
    if jc.qkv_bias:
        rng = np.random.default_rng(seed)
        attn = tree["period"][0]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = (rng.normal(size=attn[name].shape) * 0.5).astype(attn[name].dtype)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jc, tc, tree, jparams, tlm.params_from_numpy(tree, tc, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_reductions_match(arch):
    assert _as_dict(torch_config(arch)) == _as_dict(jax_config(arch))
    tc, jc = torch_reduce(torch_config(arch)), jax_reduce(jax_config(arch))
    assert _as_dict(tc) == _as_dict(jc)
    assert tc.dtype() == torch.float32 and torch_config(arch).pdtype() == torch.bfloat16
    assert tc.param_count() == jc.param_count()


def test_unported_configs_and_kinds_raise():
    """An architecture neither package knows raises; every block kind of the
    JAX package constructs, with the parameters of its kind."""
    with pytest.raises(ValueError, match="unknown architecture"):
        torch_config("llama3_8b")
    cfg = torch_reduce(torch_config("qwen3_moe_235b_a22b"))
    for kind, holds in (("moe", {"attn", "moe"}), ("mlstm", {"cell"}), ("slstm", {"cell"})):
        blk = tblocks.Block(cfg, kind, device="cpu")
        assert blk.kind == kind and {n for n, _ in blk.named_children()} == holds
    with pytest.raises(ValueError):
        tblocks.Block(cfg, "lstm", device="cpu")


def test_rope_is_half_split_and_matches_jax():
    from repro.models.common import apply_rope as jax_rope

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 1000, size=(2, 5))
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
                               **TOL)
    # the pair (i, i + hd/2) rotates together: position 0 is the identity
    zero = tcommon.apply_rope(torch.from_numpy(x), torch.zeros(2, 5), 1e4).numpy()
    np.testing.assert_allclose(zero, x, rtol=0, atol=0)


def _leaves(tree, cfg):
    """(path, layer index or None, leaf) for every JAX leaf, period leaves unstacked."""
    out = []

    def walk(node, path, layer, idx):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,), layer, idx)
            else:
                out.append((path + (k,), layer, v if idx is None else v[idx]))

    for name in ("embed", "lm_head", "final_norm"):
        if name in tree:
            out.append(((name,), None, tree[name]))
    per = len(cfg.layer_pattern)
    for rep in range(cfg.repeats):
        for pos in range(per):
            walk(tree["period"][pos], (), rep * per + pos, rep)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trips_exactly(dtype):
    jc, tc, tree, _, model = _pair("granite_3_2b", seed=3, param_dtype=dtype,
                                   compute_dtype=dtype)
    leaves = _leaves(tree, jc)
    assert len(leaves) == len(list(model.parameters()))
    for path, layer, want in leaves:
        mod = model if layer is None else model.blocks[layer]
        for name in path:
            mod = getattr(mod, name)
        got = mod.detach()
        assert tuple(got.shape) == want.shape, path
        if dtype == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def _inputs(cfg, rng, b, s):
    """Token ids, or seeded embeddings [B, S, D] for a stub-frontend arch:
    the same numpy array goes to both packages."""
    if cfg.embed_inputs:
        ids = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
        return jnp.asarray(ids), torch.from_numpy(ids.astype(np.int64))
    emb = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(emb), torch.from_numpy(emb)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    """Reduced prefill, then 4 decode steps: logits and every layer's cache
    (gemma2's window layers roll at the reduced window of 8, under both
    softcaps; llava and musicgen take seeded embeddings)."""
    jc, tc, _, jparams, model = _pair(arch, seed=1)
    rng = np.random.default_rng(1)
    jin, tin = _inputs(jc, rng, 2, 11)
    max_len = 16
    jlog, jcache = jlm.prefill(jparams, jin, jc, max_len)
    tlog, tcache = model.prefill(tin, max_len)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    per = len(jc.layer_pattern)

    def caches_agree():  # JAX stacks the period's repeats: layer li is (li // per, li % per)
        assert len(tcache) == jc.n_layers
        for li, c in enumerate(tcache):
            for k in ("k", "v"):
                np.testing.assert_allclose(
                    c[k].numpy(), np.asarray(jcache["period"][li % per][k][li // per]), **TOL)

    caches_agree()
    for pos in range(11, 15):
        if jc.embed_inputs:
            tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]
            jin, tin = jnp.asarray(tok), torch.from_numpy(tok.astype(np.int64))
        else:
            jin, tin = _inputs(jc, rng, 2, 1)
        jlog, jcache = jlm.decode_step(jparams, jcache, jin, jnp.int32(pos), jc)
        tlog, tcache = tlm.decode_step(model, tcache, tin, pos, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    caches_agree()


def test_sliding_window_blocks_match_jax():
    """``win`` layers: windowed prefill chunks and the rolling decode cache."""
    jc, tc, _, jparams, model = _pair("granite_3_2b", seed=2, layer_pattern=("win",),
                                      window=4, attn_softcap=30.0)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jc.vocab_size, size=(1, 10)).astype(np.int32)
    jlog, jcache = jlm.prefill(jparams, jnp.asarray(prompt), jc, 14)
    tlog, tcache = model.prefill(torch.from_numpy(prompt.astype(np.int64)), 14)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]
    for pos in range(10, 13):
        jlog, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(tok), jnp.int32(pos), jc)
        tlog, tcache = model.decode_step(tcache, torch.from_numpy(tok.astype(np.int64)), pos)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]


def test_init_params_draws_from_the_generator():
    cfg = torch_reduce(torch_config("granite_3_2b"))
    a = tlm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    b = tlm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    c = tlm.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), n
        if "norm" not in n:
            assert not torch.equal(pa, pc), n
            assert pa.abs().max() <= 2.0  # truncated at two standard deviations
    assert sum(p.numel() for p in a.parameters()) == cfg.param_count()


def test_init_params_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device, so the default is valid")
    cfg = torch_reduce(torch_config("granite_3_2b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.CausalLM(cfg)
    assert tlm.count_params(cfg) == cfg.param_count()  # built on "meta", no card needed
