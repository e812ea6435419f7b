"""The last four architectures against the JAX package, on the CPU:
nemotron_4_340b served through both packages' ``PagedEngine``, the paged
decode's plain version at nemotron's head_dim of 192, and how gemma2,
llava and musicgen are (not) served.

The engines run the reduced nemotron (two layers, f32) with the serving
tests' settings and blocking harvest (ROADMAP R2): tokens, host tables and
dirty/in-flight bits equal, pools and logits within rtol = atol = 1e-5.
K4's plain version at hd 192 and G 12 is held against the Pallas kernel in
interpret mode and the JAX oracle: within 1e-5 in f32 and 2e-3 in bf16.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.smoke import reduce as jax_reduce  # noqa: E402
from repro.core import LeapConfig as JLeapConfig  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attn import paged_decode_pallas  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import PagedConfig as JPagedConfig  # noqa: E402
from repro.serving.engine import PagedEngine as JPagedEngine  # noqa: E402
from repro_torch.configs.base import ARCH_IDS  # noqa: E402
from repro_torch.configs.base import get_config as torch_config  # noqa: E402
from repro_torch.configs.smoke import reduce as torch_reduce  # noqa: E402
from repro_torch.core import LeapConfig  # noqa: E402
from repro_torch.kernels import ops, paged_attn, ref  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving.engine import PagedConfig, PagedEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
HEAT_TOL = dict(rtol=1e-6, atol=1e-6)
LIVE = dict(initial_area_blocks=2, chunk_blocks=1, budget_blocks_per_tick=1,
            max_attempts_before_force=3)
# K4 at hd 192: f32 as tight as the sums allow; bf16 out is rounded to bf16
# (2^-8 relative), so rtol carries the rounding of the larger outputs
HD192_TOL = {False: dict(rtol=1e-5, atol=1e-5), True: dict(rtol=2e-3, atol=2e-3)}


def _pcfg(cls, leap):
    return cls(block_tokens=4, max_blocks_per_seq=16, n_regions=2, slots_per_region=64,
               leap=leap)


def test_all_ten_configs_match_the_reference():
    assert len(set(ARCH_IDS)) == 10
    for arch in ARCH_IDS:
        want = dataclasses.asdict(jax_config(arch))
        got = dataclasses.asdict(torch_config(arch))
        want.pop("notes"), got.pop("notes")  # prose
        assert got == want, arch
    nemo = torch_config("nemotron-4-340b")
    assert (nemo.n_heads // nemo.n_kv_heads, nemo.head_dim) == (12, 192)
    assert nemo.opt_state_dtype == nemo.grad_accum_dtype == "bfloat16"
    assert nemo.head_dim in paged_attn.HEAD_DIMS


@pytest.mark.parametrize("arch", ["nemotron_4_340b", "gemma2_27b", "llava_next_34b",
                                  "musicgen_large"])
def test_parameter_counts_match_the_reference(arch):
    tc, jc = torch_config(arch), jax_config(arch)
    assert tc.param_count() == jc.param_count()
    assert torch_reduce(tc).param_count() == jax_reduce(jc).param_count()


def test_nemotron_serves_like_jax_under_live_migration():
    """Reduced nemotron (relu², untied head) through both engines while one
    sequence's pages leap to the other region."""
    jc = dataclasses.replace(jax_reduce(jax_config("nemotron_4_340b")), n_layers=2)
    tc = dataclasses.replace(torch_reduce(torch_config("nemotron_4_340b")), n_layers=2)
    assert tc.mlp_kind == "relu2" and not tc.tie_embeddings
    jparams = jlm.init_params(jax.random.key(4), jc)
    model = tlm.params_from_numpy(jax.tree.map(np.asarray, jparams), tc, "cpu")
    jeng = JPagedEngine(jc, jparams, _pcfg(JPagedConfig, JLeapConfig(**LIVE)))
    teng = PagedEngine(tc, model, _pcfg(PagedConfig, LeapConfig(**LIVE)), device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jc.vocab_size, size=n) for n in (10, 7, 5)]
    jsids = [jeng.admit(p, region=0) for p in prompts]
    tsids = [teng.admit(p, region=0) for p in prompts]
    assert [teng.seqs[s].tokens for s in tsids] == [jeng.seqs[s].tokens for s in jsids]
    hj, ht = jeng.rebalance(jsids[0], dst_region=1), teng.rebalance(tsids[0], dst_region=1)
    assert ht.requested == hj.requested
    jlogits = []  # the JAX engine keeps no logits: catch its step's output
    jstep = jeng._decode_step
    jeng._decode_step = lambda *a: jlogits.append(jstep(*a)) or jlogits[-1]
    for _ in range(8):
        for eng in (jeng, teng):
            eng.tick()
            eng.session.poll(block=True)
        assert teng.decode(tsids) == jeng.decode(jsids)
        np.testing.assert_allclose(teng.last_logits.numpy(), np.asarray(jlogits[-1][0]), **TOL)
    assert jeng.drain() and teng.drain()
    jd, td = jeng.driver, teng.driver
    np.testing.assert_array_equal(td.host_table(), jd.host_table())
    pool, table, dirty, in_flight = td.state.to_numpy()
    np.testing.assert_array_equal(table, np.asarray(jd.state.table))
    np.testing.assert_array_equal(dirty, np.asarray(jd.state.dirty))
    np.testing.assert_array_equal(in_flight, np.asarray(jd.state.in_flight))
    np.testing.assert_allclose(pool, np.asarray(jd.state.pool), **TOL)
    np.testing.assert_allclose(td.heat_snapshot(), jd.heat_snapshot(), **HEAT_TOL)
    assert td.verify_mirror() and jd.verify_mirror()
    assert teng.page_accounting() == jeng.page_accounting()
    assert td.stats.dirty_rejections > 0
    assert dataclasses.asdict(ht.progress()) == dataclasses.asdict(hj.progress())


def test_window_and_stub_archs_are_refused_by_both_engines_and_the_launcher():
    """gemma2's window layers and the stub frontends serve through the
    contiguous path in both packages."""
    jc = dataclasses.replace(jax_reduce(jax_config("gemma2_27b")), n_layers=2)
    tc = dataclasses.replace(torch_reduce(torch_config("gemma2_27b")), n_layers=2)
    jparams = jlm.init_params(jax.random.key(0), jc)
    model = tlm.params_from_numpy(jax.tree.map(np.asarray, jparams), tc, "cpu")
    with pytest.raises(ValueError, match="win"):
        JPagedEngine(jc, jparams, _pcfg(JPagedConfig, JLeapConfig()))
    with pytest.raises(ValueError, match="win"):
        PagedEngine(tc, model, _pcfg(PagedConfig, LeapConfig()), device="cpu")
    from repro_torch.launch import serve

    for arch in ("llava_next_34b", "musicgen_large"):
        with pytest.raises(SystemExit, match="stub-frontend"):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


def _hd192_inputs(b, kvh, g, blk, maxb, seed, bf16):
    rng = np.random.default_rng(seed)
    hd, s = 192, b * maxb + 3
    q = rng.normal(size=(b, kvh * g, hd)).astype(np.float32)
    kv = rng.normal(size=(s, 2, blk, kvh, hd)).astype(np.float32)
    if bf16:
        q, kv = q.astype(ml_dtypes.bfloat16), kv.astype(ml_dtypes.bfloat16)
    tables = rng.choice(s, size=(b, maxb), replace=False).astype(np.int32)
    # lens on the kernel's split boundaries, 1 and the full table
    split = paged_attn.SPLIT_TOKENS
    lens = np.array([1, split - 1, split, split + 1, maxb * blk][:b], np.int32)
    return q, kv, tables, lens


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("g", [12, 1])  # nemotron's 96 / 8, and MHA
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_version_at_hd_192_matches_pallas_and_the_oracle(g, bf16):
    b, kvh, blk, maxb = 5, 2, 16, 6
    q, kv, tables, lens = _hd192_inputs(b, kvh, g, blk, maxb, seed=g, bf16=bf16)
    h, hd = kvh * g, 192
    out, m, l = paged_decode_pallas(
        jnp.asarray(q).reshape(b, kvh, g, hd), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(lens), interpret=True,
    )
    oracle = jref.paged_decode_ref(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
                                   jnp.asarray(lens))
    got = ref.paged_decode_ref(_torch(q), _torch(kv), _torch(tables), _torch(lens))
    tol = HD192_TOL[bf16]
    for want in ((out.reshape(b, h, hd), m.reshape(b, h), l.reshape(b, h)), oracle):
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(w, np.float32), **tol)
    # the wrapper in the kernel's layout takes the same plain version on the CPU
    kout, km, kl = paged_attn.paged_decode(_torch(q).reshape(b, kvh, g, hd), _torch(kv),
                                           _torch(tables), _torch(lens))
    assert torch.equal(kout.reshape(b, h, hd), got[0]) and torch.equal(kl.reshape(b, h), got[2])
    dispatched = ops.paged_decode_partial(_torch(q), _torch(kv), _torch(tables), _torch(lens),
                                          kv_heads=kvh)
    assert all(torch.equal(a, w) for a, w in zip(dispatched, got))
    assert paged_attn.paged_decode.launches_by_head_dim.get(192, 0) == 0  # no card, no launch
