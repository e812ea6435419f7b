"""The port's mixture-of-experts FFN and MoE stacks against the JAX package,
on the CPU.

Routing is held exactly: the dispatch sets and the capacity positions are
integers.  Gate-weighted sums (combine, aux loss) agree within 1e-6, FFN
outputs and logits within rtol = atol = 1e-5 in f32 (the two frameworks sum
products in different orders).  Every case runs at the smoke config's
``capacity_factor`` 8.0, where no pick drops, and at the published 1.25,
where picks over an expert's capacity drop; the tests check that they do.
Served stacks are driven with ``tick()`` then ``poll(block=True)`` on both
engines (ROADMAP R2).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.smoke import reduce as jax_reduce  # noqa: E402
from repro.core import LeapConfig as JLeapConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving.engine import PagedConfig as JPagedConfig  # noqa: E402
from repro.serving.engine import PagedEngine as JPagedEngine  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.configs.base import get_config as torch_config  # noqa: E402
from repro_torch.configs.smoke import reduce as torch_reduce  # noqa: E402
from repro_torch.core import LeapConfig  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving.engine import PagedConfig, PagedEngine  # noqa: E402
from test_torch_models import _as_dict  # noqa: E402
from test_torch_serving import LIVE, _assert_same_state  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ROUTE_TOL = dict(rtol=1e-6, atol=1e-6)
MOE_ARCHS = ["qwen3_moe_235b_a22b", "dbrx_132b"]
FACTORS = [8.0, 1.25]  # the smoke config's (nothing drops) and the published one


def _gates(t, e, seed, skew=2.0):
    """Softmax gates [T, E] from numpy; expert 0's logit is raised by
    ``skew`` so that it is over-subscribed and drops picks at small factors."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(t, e)).astype(np.float32)
    logits[:, 0] += skew
    return np.array(jax.nn.softmax(jnp.asarray(logits), -1))


def _cfgs(arch, factor, **overrides):
    jc = dataclasses.replace(jax_reduce(jax_config(arch)), **overrides)
    tc = dataclasses.replace(torch_reduce(torch_config(arch)), **overrides)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, capacity_factor=factor))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=factor))
    return jc, tc


def _picks(gates, mc, cap):
    """(kept, all) picks of the port's routing, gates [T, E]."""
    slot, _, _ = tmoe.route_slots(torch.from_numpy(gates)[None], mc, cap)
    return int((slot < mc.n_experts * cap).sum()), slot.numel()


def test_capacity_and_pick_groups_match_jax():
    for e, k, cf in [(4, 2, 8.0), (4, 2, 1.25), (16, 4, 1.25), (128, 8, 1.25), (8, 2, 0.1)]:
        for t in (1, 2, 7, 8, 64, 512, 4096):
            want = jmoe.capacity(JMoEConfig(e, k, 8, capacity_factor=cf), t)
            assert tmoe.capacity(MoEConfig(e, k, 8, capacity_factor=cf), t) == want, (e, k, cf, t)
    # the published decode batch of 8 against qwen3's 128 experts: capacity 1
    assert tmoe.capacity(torch_config("qwen3_moe_235b_a22b").moe, 8) == 1
    for t in (1, 7, 64, 100, 512, 4096):
        for target in (1, 2, 4, 64):
            assert tmoe._pick_groups(t, target) == jmoe._pick_groups(t, target), (t, target)


@pytest.mark.parametrize("norm_topk", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("e, k", [(4, 2), (16, 4)])
def test_route_matches_jax(e, k, factor, norm_topk):
    t = 32
    gates = _gates(t, e, seed=e + k)
    mc = MoEConfig(e, k, 8, capacity_factor=factor, norm_topk=norm_topk)
    jmc = JMoEConfig(e, k, 8, capacity_factor=factor, norm_topk=norm_topk)
    cap = tmoe.capacity(mc, t)
    jd, jc, ja = jmoe.route(jnp.asarray(gates), jmc, cap)
    td, tc, ta = tmoe.route(torch.from_numpy(gates), mc, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **ROUTE_TOL)
    np.testing.assert_allclose(float(ta), float(ja), **ROUTE_TOL)
    kept, picks = _picks(gates, mc, cap)
    assert kept == int(np.asarray(jd).sum())
    assert (kept < picks) == (factor < 8.0)  # drops exactly at the published factor


def test_route_breaks_exact_ties_toward_the_lower_expert_like_jax():
    """``jax.lax.top_k`` puts the lower index first among equal values; the
    port's stable sort does the same, both inside the top k and at its edge."""
    gates = np.asarray([[0.1, 0.3, 0.3, 0.3],  # three-way tie for two ranks
                        [0.25, 0.25, 0.25, 0.25],  # all tied
                        [0.2, 0.4, 0.0, 0.4]], np.float32)  # tie for rank 0
    for norm in (True, False):
        mc, jmc = MoEConfig(4, 2, 8, norm_topk=norm), JMoEConfig(4, 2, 8, norm_topk=norm)
        jd, jc, _ = jmoe.route(jnp.asarray(gates), jmc, 3)
        td, tc, _ = tmoe.route(torch.from_numpy(gates), mc, 3)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **ROUTE_TOL)
    picked = [sorted(np.nonzero(row.any(-1))[0].tolist()) for row in td.numpy()]
    assert picked == [[1, 2], [0, 1], [1, 3]]


def _moe_params(jc, tc, seed):
    jp = jmoe.moe_init(jax.random.key(seed), jc)
    mod = tmoe.MoE(tc, "cpu")
    tlm._load_tree(mod, jax.tree.map(np.asarray, jp), torch.device("cpu"))
    return jp, mod


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax(arch, factor, groups):
    jc, tc = _cfgs(arch, factor)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, groups=groups))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, groups=groups))
    jp, mod = _moe_params(jc, tc, seed=groups)
    x = np.random.default_rng(groups).normal(size=(2, 12, jc.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn(jnp.asarray(x), jp, jc)
    ty, taux = tmoe.moe_ffn(torch.from_numpy(x), mod, tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def _stack(arch, factor, seed=0, **overrides):
    jc, tc = _cfgs(arch, factor, **overrides)
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(seed), jc))
    return jc, tc, tree, jax.tree.map(jnp.asarray, tree), tlm.params_from_numpy(tree, tc, "cpu")


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_stack_prefill_and_decode_match_jax(arch, factor):
    jc, tc, _, jparams, model = _stack(arch, factor, seed=1)
    assert tc.qk_norm == (arch == "qwen3_moe_235b_a22b")  # qwen3's QK-norm is on the path
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jc.vocab_size, size=(2, 11)).astype(np.int32)
    jlog, jcache = jlm.prefill(jparams, jnp.asarray(prompt), jc, 16)
    tlog, tcache = model.prefill(torch.from_numpy(prompt.astype(np.int64)), 16)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for li, c in enumerate(tcache):
        np.testing.assert_allclose(c["k"].numpy(), np.asarray(jcache["period"][0]["k"][li]), **TOL)
    tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]
    for pos in range(11, 15):
        jlog, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(tok), jnp.int32(pos), jc)
        tlog, tcache = tlm.decode_step(model, tcache, torch.from_numpy(tok.astype(np.int64)),
                                       pos, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]


def _pcfg(cls, leap):
    return cls(block_tokens=4, max_blocks_per_seq=16, n_regions=2, slots_per_region=64, leap=leap)


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_paged_engine_serves_moe_like_jax_under_live_migration(arch, factor, monkeypatch):
    """Both engines serve the same reduced two-layer MoE stack while one
    sequence's pages leap to the other region; decode appends dirty
    in-flight pages on both sides alike.  At the published factor a decode
    batch of 3 has capacity 1 an expert, so picks drop at every step."""
    jc, tc, _, jparams, model = _stack(arch, factor, seed=2, n_layers=2)
    jeng = JPagedEngine(jc, jparams, _pcfg(JPagedConfig, JLeapConfig(**LIVE)))
    teng = PagedEngine(tc, model, _pcfg(PagedConfig, LeapConfig(**LIVE)), device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jc.vocab_size, size=n) for n in (10, 7, 5)]
    jsids = [jeng.admit(p, region=0) for p in prompts]
    tsids = [teng.admit(p, region=0) for p in prompts]
    assert [teng.seqs[s].tokens for s in tsids] == [jeng.seqs[s].tokens for s in jsids]
    hj, ht = jeng.rebalance(jsids[0], dst_region=1), teng.rebalance(tsids[0], dst_region=1)
    assert ht.requested == hj.requested
    dropped = []
    route_slots = tmoe.route_slots

    def counting(gates, mc, cap):
        out = route_slots(gates, mc, cap)
        dropped.append(int((out[0] == mc.n_experts * cap).sum()))
        return out

    monkeypatch.setattr(tmoe, "route_slots", counting)
    jlogits = []  # the JAX engine keeps no logits: catch its step's output
    jstep = jeng._decode_step
    jeng._decode_step = lambda *a: jlogits.append(jstep(*a)) or jlogits[-1]
    for _ in range(8):
        for eng in (jeng, teng):
            eng.tick()
            eng.session.poll(block=True)
        assert teng.decode(tsids) == jeng.decode(jsids)
        np.testing.assert_allclose(teng.last_logits.numpy(), np.asarray(jlogits[-1][0]), **TOL)
        _assert_same_state(jeng, teng)
    assert jeng.drain() and teng.drain()
    _assert_same_state(jeng, teng)
    assert teng.driver.stats.dirty_rejections > 0
    assert dataclasses.asdict(ht.progress()) == dataclasses.asdict(hj.progress())
    assert len(dropped) == 8 * tc.n_layers
    assert all(d > 0 for d in dropped) if factor < 8.0 else not any(dropped)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_carries_moe_leaves_exactly(dtype):
    jc, tc, tree, _, model = _stack("qwen3_moe_235b_a22b", 8.0, seed=3, param_dtype=dtype,
                                    compute_dtype=dtype)
    n = 0
    for rep in range(jc.repeats):
        moe = model.blocks[rep].moe
        for name in ("router", "e_gate", "e_in", "e_out"):
            want = tree["period"][0]["moe"][name][rep]
            got = getattr(moe, name).detach()
            assert tuple(got.shape) == want.shape
            if want.dtype == np.float32:
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
            n += 1
    assert n == 4 * jc.repeats
    assert model.blocks[0].moe.router.dtype == torch.float32  # the router stays fp32


@pytest.mark.parametrize("arch", MOE_ARCHS + ["xlstm_125m"])
def test_new_configs_and_reductions_match(arch):
    tcfg, jcfg = torch_config(arch), jax_config(arch)
    assert _as_dict(tcfg) == _as_dict(jcfg)
    assert dataclasses.asdict(tcfg)["moe"] == dataclasses.asdict(jcfg)["moe"]
    tc, jc = torch_reduce(tcfg), jax_reduce(jcfg)
    assert _as_dict(tc) == _as_dict(jc)
    assert dataclasses.asdict(tc)["moe"] == dataclasses.asdict(jc)["moe"]
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_launcher_serves_moe_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3", "--tokens", "4",
                "--rebalance"])
    out = capsys.readouterr().out
    assert "admitted 3 requests" in out and "migration stats" in out and "on cpu" in out
