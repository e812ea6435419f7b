"""The port's ``PagedEngine`` against the JAX package's, on the CPU.

Reduced granite_3_2b with two layers and the JAX serving tests' engine
settings.  Both engines hold the same weights (``params_from_numpy``) and
decode the same prompts, made with numpy from a seed.  Live rebalances are
driven with ``tick()`` then ``poll(block=True)`` on both sides, so that
verdicts land at the same tick (harvest timing otherwise depends on the
device).  Tokens, host tables and dirty/in-flight bits must be equal, pools
within rtol = atol = 1e-5 (matrix products sum in different orders).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.smoke import reduce as jax_reduce  # noqa: E402
from repro.core import LeapConfig as JLeapConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import PagedConfig as JPagedConfig  # noqa: E402
from repro.serving.engine import PagedEngine as JPagedEngine  # noqa: E402
from repro_torch.api import HandleStatus  # noqa: E402
from repro_torch.configs.base import get_config as torch_config  # noqa: E402
from repro_torch.configs.smoke import reduce as torch_reduce  # noqa: E402
from repro_torch.core import LeapConfig  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving.engine import PagedConfig, PagedEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
HEAT_TOL = dict(rtol=1e-6, atol=1e-6)
LIVE = dict(initial_area_blocks=2, chunk_blocks=1, budget_blocks_per_tick=1,
            max_attempts_before_force=3)


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jax_reduce(jax_config("granite_3_2b")), n_layers=2)
    tc = dataclasses.replace(torch_reduce(torch_config("granite_3_2b")), n_layers=2)
    jparams = jlm.init_params(jax.random.key(0), jc)
    model = tlm.params_from_numpy(jax.tree.map(np.asarray, jparams), tc, "cpu")
    return jc, tc, jparams, model


def _pcfg(cls, leap, **kw):
    return cls(block_tokens=4, max_blocks_per_seq=16, n_regions=2, slots_per_region=64,
               leap=leap, **kw)


def _engines(models, **leap_kw):
    jc, tc, jparams, model = models
    jeng = JPagedEngine(jc, jparams, _pcfg(JPagedConfig, JLeapConfig(**leap_kw)))
    teng = PagedEngine(tc, model, _pcfg(PagedConfig, LeapConfig(**leap_kw)), device="cpu")
    return jeng, teng


def _assert_same_state(jeng, teng):
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


def test_engine_decodes_like_jax(models):
    jeng, teng = _engines(models)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, models[0].vocab_size, size=n) for n in (5, 9, 12)]
    sids = [(jeng.admit(p, region=i % 2), teng.admit(p, region=i % 2))
            for i, p in enumerate(prompts)]
    assert [teng.seqs[t].tokens for _, t in sids] == [jeng.seqs[j].tokens for j, _ in sids]
    _assert_same_state(jeng, teng)
    jsids, tsids = [j for j, _ in sids], [t for _, t in sids]
    for _ in range(6):
        assert teng.decode(tsids) == jeng.decode(jsids)
    _assert_same_state(jeng, teng)
    assert [teng.seqs[t].block_ids for t in tsids] == [jeng.seqs[j].block_ids for j in jsids]


@pytest.mark.parametrize("tiering", [False, True], ids=["plain", "tiering"])
def test_live_rebalance_decodes_like_jax(models, tiering):
    """Pages leap-migrate while both engines decode; appends dirty in-flight
    pages, so commits are rejected and retried on both sides alike."""
    jeng, teng = _engines(models, tiering=tiering, **LIVE)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, models[0].vocab_size, size=n) for n in (10, 7)]
    jsids = [jeng.admit(p, region=0) for p in prompts]
    tsids = [teng.admit(p, region=0) for p in prompts]
    hj, ht = jeng.rebalance(jsids[0], dst_region=1), teng.rebalance(tsids[0], dst_region=1)
    assert ht.requested == hj.requested == len(teng.seqs[tsids[0]].block_ids)
    for _ in range(10):
        for eng in (jeng, teng):
            eng.tick()
            eng.session.poll(block=True)
        assert teng.decode(tsids) == jeng.decode(jsids)
        _assert_same_state(jeng, teng)
    assert jeng.drain() and teng.drain()
    _assert_same_state(jeng, teng)
    js, ts = dataclasses.asdict(jeng.driver.stats), dataclasses.asdict(teng.driver.stats)
    js.pop("jit_cache_misses"), ts.pop("jit_cache_misses")
    assert ts == js
    assert ts["dirty_rejections"] > 0  # the write trap fired on appends
    assert dataclasses.asdict(ht.progress()) == dataclasses.asdict(hj.progress())
    seq = teng.seqs[tsids[0]]
    assert (teng.facade.region_of(np.asarray(seq.block_ids)) == 1).all()


def test_paged_decode_matches_the_contiguous_decode_step(models):
    """``test_paged_matches_contiguous`` on the port alone."""
    _, tc, _, model = models
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, tc.vocab_size, size=9)  # crosses a block boundary
    logits, cache = model.prefill(torch.from_numpy(prompt)[None], len(prompt) + 6)
    want = [int(torch.argmax(logits, -1)[0])]
    for pos in range(len(prompt), len(prompt) + 5):
        logits, cache = tlm.decode_step(model, cache, torch.tensor([[want[-1]]]), pos, tc)
        want.append(int(torch.argmax(logits, -1)[0]))
    eng = PagedEngine(tc, model, _pcfg(PagedConfig, LeapConfig()), device="cpu")
    sid = eng.admit(prompt)
    got = [eng.seqs[sid].tokens[-1]]
    for _ in range(5):
        got.extend(eng.decode([sid]))
    assert got == want
    torch.testing.assert_close(eng.last_logits, logits, **TOL)


def test_rebalance_handle_release_and_accounting(models):
    _, tc, _, model = models
    eng = PagedEngine(tc, model, _pcfg(PagedConfig, LeapConfig(telemetry=True)), device="cpu")
    free_before = eng.free_pages()
    sid = eng.admit(np.arange(8) % tc.vocab_size, tenant="gold")
    n_pages = len(eng.seqs[sid].block_ids)
    assert eng.page_accounting()["per_tenant"] == {"gold": n_pages}
    h = eng.rebalance(sid, dst_region=1)
    assert h.tag == sid and h.requested == n_pages and h.wait()
    assert h.status == HandleStatus.COMMITTED
    assert (eng.facade.region_of(np.asarray(eng.seqs[sid].block_ids)) == 1).all()
    assert eng.decide(eng.facade) == []  # every page home: no moves
    lat = eng.rebalance_latency(sid)
    assert lat is not None and lat.outcome == "COMMITTED" and lat.requested == n_pages
    eng.observe_tokens("gold", [1, 2, 3])
    stats = eng.tenant_stats()["gold"]
    assert stats["tokens"] == 3 and stats["migration_bytes"] == n_pages * eng.pool_cfg.block_bytes
    text = eng.telemetry().metrics_text()
    assert 'leap_tenant_tokens_total{tenant="gold"} 3' in text
    acc = eng.page_accounting()
    assert acc["used"] + acc["spare"] + acc["free"] == acc["total"]
    eng.release(sid)
    assert eng.free_pages() == free_before and eng.driver.verify_mirror()


def test_huge_pages_promote_behind_the_frontier(models):
    _, tc, _, model = models
    eng = PagedEngine(tc, model, _pcfg(PagedConfig, LeapConfig(), huge_factor=2), device="cpu")
    sid = eng.admit(np.arange(13) % tc.vocab_size)
    for _ in range(4):
        eng.decode([sid])
    assert eng.seqs[sid].promoted and eng.driver.verify_tiers()
    acc = eng.page_accounting()
    assert acc["used"] + acc["spare"] + acc["free"] == acc["total"]


def test_engine_refuses_what_it_cannot_serve(models, monkeypatch):
    """MoE stacks serve; kinds without a global KV cache do not."""
    _, tc, _, model = models
    pcfg = _pcfg(PagedConfig, LeapConfig())
    moe_cfg = dataclasses.replace(torch_reduce(torch_config("qwen3_moe_235b_a22b")), n_layers=2)
    moe_model = tlm.init_params(torch.Generator().manual_seed(0), moe_cfg, "cpu")
    eng = PagedEngine(moe_cfg, moe_model, pcfg, device="cpu")
    sid = eng.admit(np.arange(6) % moe_cfg.vocab_size)
    assert len(eng.decode([sid])) == 1
    for kind in ("win", "rec", "mlstm", "slstm"):
        with pytest.raises(ValueError, match=kind):
            PagedEngine(dataclasses.replace(tc, layer_pattern=(kind,)), model, pcfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedEngine(tc, model, pcfg)  # no device given: CUDA, and there is none


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "granite_3_2b", "--smoke", "--device", "cpu", "--requests", "3",
                "--tokens", "5", "--rebalance"])
    out = capsys.readouterr().out
    assert "admitted 3 requests" in out and "migration stats" in out and "on cpu" in out


def test_import_guard_walks_the_serving_slice():
    """``test_torch_driver``'s import checks walk every port module; the
    serving slice's subpackages are among them."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {
        "repro_torch.configs.granite_3_2b", "repro_torch.configs.qwen2_7b",
        "repro_torch.models.lm", "repro_torch.kernels.paged_attn",
        "repro_torch.serving.engine", "repro_torch.launch.serve",
    } <= names
