"""The models' and the queries' compiled programs against the JAX package,
on the CPU.

The reference jits TPC-H's ``q1_partial`` and ``q6_partial``,
``PagedEngine``'s prefill (one function a prompt length, ``_prefill_fns``)
and the trainer's step (its state donated).  The port compiles each as a
``graphs.Program`` (``tpch.Q1``/``Q6``, ``PagedEngine._prefill``,
``Trainer._step_fn``).  Here:

* the variants each registers equal the reference's ``_cache_size()``, or
  ``len(_prefill_fns)`` for the prefill;
* a query's parameter is an operand: two values go through one variant;
* two trainer steps from one state give the reference's metrics, within
  the tolerances of ``tests/test_torch_train.py`` (1e-5 before any update;
  1e-4 after an Adam step, as ``chip_smoke.py``'s ``TRAIN_LOSS_TOL``
  states: where ``|g|`` is near ``eps`` a last-bit gradient difference
  moves the update);
* the step counter is updated in place, the counterpart of donation.
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
from repro.data import tpch as jtpch  # noqa: E402
from repro.data.morsels import MorselStore as JStore  # noqa: E402
from repro.data.synthetic import DataConfig as JDataConfig  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import PagedConfig as JPagedConfig  # noqa: E402
from repro.serving.engine import PagedEngine as JPagedEngine  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs.base import get_config as torch_config  # noqa: E402
from repro_torch.configs.smoke import reduce as torch_reduce  # noqa: E402
from repro_torch.core import LeapConfig  # noqa: E402
from repro_torch.data import tpch  # noqa: E402
from repro_torch.data.morsels import MorselStore  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving.engine import PagedConfig, PagedEngine  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

LOSS_TOL = (dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-4, atol=1e-4))  # steps 1 and 2
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread, as tests/test_torch_train.py runs (the reduced
    models gain nothing from more beside other pytest workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch="granite_3_2b", **over):
    return (dataclasses.replace(jax_reduce(jax_config(arch)), n_layers=2, **over),
            dataclasses.replace(torch_reduce(torch_config(arch)), n_layers=2, **over))


# -- TPC-H --------------------------------------------------------------------------------


def test_queries_have_the_references_variants():
    """A morsel batch of 64 over 100 morsels: a full batch and the shorter
    last one, two variants each, through two parameter values; results
    within the tolerance of tests/test_torch_tpch.py."""
    data = tpch.gen_lineitem(100 * 32, 5)
    tstore = MorselStore.create(data, 32, 2, device="cpu")
    jstore = JStore.create(data, 32, 2)
    for prog, jf in ((tpch.Q1, jtpch.q1_partial), (tpch.Q6, jtpch.q6_partial)):
        prog.clear()
        jf.clear_cache()
    for which, params in (("q1", (2400.0, 1200.0)), ("q6", (730.0, 1095.0))):
        for p in params:
            got = np.asarray(tpch.run_query(tstore, which, p), np.float64)
            want = np.asarray(jtpch.run_query(jstore, which, p), np.float64)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    assert len(tpch.Q1) == jtpch.q1_partial._cache_size() == 2
    assert len(tpch.Q6) == jtpch.q6_partial._cache_size() == 2


def test_a_query_parameter_is_an_operand():
    """Two cutoffs through one variant give two results, and the partials
    are fresh tensors: the first is unchanged by the second."""
    morsels = torch.from_numpy(tpch.gen_lineitem(8 * 16, 2).reshape(8, 16, tpch.N_COLS))
    tpch.Q1.clear()
    a = tpch.q1_partial(morsels, 600.0)
    kept = a.clone()
    b = tpch.q1_partial(morsels, torch.tensor(np.float32(2400.0)))
    assert len(tpch.Q1) == 1
    assert torch.equal(a, kept) and not torch.equal(a, b)
    assert float(a[:, 5].sum()) < float(b[:, 5].sum())


# -- PagedEngine's prefill -----------------------------------------------------------------


def test_prefill_has_a_variant_per_prompt_length():
    jc, tc = _cfgs()
    jparams = jlm.init_params(jax.random.key(0), jc)
    model = tlm.params_from_numpy(jax.tree.map(np.asarray, jparams), tc, "cpu")
    kw = dict(block_tokens=4, max_blocks_per_seq=16, n_regions=2, slots_per_region=64)
    jeng = JPagedEngine(jc, jparams, JPagedConfig(leap=JLeapConfig(), **kw))
    teng = PagedEngine(tc, model, PagedConfig(leap=LeapConfig(), **kw), device="cpu")
    rng = np.random.default_rng(3)
    for n in (5, 9, 5, 12, 9):
        prompt = rng.integers(0, jc.vocab_size, n).astype(np.int32)
        js, ts = jeng.admit(prompt), teng.admit(prompt)
        assert teng.seqs[ts].tokens == jeng.seqs[js].tokens
        assert len(teng._prefill) == len(jeng._prefill_fns)
    assert len(teng._prefill) == 3
    np.testing.assert_allclose(teng.driver.state.to_numpy()[0], np.asarray(jeng.driver.state.pool),
                               rtol=1e-5, atol=1e-5)


# -- the trainer's step --------------------------------------------------------------------


def _trainers(tmp_path):
    jc, tc = _cfgs()
    kw = dict(seq_len=16, global_batch=4, seed=2)
    jtr = JTrainer(jc, jts.TrainConfig(optimizer=jopt.OptimizerConfig(**OPT)),
                   JTrainerConfig(total_steps=10, ckpt_every=1000, ckpt_dir=str(tmp_path / "j"),
                                  log_every=1, async_ckpt=False),
                   JSyntheticLM(JDataConfig(jc.vocab_size, **kw)))
    jtr.restore_or_init()
    tree = jax.tree.map(lambda x: np.array(x), jtr.state)
    ttr = Trainer(tc, tts.TrainConfig(optimizer=topt.OptimizerConfig(**OPT)),
                  TrainerConfig(total_steps=10, ckpt_every=1000, ckpt_dir=str(tmp_path / "t"),
                                log_every=1, async_ckpt=False),
                  SyntheticLM(DataConfig(tc.vocab_size, **kw)), device="cpu")
    ttr.state = tts.train_state_from_numpy(tree, tc, "cpu")
    return jtr, ttr


def test_trainer_step_matches_the_reference_with_its_variants(tmp_path):
    jtr, ttr = _trainers(tmp_path)
    jtr.run(until=2)
    ttr.run(until=2)
    for step, tol in enumerate(LOSS_TOL):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(ttr.history[step][key], jtr.history[step][key], **tol)
    assert len(ttr._step_fn) == jtr._step_fn._cache_size() == 1


def test_trainer_step_updates_the_counter_in_place(tmp_path):
    _, ttr = _trainers(tmp_path)
    step = ttr.state.opt["step"]
    ptr, params = step.data_ptr(), [p.data_ptr() for p in ttr.state.params.parameters()]
    for want in (1, 2):
        ttr.run(until=want)
        assert ttr.state.opt["step"] is step and step.data_ptr() == ptr
        assert int(step) == want
    assert [p.data_ptr() for p in ttr.state.params.parameters()] == params
