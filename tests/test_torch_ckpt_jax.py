"""Checkpoints written by the JAX package restore in the port, on the CPU.

The JAX package's manifest names no leaf: its leaves are a JAX tree
flattening of the saved tree.  The port's ``ckpt.restore`` rebuilds that
order from the template's config and unstacks the period leaves through
``lm.named_leaves``.  A restored state must equal, bit for bit,
``train_state_from_numpy`` of the same JAX state, and the next training
step must give the JAX step's loss within 1e-6 relative (the two frameworks
sum in different orders).  The tiny config is ``tests/test_train.py``'s.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.smoke import reduce as jax_reduce  # noqa: E402
from repro.data.synthetic import DataConfig as JDataConfig  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.base import get_config as torch_config  # noqa: E402
from repro_torch.configs.smoke import reduce as torch_reduce  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)  # the loss is about 36: a few float32 ulps
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=30)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread, as in ``tests/test_torch_train.py``: beside other
    pytest workers the tiny model's threads wait on one another at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch="granite_3_2b", **kw):
    """tests/test_train.py's tiny config in both packages."""
    kw = dict(dict(n_layers=2, vocab_size=64), **kw)
    return (dataclasses.replace(jax_reduce(jax_config(arch)), **kw),
            dataclasses.replace(torch_reduce(torch_config(arch)), **kw))


def _template(tc, state_dtype="float32") -> tts.TrainState:
    model = tlm.CausalLM(tc, device="meta")
    return tts.TrainState(params=model, opt=topt.init_opt_state(
        model, topt.OptimizerConfig(state_dtype=state_dtype)))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_same(got, want):
    a, b = dict(ckpt._flatten(got)), dict(ckpt._flatten(want))
    assert sorted(a) == sorted(b)
    for name, x in a.items():
        y = b[name]
        assert x.dtype == y.dtype and x.shape == y.shape and x.device == y.device, name
        assert torch.equal(_bits(x), _bits(y)), name


def _jax_run(tmp_path, steps=3):
    """The JAX Trainer of tests/test_train.py's tiny config, a synchronous
    checkpoint after ``steps`` steps."""
    jc, tc = _cfgs()
    tcfg = jts.TrainConfig(optimizer=jopt.OptimizerConfig(**OPT))
    data = JSyntheticLM(JDataConfig(jc.vocab_size, seq_len=16, global_batch=4, seed=2))
    tr = JTrainer(jc, tcfg, JTrainerConfig(total_steps=30, ckpt_every=steps,
                                           ckpt_dir=str(tmp_path), log_every=1,
                                           async_ckpt=False), data)
    tr.run(until=steps)
    return jc, tc, tcfg, tr


def test_jax_trainer_checkpoint_restores_bit_for_bit_and_steps_on(tmp_path):
    jc, tc, jtcfg, jtr = _jax_run(tmp_path)
    manifest = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert "name" not in manifest["leaves"][0]  # the reference's manifest names no leaf
    restored, step = ckpt.restore(str(tmp_path), _template(tc), device="cpu")
    assert step == 3
    want = tts.train_state_from_numpy(jax.tree.map(np.asarray, jtr.state), tc, "cpu")
    _assert_same(restored, want)
    assert int(restored.opt["step"]) == 3
    # the port's Trainer resumes from the JAX checkpoint; its next step's loss
    # is the JAX Trainer's next step's
    ttcfg = tts.TrainConfig(optimizer=topt.OptimizerConfig(**OPT))
    data = SyntheticLM(DataConfig(tc.vocab_size, seq_len=16, global_batch=4, seed=2))
    ttr = Trainer(tc, ttcfg, TrainerConfig(total_steps=30, ckpt_every=1000,
                                           ckpt_dir=str(tmp_path), log_every=1), data,
                  device="cpu")
    assert ttr.restore_or_init() == 3
    ttr.run(until=4)
    jtr.run(until=4)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(ttr.history[-1][key], jtr.history[-1][key], **LOSS_TOL)


@pytest.mark.parametrize("arch", ["granite_3_2b", "gemma2_27b", "recurrentgemma_9b",
                                  "qwen3_moe_235b_a22b", "llava_next_34b"])
def test_bf16_state_and_every_block_kind_restore(tmp_path, arch):
    """bf16 parameters and moments (``ml_dtypes`` leaves, which ``np.load``
    reads as a void type), a period of two kinds (gemma2), a tail
    (recurrentgemma), MoE leaves and a model without an embedding (llava)."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    if arch == "recurrentgemma_9b":
        over["n_layers"] = 5  # one period plus the tail
    jc, tc = _cfgs(arch, **over)
    jtcfg = jts.TrainConfig(optimizer=jopt.OptimizerConfig(state_dtype="bfloat16"))
    state = jts.init_train_state(jax.random.key(1), jc, jtcfg)
    rng = np.random.default_rng(1)
    tree = jax.tree.map(np.asarray, state)
    for key in ("m", "v"):  # nonzero moments, so a swap of m and v would show
        tree.opt[key] = jax.tree.map(
            lambda x: (rng.normal(size=x.shape) * 0.1).astype(x.dtype), tree.opt[key])
    tree.opt["step"] = np.int32(5)
    jckpt.save(str(tmp_path), 5, tree)
    restored, step = ckpt.restore(str(tmp_path), _template(tc, "bfloat16"), device="cpu")
    assert step == 5
    _assert_same(restored, tts.train_state_from_numpy(tree, tc, "cpu"))
    assert restored.params.final_norm.dtype == torch.bfloat16


def test_jax_params_restore_into_a_model(tmp_path):
    jc, tc = _cfgs()
    params = jlm.init_params(jax.random.key(3), jc)
    jckpt.save(str(tmp_path), 0, params)
    model, _ = ckpt.restore(str(tmp_path), tlm.CausalLM(tc, device="meta"), device="cpu")
    _assert_same(model, tlm.params_from_numpy(jax.tree.map(np.asarray, params), tc, "cpu"))


def test_a_manifest_the_port_cannot_map_raises(tmp_path):
    jc, tc, _, _ = _jax_run(tmp_path, steps=1)
    # the leaf count: a TrainState checkpoint into a model template
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), tlm.CausalLM(tc, device="meta"), device="cpu")
    # a shape: another d_ff
    wide = dataclasses.replace(tc, d_ff=tc.d_ff * 2)
    with pytest.raises(ValueError, match="expected"):
        ckpt.restore(str(tmp_path), _template(wide), device="cpu")
    # a dtype: the moments saved in float32, the template's in bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.restore(str(tmp_path), _template(tc, "bfloat16"), device="cpu")
    # a template that is not a model or a train state
    with pytest.raises(ValueError, match="CausalLM"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(2)}, device="cpu")
