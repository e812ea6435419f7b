"""The port's checkpointing (``repro_torch.checkpoint.ckpt``) and the
trainer's restart, on the CPU.

Round trips are bit for bit, bf16 leaves included (they go to disk as raw
uint16 bits).  The restart test is the port's copy of the JAX package's
``test_checkpoint_restart_resumes_identically``: the restarted run's last
loss within 1e-5 of the uninterrupted run's, as there; on the CPU every op
repeats itself, so the two are also equal.
"""

import dataclasses
import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state  # noqa: E402
from repro_torch.train.train_step import TrainConfig, TrainState, init_train_state  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread, as in ``tests/test_torch_train.py``: beside other
    pytest workers the tiny model's threads wait on one another at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(**kw):
    cfg = reduce(get_config("granite_3_2b"))
    return dataclasses.replace(cfg, n_layers=2, vocab_size=64, **kw)


def _state(cfg, state_dtype="float32", seed=0) -> TrainState:
    tcfg = TrainConfig(optimizer=OptimizerConfig(state_dtype=state_dtype))
    state = init_train_state(torch.Generator().manual_seed(seed), cfg, tcfg, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for tree in (state.opt["m"], state.opt["v"]):  # nonzero moments
        for t in tree.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    state.opt["step"].fill_(7)
    return state


def _template(cfg, state_dtype="float32") -> TrainState:
    model = lm.CausalLM(cfg, device="meta")
    return TrainState(params=model, opt=init_opt_state(
        model, OptimizerConfig(state_dtype=state_dtype)))


def _leaves(state):
    return ckpt._flatten(state)


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device, name
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y), name


@pytest.mark.parametrize("asynchronous", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact(tmp_path, dtype, asynchronous):
    cfg = tiny_cfg(param_dtype=dtype, compute_dtype=dtype)
    state = _state(cfg, state_dtype=dtype)
    h = ckpt.save(str(tmp_path), 7, state, asynchronous=asynchronous)
    h.wait()
    assert ckpt.latest_step(str(tmp_path)) == 7
    with open(tmp_path / "step_7" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 7 and len(manifest["leaves"]) == len(_leaves(state))
    assert {m["dtype"] for m in manifest["leaves"]} == {dtype, "int32"}
    assert manifest["treedef"][-1] == "opt/step"
    restored, step = ckpt.restore(str(tmp_path), _template(cfg, dtype), device="cpu")
    assert step == 7
    _assert_same(restored, state)
    assert not any(p.requires_grad for p in restored.params.parameters())  # the template's


def test_async_save_copies_to_the_host_before_returning(tmp_path):
    cfg = tiny_cfg()
    state = _state(cfg)
    want = {n: t.clone() for n, t in _leaves(state)}
    h = ckpt.save(str(tmp_path), 1, state, asynchronous=True)
    with torch.no_grad():  # the next step's in-place update, while the writer runs
        for p in state.params.parameters():
            p.add_(1.0)
    h.wait()
    restored, _ = ckpt.restore(str(tmp_path), _template(cfg), device="cpu")
    for name, t in _leaves(restored):
        assert torch.equal(t, want[name]), name


@pytest.mark.parametrize("asynchronous", [False, True])
def test_latest_moves_only_after_a_complete_save(tmp_path, monkeypatch, asynchronous):
    cfg = tiny_cfg()
    ckpt.save(str(tmp_path), 1, _state(cfg, seed=1)).wait()
    real_save, calls = np.save, []

    def failing_save(path, arr):
        calls.append(path)
        if len(calls) == 3:
            raise OSError("disk full")
        real_save(path, arr)

    monkeypatch.setattr(ckpt.np, "save", failing_save)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(str(tmp_path), 2, _state(cfg, seed=2), asynchronous=asynchronous).wait()
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert not (tmp_path / "step_2").exists()
    restored, step = ckpt.restore(str(tmp_path), _template(cfg), device="cpu")
    assert step == 1
    _assert_same(restored, _state(cfg, seed=1))


def test_restore_checks_count_names_shapes_and_dtypes(tmp_path):
    cfg = tiny_cfg()
    ckpt.save(str(tmp_path), 3, _state(cfg))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), _template(dataclasses.replace(cfg, n_layers=3)), device="cpu")
    with pytest.raises(ValueError, match="expected"):
        ckpt.restore(str(tmp_path), _template(dataclasses.replace(cfg, vocab_size=65)),
                     device="cpu")
    with pytest.raises(ValueError, match="expected"):
        ckpt.restore(str(tmp_path), _template(cfg, "bfloat16"), device="cpu")
    renamed = _template(cfg)
    renamed.opt["moments"] = renamed.opt.pop("m")
    with pytest.raises(ValueError, match="wants"):
        ckpt.restore(str(tmp_path), renamed, device="cpu")
    assert ckpt.restore(str(tmp_path), _template(cfg), step=3, device="cpu")[1] == 3


def test_no_checkpoint(tmp_path):
    assert ckpt.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), _template(tiny_cfg()), device="cpu")


def test_trees_of_plain_tensors_round_trip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": [torch.ones(2, dtype=torch.bfloat16), torch.zeros(())]}
    ckpt.save(str(tmp_path), 0, tree)
    like = {"a": torch.empty((2, 3), dtype=torch.int32),
            "b": [torch.empty(2, dtype=torch.bfloat16), torch.empty(())]}
    got, step = ckpt.restore(str(tmp_path), like)
    assert step == 0 and torch.equal(got["a"], tree["a"])
    assert torch.equal(got["b"][0], tree["b"][0]) and torch.equal(got["b"][1], tree["b"][1])


def test_checkpoint_restart_resumes_identically(tmp_path):
    cfg = tiny_cfg()
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len=16, global_batch=4, seed=2))
    tcfg = TrainConfig(optimizer=OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=30))
    mk = lambda: Trainer(  # noqa: E731
        cfg, tcfg,
        TrainerConfig(total_steps=30, ckpt_every=10, ckpt_dir=str(tmp_path),
                      log_every=30, async_ckpt=False),
        data, device="cpu",
    )
    # uninterrupted run
    a = mk()
    a.run()
    ref_loss = a.history[-1]["loss"]

    # interrupted run: fail at step 15, restart from the step-10 checkpoint
    shutil.rmtree(tmp_path)
    os.makedirs(tmp_path)
    b = mk()
    with pytest.raises(RuntimeError, match="simulated node failure"):
        b.run(fail_at=15)
    c = mk()
    resumed_from = c.restore_or_init()
    assert resumed_from == 10
    assert all(p.requires_grad for p in c.state.params.parameters())
    c.run()
    assert abs(c.history[-1]["loss"] - ref_loss) < 1e-5
    assert c.history[-1]["loss"] == ref_loss  # the CPU path repeats itself bit for bit
    _assert_same(c.state, a.state)


def test_async_trainer_checkpoints_resume(tmp_path):
    cfg = tiny_cfg()
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len=8, global_batch=2))
    tcfg = TrainConfig(optimizer=OptimizerConfig(warmup_steps=1, total_steps=6))
    run_cfg = TrainerConfig(total_steps=6, ckpt_every=2, ckpt_dir=str(tmp_path), log_every=1)
    a = Trainer(cfg, tcfg, run_cfg, data, device="cpu")
    a.run(until=4)
    assert ckpt.latest_step(str(tmp_path)) == 4
    b = Trainer(cfg, tcfg, run_cfg, data, device="cpu")
    assert b.restore_or_init() == 4
    _assert_same(b.state, a.state)
    b.run()
    a.run()
    assert [m["loss"] for m in b.history] == [m["loss"] for m in a.history[4:]]
