"""The port's training slice against the JAX package, on the CPU.

Both packages start from one state: the JAX ``init_train_state`` tree
carried across with ``train_state_from_numpy``.  Batches are made with numpy
from a seed and handed to both.  Reduced configs compute in f32.

Tolerances:
- loss 1e-5 (rtol and atol): the frameworks sum matrix products and
  reductions in other orders;
- gradients, per leaf, within 1e-4 of the leaf's largest JAX gradient (the
  same reordering, through a backward pass), or of a thousandth of the
  model's largest gradient where a leaf's are all smaller (the mLSTM gate
  biases' gradients are sums that cancel to about 1e-7, and keep only
  their fp32 rounding noise);
- ``apply_updates`` 1e-6 on identical numpy grads (f32 elementwise math and
  one reduction, the global norm); bf16 m and v within one bf16 ulp, since
  an f32 difference in the last bit can round either way;
- the LRU-scan backward 1e-5 against ``jax.grad`` of the JAX oracle (an
  associative scan sums in another order), and bit for bit against the
  port's own plain autograd.
Whole ``train_step`` parameters are not compared after an Adam step: where
``|g|`` is near ``eps`` a last-bit gradient difference flips the update, so
the gradients and the optimizer are compared separately.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.smoke import reduce as jax_reduce  # noqa: E402
from repro.data.synthetic import DataConfig as JDataConfig  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs.base import PORTED_ARCH_IDS  # noqa: E402
from repro_torch.configs.base import get_config as torch_config  # noqa: E402
from repro_torch.configs.smoke import reduce as torch_reduce  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import lru_scan as lru_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_ULP = dict(rtol=2**-7, atol=1e-6)
# one period (plus the tail) of the stacks with periods longer than one
# layer: every kind of block, at half the compile time of two
SHORT = {"recurrentgemma_9b": dict(n_layers=5), "xlstm_125m": dict(n_layers=4)}
# every ported arch, plus recurrentgemma at lru_width 128, where the JAX
# rglru_scan takes its ops.lru_scan route instead of the associative scan
CASES = [(a, SHORT.get(a, {})) for a in PORTED_ARCH_IDS] + [
    ("recurrentgemma_9b", dict(SHORT["recurrentgemma_9b"], lru_width=128))]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Run the file's torch ops on one thread.  The reduced models' tensors
    gain nothing from intra-op threads, and beside other pytest workers those
    threads wait on one another at every op: the training loop below took
    minutes that way instead of seconds, and kept every core busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(case):
    arch, over = case
    return arch + "".join(f"-{k}{v}" for k, v in over.items())


def _cfgs(arch, **overrides):
    return (dataclasses.replace(jax_reduce(jax_config(arch)), **overrides),
            dataclasses.replace(torch_reduce(torch_config(arch)), **overrides))


@functools.lru_cache(maxsize=None)
def _jax_state(arch, seed, tcfg, overrides):
    jc, _ = _cfgs(arch, **dict(overrides))
    return jax.jit(lambda k: jts.init_train_state(k, jc, tcfg))(jax.random.key(seed))


def _pair(arch, seed=0, tcfg=None, **overrides):
    """Reduced configs, the JAX train state and the port's, from one tree
    (a fresh port state every call; the JAX state is shared, and immutable)."""
    jc, tc = _cfgs(arch, **overrides)
    jstate = _jax_state(arch, seed, tcfg or jts.TrainConfig(), tuple(sorted(overrides.items())))
    tree = jax.tree.map(np.asarray, jstate)
    return jc, tc, jstate, tree, tts.train_state_from_numpy(tree, tc, "cpu")


def _batch(vocab, b=2, s=16, seed=0, masked=True, embed_dim=None):
    """numpy tokens and labels; a few labels are -100 (masked).  With
    ``embed_dim`` (stub-frontend archs) the inputs are embeddings [b, s, D]."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    if masked:
        labels[0, :3] = -100
    inputs = rng.integers(0, vocab, (b, s)).astype(np.int32)
    if embed_dim is not None:
        inputs = rng.normal(size=(b, s, embed_dim)).astype(np.float32)
    return {"inputs": inputs, "labels": labels}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_grads(tgrads: dict, jgrads_tree, tc, rel=GRAD_REL):
    jg = tlm.named_leaves(jax.tree.map(np.asarray, jgrads_tree), tc)
    assert sorted(jg) == sorted(tgrads)
    floor = 1e-3 * max(float(np.abs(np.asarray(g, np.float32)).max()) for g in jg.values())
    for name, g in tgrads.items():
        want = np.asarray(jg[name], np.float32)
        got = g.detach().float().numpy()
        scale = max(float(np.abs(want).max()), floor)
        err = float(np.abs(got - want).max())
        assert err <= rel * scale, f"{name}: max err {err:.3g}, scale {scale:.3g}"


# -- the optimizer ----------------------------------------------------------------


def test_lr_schedule():
    oc = topt.OptimizerConfig(peak_lr=1.0, warmup_steps=10, total_steps=110, end_lr_frac=0.1)
    assert float(topt.lr_at(oc, torch.tensor(0))) == 0.0
    assert abs(float(topt.lr_at(oc, torch.tensor(10))) - 1.0) < 1e-6
    mid = float(topt.lr_at(oc, torch.tensor(60)))
    assert 0.4 < mid < 0.7
    assert abs(float(topt.lr_at(oc, torch.tensor(110))) - 0.1) < 1e-6


@pytest.mark.parametrize("warmup", [0, 1, 10])
def test_lr_schedule_matches_jax(warmup):
    kw = dict(peak_lr=3e-3, warmup_steps=warmup, total_steps=120, end_lr_frac=0.1)
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jopt.lr_at(jopt.OptimizerConfig(**kw), s))(steps))
    got = topt.lr_at(topt.OptimizerConfig(**kw), torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_adamw_moves_toward_gradient():
    oc = topt.OptimizerConfig(peak_lr=0.1, warmup_steps=0, total_steps=10, weight_decay=0.0)
    params = {"w_in": torch.ones((4, 4))}
    opt = topt.init_opt_state(params, oc)
    grads = {"w_in": torch.ones((4, 4))}
    new, opt, m = topt.apply_updates(params, grads, opt, oc)
    assert float(new["w_in"].mean()) < 1.0
    assert int(opt["step"]) == 1 and opt["step"].dtype == torch.int32
    assert m["grad_norm"] > 0


def test_grad_clip_limits_update():
    oc = topt.OptimizerConfig(peak_lr=0.1, warmup_steps=0, clip_norm=1e-3, weight_decay=0.0)
    params = {"w_in": torch.ones((2, 2))}
    opt = topt.init_opt_state(params, oc)
    g = {"w_in": torch.full((2, 2), 1e6)}
    new, *_ = topt.apply_updates(params, g, opt, oc)
    # clipped: update magnitude ~ lr * normalized grad
    assert float((new["w_in"] - 1.0).abs().max()) < 0.2


@pytest.mark.parametrize("arch", PORTED_ARCH_IDS)
def test_decay_mask_matches_jax(arch):
    jc, tc = _cfgs(arch)
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0), jc))
    jax_mask = {jax.tree_util.keystr(path): jopt._decay_mask(path)
                for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    want = {k.rsplit("'", 2)[-2] for k, keep in jax_mask.items() if not keep}
    model = tlm.CausalLM(tc, device="meta")
    got = {n.rsplit(".", 1)[-1] for n, _ in model.named_parameters() if not topt._decay_mask(n)}
    assert got == want
    assert {n.rsplit(".", 1)[-1] for n, _ in model.named_parameters()
            if topt._decay_mask(n)} == {k.rsplit("'", 2)[-2] for k, keep in jax_mask.items()
                                        if keep}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(state_dtype, monkeypatch):
    oc = dict(peak_lr=1e-2, warmup_steps=2, total_steps=20, state_dtype=state_dtype)
    jtcfg = jts.TrainConfig(optimizer=jopt.OptimizerConfig(**oc))
    jc, tc, jstate, tree, _ = _pair("recurrentgemma_9b", tcfg=jtcfg, **SHORT["recurrentgemma_9b"])
    rng = np.random.default_rng(7)
    normal = lambda x, s=0.05: (rng.normal(size=x.shape) * s).astype(x.dtype)  # noqa: E731
    grads = jax.tree.map(normal, tree.params)
    tree.opt["m"] = jax.tree.map(normal, tree.opt["m"])
    tree.opt["v"] = jax.tree.map(lambda x: np.abs(normal(x, 5e-4)), tree.opt["v"])
    tree.opt["step"] = np.int32(3)
    tstate = tts.train_state_from_numpy(tree, tc, "cpu")
    # slices smaller than the largest leaf, so the sliced update is on the path
    monkeypatch.setattr(topt, "_SLICE", 1000)
    jp, jo, jm = jax.jit(lambda p, g, o: jopt.apply_updates(p, g, o, jtcfg.optimizer))(
        tree.params, grads, tree.opt)
    tgrads = {n: torch.from_numpy(np.array(a)) for n, a in tlm.named_leaves(grads, tc).items()}
    _, to, tm = topt.apply_updates(tstate.params, tgrads, tstate.opt,
                                   topt.OptimizerConfig(**oc))
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **OPT_TOL)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7, atol=0)
    assert int(to["step"]) == int(jo["step"]) == 4
    want = {"params": jp, "m": jo["m"], "v": jo["v"]}
    got = {"params": dict(tstate.params.named_parameters()), "m": to["m"], "v": to["v"]}
    for key in want:
        leaves = tlm.named_leaves(jax.tree.map(np.asarray, want[key]), tc)
        tol = BF16_ULP if key != "params" and state_dtype == "bfloat16" else OPT_TOL
        for name, t in got[key].items():
            assert t.dtype == getattr(torch, state_dtype if key != "params" else "float32")
            np.testing.assert_allclose(t.detach().float().numpy(),
                                       np.asarray(leaves[name], np.float32), **tol,
                                       err_msg=f"{key} {name}")


def test_chunked_update_is_a_no_op():
    oc = topt.OptimizerConfig(warmup_steps=0, total_steps=10)
    runs = []
    for chunked in (False, True):
        params = {"w_in": torch.linspace(-1, 1, 64).reshape(8, 8)}
        opt = topt.init_opt_state(params, oc)
        g = {"w_in": torch.linspace(2, -2, 64).reshape(8, 8)}
        topt.apply_updates(params, g, opt, dataclasses.replace(oc, chunked_update=chunked))
        runs.append(params["w_in"])
    assert torch.equal(*runs)


# -- K5's backward ------------------------------------------------------------------


def _scan_case(b, t, r, seed):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-(rng.normal(size=(b, t, r)) + 2.0)))).astype(np.float32)
    x = rng.normal(size=(b, t, r)).astype(np.float32)
    h0 = rng.normal(size=(b, r)).astype(np.float32)
    w = rng.normal(size=(b, t, r)).astype(np.float32)
    return a, x, h0, w


# (2, 300, 64): the backward kernel's plan takes 128 rows a stage there, so
# its first stage is a ragged one of 44 rows
@pytest.mark.parametrize("shape", [(2, 1, 8), (3, 17, 96), (2, 64, 128), (2, 300, 64)])
def test_lru_scan_backward_matches_jax_grad(shape):
    a, x, h0, w = _scan_case(*shape, seed=sum(shape))
    jgrads = jax.jit(jax.grad(lambda a, x, h0: jnp.sum(jref.lru_scan_ref(a, x, h0) * w),
                              argnums=(0, 1, 2)))(a, x, h0)
    ta, tx_, th = (torch.from_numpy(v) for v in (a, x, h0))
    h = ref.lru_scan_ref(ta, tx_, th)
    plain = ref.lru_scan_bwd_ref(torch.from_numpy(w), ta, h, th)
    leaves = [torch.from_numpy(v).requires_grad_() for v in (a, x, h0)]
    before = (lru_mod.lru_scan.launches, lru_mod.lru_scan_bwd.launches)
    fn = torch.autograd.grad((ops.lru_scan(*leaves) * torch.from_numpy(w)).sum(), leaves)
    assert (lru_mod.lru_scan.launches, lru_mod.lru_scan_bwd.launches) == before  # CPU: plain
    oracle = torch.autograd.grad((ops.lru_scan(*leaves, impl="ref")
                                  * torch.from_numpy(w)).sum(), leaves)
    for p, f, o, j in zip(plain, fn, oracle, jgrads):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
        assert torch.equal(p, f) and torch.equal(f, o)


def test_lru_scan_backward_keeps_dtypes():
    a, x, h0, w = (torch.from_numpy(v) for v in _scan_case(2, 5, 16, seed=1))
    a16, x16 = a.bfloat16().requires_grad_(), x.bfloat16().requires_grad_()
    h16 = h0.bfloat16().requires_grad_()
    da, db, dh0 = torch.autograd.grad((ops.lru_scan(a16, x16, h16).float() * w).sum(),
                                      (a16, x16, h16))
    assert da.dtype == db.dtype == dh0.dtype == torch.bfloat16
    want = ref.lru_scan_bwd_ref(w.bfloat16(), a16.detach(),
                                ref.lru_scan_ref(a16.detach(), x16.detach(), h16.detach()),
                                h16.detach())
    assert torch.equal(da, want[0]) and torch.equal(db, want[1])


# -- the training step ------------------------------------------------------------------


def test_grad_accum_matches_full_batch():
    cfg = dataclasses.replace(torch_reduce(torch_config("granite_3_2b")), n_layers=2,
                              vocab_size=64)
    state = tts.init_train_state(torch.Generator().manual_seed(0), cfg, tts.TrainConfig(), "cpu")
    batch = _torch(_batch(64, b=8, masked=False))
    g1, l1 = tts.grad_accum(state.params, batch, cfg, tts.TrainConfig(n_micro=1))
    g4, l4 = tts.grad_accum(state.params, batch, cfg, tts.TrainConfig(n_micro=4))
    assert abs(float(l1) - float(l4)) < 2e-5
    assert max(float((g1[n].float() - g4[n]).abs().max()) for n in g1) < 3e-5
    assert all(g.dtype == torch.float32 for g in g4.values())


@pytest.mark.parametrize("arch", ["granite_3_2b", "recurrentgemma_9b", "qwen3_moe_235b_a22b"])
def test_train_step_matches_jax(arch):
    """Two microbatches: the accumulated gradients and the loss against
    JAX's ``grad_accum``; then a whole step's metrics."""
    oc = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jtcfg = jts.TrainConfig(n_micro=2, optimizer=jopt.OptimizerConfig(**oc))
    ttcfg = tts.TrainConfig(n_micro=2, optimizer=topt.OptimizerConfig(**oc))
    jc, tc, jstate, _, tstate = _pair(arch, tcfg=jtcfg, **SHORT.get(arch, {}))
    batch = _batch(jc.vocab_size, b=4, seed=11)
    jgrads, jloss = jax.jit(lambda p, b: jts.grad_accum(p, b, jc, jtcfg))(
        jstate.params, _jax(batch))
    tgrads, tloss = tts.grad_accum(tstate.params, _torch(batch), tc, ttcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    _assert_grads(tgrads, jgrads, tc)
    # the whole step's metrics: JAX's train_step reports exactly these
    jm = {"loss": jloss, "grad_norm": jopt.global_norm(jgrads),
          "lr": jopt.lr_at(jtcfg.optimizer, jnp.asarray(1))}
    _, tm = tts.train_step(tstate, _torch(batch), tc, ttcfg)
    assert sorted(tm) == ["grad_norm", "loss", "lr"]
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **LOSS_TOL)
    assert int(tstate.opt["step"]) == 1


def test_train_state_from_numpy_carries_every_leaf():
    jc, tc, jstate, tree, tstate = _pair("qwen3_moe_235b_a22b")
    names = [n for n, _ in tstate.params.named_parameters()]
    assert list(tstate.opt["m"]) == list(tstate.opt["v"]) == names
    for name, p in tstate.params.named_parameters():
        assert p.requires_grad
        assert tstate.opt["m"][name].shape == p.shape
    leaves = tlm.named_leaves(tree.params, tc)
    for name, p in tstate.params.named_parameters():
        assert np.array_equal(p.detach().numpy(), leaves[name]), name
    assert int(tstate.opt["step"]) == 0 and tstate.opt["step"].dtype == torch.int32


# -- data, the trainer and the launcher -------------------------------------------------------


@pytest.mark.parametrize("embed_dim", [None, 16])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_are_bit_identical_to_jax(embed_dim, seed):
    kw = dict(vocab_size=97, seq_len=24, global_batch=8, seed=seed, embed_dim=embed_dim)
    jdata, tdata = JSyntheticLM(JDataConfig(**kw)), SyntheticLM(DataConfig(**kw))
    for step in (0, 1, 17):
        jb, tb = jdata.batch(step), tdata.batch(step)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])


def test_loss_decreases_end_to_end(tmp_path):
    cfg = dataclasses.replace(torch_reduce(torch_config("granite_3_2b")), n_layers=2,
                              vocab_size=64)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len=32, global_batch=8, seed=1))
    tcfg = tts.TrainConfig(
        n_micro=2,
        optimizer=topt.OptimizerConfig(peak_lr=3e-3, warmup_steps=5, total_steps=60),
    )
    tr = Trainer(cfg, tcfg, TrainerConfig(total_steps=60, ckpt_every=1000,
                                          ckpt_dir=str(tmp_path), log_every=5), data,
                 device="cpu")
    hist = tr.run()
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert last < first - 0.3, f"no learning: {first} -> {last}"


def test_trainer_defaults_to_the_card():
    cfg = torch_reduce(torch_config("granite_3_2b"))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 8, 2))
    if torch.cuda.is_available():
        assert Trainer(cfg, tts.TrainConfig(), TrainerConfig(), data).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg, tts.TrainConfig(), TrainerConfig(), data)


def test_launch_train_smoke_runs_on_the_cpu_and_resumes(tmp_path):
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite_3_2b",
            "--smoke", "--device", "cpu", "--batch", "4", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    first = subprocess.run(args + ["--steps", "4"], capture_output=True, text=True,
                           env=env, timeout=300)
    assert first.returncode == 0, first.stderr
    lines = [ln for ln in first.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 4 and all(np.isfinite(float(ln.split()[3])) for ln in lines)
    assert "to step 4 on cpu" in first.stdout
    again = subprocess.run(args + ["--steps", "6"], capture_output=True, text=True,
                           env=env, timeout=300)
    assert again.returncode == 0, again.stderr
    assert "resumed from step 4" in again.stdout and "to step 6 on cpu" in again.stdout
