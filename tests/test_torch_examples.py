"""The port's examples against the JAX package's, on the CPU.

Each ``examples/*_torch.py`` is a line-for-line counterpart of its JAX
example; its ``run(device="cpu")`` returns what it prints and asserts.  The
JAX example runs as it is (``main()``), with its calls observed from here.
Both sides harvest verdicts with ``poll(block=True)`` after every tick
(ROADMAP R2), and both packages' program caches start empty.

* ``quickstart``: placement, the final read and ``MigrationStats`` (misses
  included) equal.
* ``serve_paged``: the tokens of both runs equal, the port's model carrying
  the JAX example's ``init_params(jax.random.key(0), cfg)`` weights.
* ``tpch_morsels``: Q1 against ``tpch.q1_reference`` at the example's rtol
  1e-3 and against the JAX run's Q1 at rtol 2e-5 (both sum fp32, in
  different orders).
* ``train_e2e``: three steps at the ``15m`` preset from the JAX example's
  initial state, every step's loss within the trainer tests' f32 tolerance.
"""

import dataclasses
import importlib.util
import inspect
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api.session as jsession  # noqa: E402
import repro_torch.api.session as tsession  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

from test_torch_driver import REPO, clear_program_caches  # noqa: E402

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_train.py's
EXAMPLES = ("quickstart", "serve_paged", "tpch_morsels", "train_e2e")


def example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    path = REPO / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def blocking(monkeypatch):
    """Every session of either package harvests with ``poll(block=True)``
    after its tick; the program caches start empty."""
    for mod in (jsession, tsession):
        tick = mod.LeapSession.tick

        def blocking_tick(self, _tick=tick):
            _tick(self)
            self.poll(block=True)

        monkeypatch.setattr(mod.LeapSession, "tick", blocking_tick)
    clear_program_caches()


def recording(cls, calls: list):
    """A subclass of ``cls`` that keeps every instance in ``calls``."""

    class Recorded(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            calls.append(self)

    return Recorded


def test_quickstart_matches_jax(blocking, monkeypatch):
    jex, tex = example("quickstart"), example("quickstart_torch")
    sessions = []
    monkeypatch.setattr(jex, "LeapSession", recording(jex.LeapSession, sessions))
    jex.main()
    want = sessions[0].driver
    clear_program_caches()
    got = tex.run(device="cpu")
    np.testing.assert_array_equal(got["placement"], sessions[0].facade.placement())
    np.testing.assert_array_equal(got["read"], np.asarray(want.read(jnp.arange(64))))
    assert dataclasses.asdict(got["stats"]) == dataclasses.asdict(want.stats)
    assert got["ticks"] == want.stats.ticks and got["stats"].dirty_rejections > 0


def test_serve_paged_matches_jax(blocking, monkeypatch):
    jex, tex = example("serve_paged"), example("serve_paged_torch")
    engines = []
    outs = {}

    class Engine(jengine.PagedEngine):
        def decode(self, sids, *a, **kw):
            out = super().decode(sids, *a, **kw)
            outs.setdefault(id(self), []).append(tuple(out))
            return out

    monkeypatch.setattr(jex, "PagedEngine", recording(Engine, engines))
    jex.main()
    base, live = (outs[id(e)] for e in engines)
    assert base == live and len(base) == 16
    cfg = dataclasses.replace(tex.reduce(tex.get_config("qwen2_7b")), n_layers=2)
    jcfg = dataclasses.replace(jex.reduce(jex.get_config("qwen2_7b")), n_layers=2)
    params = jlm.init_params(jax.random.key(0), jcfg)  # the JAX example's weights
    model = tlm.params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    got = tex.run(device="cpu", params=model)
    assert got["base"] == got["live"] == base
    assert got["progress"].committed + got["progress"].forced == got["progress"].requested


def test_tpch_morsels_matches_jax(blocking, monkeypatch):
    jex, tex = example("tpch_morsels"), example("tpch_morsels_torch")
    results = []
    run_query = jex.tpch.run_query

    def recorded(store, which, param, *a, **kw):
        out = run_query(store, which, param, *a, **kw)
        results.append((which, np.asarray(out, np.float64)))
        return out

    monkeypatch.setattr(jex.tpch, "run_query", recorded)
    jex.main()
    want = results[-1]
    assert want[0] == "q1"
    got = tex.run(device="cpu")
    np.testing.assert_allclose(got["q1"], got["q1_reference"], rtol=1e-3)
    # fp32 sums over 131,072 rows, reduced in different orders: 1.1e-5 apart
    np.testing.assert_allclose(got["q1"], want[1], rtol=2e-5)
    assert (got["placement"] == 1).all()
    assert got["stats"].blocks_migrated + got["stats"].blocks_forced == 128


def test_train_e2e_matches_jax(monkeypatch, tmp_path):
    """Three steps from one state: every step logged on both sides."""
    jex, tex = example("train_e2e"), example("train_e2e_torch")
    for mod, cls in ((jex, jtrainer.TrainerConfig), (tex, ttrainer.TrainerConfig)):
        monkeypatch.setattr(mod, "TrainerConfig",
                            lambda cls=cls, **kw: cls(**{**kw, "log_every": 1}))
    states, hists = [], []
    restore, run = jtrainer.Trainer.restore_or_init, jtrainer.Trainer.run

    def keep_state(self):
        step = restore(self)
        states.append(jax.tree.map(np.asarray, self.state))
        return step

    def keep_hist(self, *a, **kw):
        hists.append(run(self, *a, **kw))
        return hists[-1]

    monkeypatch.setattr(jtrainer.Trainer, "restore_or_init", keep_state)
    monkeypatch.setattr(jtrainer.Trainer, "run", keep_hist)
    monkeypatch.setattr(sys, "argv", ["train_e2e.py", "--steps", "3",
                                      "--ckpt-dir", str(tmp_path / "jax")])
    jex.main()
    cfg, _, _ = tex.make_cfg("15m")
    state = tts.train_state_from_numpy(states[0], cfg, "cpu")
    got = tex.run(steps=3, ckpt_dir=str(tmp_path / "torch"), device="cpu", state=state)
    want = hists[-1]
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2, 3]
    for g, w in zip(got, want):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], **LOSS_TOL, err_msg=f"{key} {g['step']}")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_neither_jax_nor_the_reference(name):
    """Each torch example imports no ``jax`` and no ``repro`` module."""
    code = (f"import sys, runpy; sys.argv = ['x', '--help']\n"
            f"try:\n    runpy.run_path({str(REPO / 'examples' / f'{name}_torch.py')!r}, "
            f"run_name='__main__')\nexcept SystemExit:\n    pass\n"
            f"bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            f" or m == 'repro']\nassert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name):
    """Without ``--device`` an example runs on the card: here it raises."""
    mod = example(f"{name}_torch")
    assert inspect.signature(mod.run).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.card_or_cpu("cuda")
