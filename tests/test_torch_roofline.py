"""The port's ``configs/shapes.py`` and ``roofline/{flops,model}.py``
against the JAX package's, on the CPU.

``input_specs`` and ``cache_specs`` give ``meta`` tensors of the shapes and
dtypes of the reference's ``ShapeDtypeStruct`` s, for every arch and shape;
the port's cache is a list of layers where the reference stacks a period's
repeats.  ``step_cost`` and its byte items equal the reference's within
relative 1e-12 for every arch, shape and chip count.  ``RooflineTerms``
is tested with the H100's constants the way ``tests/test_roofline.py``
tests it with the TPU's.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.roofline import flops as jflops  # noqa: E402
from repro.roofline import model as jroof  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.roofline import flops, model as roof  # noqa: E402

CHIPS = (256, 512)
REL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def reference_counts_parameters_once():
    """The reference counts a config's parameters by tracing its
    ``init_params`` (``jax.eval_shape``) at every call, several times a
    ``step_cost``; the count is a function of the frozen config alone, so
    this module keeps each count (the same number, traced once)."""
    count = JModelConfig.param_count
    JModelConfig.param_count = functools.lru_cache(maxsize=None)(count)
    yield
    JModelConfig.param_count = count


def _same(t: torch.Tensor, spec) -> None:
    assert t.device.type == "meta"
    assert tuple(t.shape) == tuple(spec.shape)
    assert str(t.dtype).removeprefix("torch.") == str(np.dtype(spec.dtype))


def test_shape_table_and_cell_status_match():
    assert shapes.SHAPES.keys() == jshapes.SHAPES.keys()
    for name, sp in shapes.SHAPES.items():
        assert dataclasses.asdict(sp) == dataclasses.asdict(jshapes.SHAPES[name])
    assert shapes.SKIP == jshapes.SKIP
    for arch in ARCH_IDS:
        for shape in shapes.SHAPES:
            assert (shapes.cell_status(get_config(arch), shape)
                    == jshapes.cell_status(jax_config(arch), shape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_match(arch):
    cfg, jc = get_config(arch), jax_config(arch)
    per = len(jc.layer_pattern)
    for shape in shapes.SHAPES:
        got, want = shapes.input_specs(cfg, shape), jshapes.input_specs(jc, shape)
        assert got.keys() == want.keys()
        for k in got:
            _same(got[k], want[k])
        cache, jcache = shapes.cache_specs(cfg, shape), jshapes.cache_specs(jc, shape)
        assert len(cache) == cfg.n_layers
        n_period = jc.repeats * per
        for li, layer in enumerate(cache):
            if li < n_period:
                stacked = jcache["period"][li % per]
                ref = {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype) for k, v in stacked.items()}
            else:
                ref = jcache["tail"][li - n_period]
            assert layer.keys() == ref.keys(), (arch, shape, li)
            for k in layer:
                _same(layer[k], ref[k])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_cost_equals_the_reference(arch):
    cfg, jc = get_config(arch), jax_config(arch)
    for shape in shapes.SHAPES:
        for n in CHIPS:
            got, want = flops.step_cost(cfg, shape, n), jflops.step_cost(jc, shape, n)
            for k in ("fwd_flops", "total_flops", "hbm_bytes"):
                np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=REL, atol=0)
            assert got.detail.keys() == want.detail.keys()
            for k in got.detail:
                np.testing.assert_allclose(got.detail[k], want.detail[k], rtol=REL, atol=0)
        for batch, seq in ((1, 1), (8, 4096), (128, 32768)):
            np.testing.assert_allclose(flops._cache_bytes(cfg, batch, seq),
                                       jflops._cache_bytes(jc, batch, seq), rtol=REL, atol=0)


def test_roofline_terms_and_dominance_on_the_h100():
    art = {
        "flops_per_device": roof.PEAK_FLOPS,  # exactly 1 s of compute
        "bytes_per_device": roof.HBM_BW * 2,  # 2 s of HBM
        "wire_bytes_per_device": roof.NVLINK_BW * 0.5,
        "model_flops": roof.PEAK_FLOPS * 4 * 0.5,
        "n_chips": 4,
    }
    t = roof.terms_from_artifact(art)
    assert t.dominant == "memory"
    assert abs(t.step_time_s - 2.0) < 1e-9
    assert abs(t.roofline_fraction - 0.25) < 1e-9
    assert abs(t.useful_flops_ratio - 0.5) < 1e-9
    # the H100 SXM's data sheet at 700 W, not the TPU's
    assert (roof.PEAK_FLOPS, roof.HBM_BW, roof.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert roof.PEAK_FLOPS != jroof.PEAK_FLOPS
    for kind in ("train", "decode"):
        assert roof.model_flops(7, 11, kind) == jroof.model_flops(7, 11, kind)
