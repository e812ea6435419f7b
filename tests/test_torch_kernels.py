"""The port's kernel modules against the JAX package's Pallas kernels.

The plain PyTorch versions (``repro_torch.kernels.ref``) are what the CUDA
kernels are held against on the card, so here they are held against the
Pallas kernels run in interpret mode, on the same seeded inputs: the copies
bit for bit in fp32, bf16 and int32, the heat scan within rtol = atol =
1e-6 (sums over duplicate ids may associate differently).  The dispatcher,
the loader and the copy-plan contract are checked too.  The CUDA kernels
themselves are held against the plain versions in ``test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.heat_scan import heat_scan_pallas  # noqa: E402
from repro.kernels.heat_scan import padded_heat_len as jax_padded_heat_len  # noqa: E402
from repro.kernels.leap_copy import copy_blocks_pallas, copy_runs_pallas  # noqa: E402
from repro_torch.kernels import _build, heat_scan, leap_copy, ops, ref  # noqa: E402

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
SHAPES = [(8, 8, 128), (5, 4, 64), (32, 1, 512)]  # (slots, rows, cols)
HEAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _np_pool(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if jnp.issubdtype(dtype, jnp.integer):
        return np.asarray(jnp.asarray(rng.integers(-100, 100, size=shape), dtype))
    return np.asarray(jnp.asarray(rng.normal(size=shape), dtype))


def _torch(arr: np.ndarray) -> torch.Tensor:
    """numpy (ml_dtypes bfloat16 included) -> CPU tensor of the same bits."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _bits(x) -> np.ndarray:
    """Raw bits of a JAX array or tensor, for bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def _disjoint_lanes(n_units, k, seed):
    perm = np.random.default_rng(seed).permutation(n_units)
    return perm[:k], perm[k : 2 * k]


# ---------------------------------------------------------------------------
# Plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_copy_blocks_ref_matches_pallas(shape, dtype):
    pool = _np_pool(shape, DTYPES[dtype], seed=1)
    src, dst = _disjoint_lanes(shape[0], min(3, shape[0] // 2), seed=2)
    want = copy_blocks_pallas(
        jnp.asarray(pool), jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
        interpret=True,
    )
    got = ref.copy_blocks_ref(_torch(pool), torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("run", [2, 4])
def test_copy_runs_ref_matches_pallas(dtype, run):
    shape = (32, 2, 128)
    pool = _np_pool(shape, DTYPES[dtype], seed=3)
    src, dst = _disjoint_lanes(shape[0] // run, 3, seed=4)
    src, dst = src * run, dst * run
    want = copy_runs_pallas(
        jnp.asarray(pool), jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
        run, interpret=True,
    )
    got = ref.copy_runs_ref(_torch(pool), torch.from_numpy(src), torch.from_numpy(dst), run)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("decay", [1.0, 0.9, 0.5])
def test_heat_scan_ref_matches_pallas(seed, decay):
    """Duplicate ids sum, ids >= L are inert, chained steps compose."""
    rng = np.random.default_rng(seed)
    n = 1000
    L = heat_scan.padded_heat_len(n)
    assert L == jax_padded_heat_len(n)
    heat = rng.gamma(1.0, 1.0, size=L).astype(np.float32)
    want = want_jnp = jnp.asarray(heat)
    got = torch.from_numpy(heat.copy())
    for _ in range(3):
        k = int(rng.integers(1, 200))
        ids = rng.integers(0, 64, size=k)  # few distinct ids: many duplicates
        ids[rng.random(k) < 0.2] = L + rng.integers(0, 5)  # inert lanes
        w = rng.uniform(0.25, 2.0, size=k).astype(np.float32)
        jids, jw = jnp.asarray(ids, jnp.int32), jnp.asarray(w)
        want = heat_scan_pallas(want, jids, jw, decay, interpret=True)
        want_jnp = jref.heat_scan_ref(want_jnp, jids, jw, decay)
        got = ref.heat_scan_ref(got, torch.from_numpy(ids), torch.from_numpy(w), decay)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HEAT_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jnp), **HEAT_TOL)


def test_padded_heat_len_matches_jax():
    for n in (0, 1, 7, 1024, 1025, 131072):
        assert heat_scan.padded_heat_len(n) == jax_padded_heat_len(n)


# csrc/heat_scan.cu's shared sample buffer (kBuf) and the samples it filters
# at a time (kThreads), as the plan below models them
SAMPLE_BUFFER, SAMPLE_CHUNK = 2048, 256


def test_scan_tiles_sizes_the_grid_from_the_plane():
    assert heat_scan.TILE_ENTRIES == 1024
    assert heat_scan.scan_tiles(131072) == 128  # the drains' plane: one wave of CTAs
    assert [heat_scan.scan_tiles(n) for n in (0, 1, 1024, 1025, 3000)] == [0, 1, 1, 2, 3]
    for n in (1, 1000, 131072):  # a padded plane is whole tiles
        assert heat_scan.padded_heat_len(n) == heat_scan.scan_tiles(n) * heat_scan.TILE_ENTRIES
    # a chunk always fits in the buffer once it has been folded in
    assert SAMPLE_BUFFER % SAMPLE_CHUNK == 0
    assert SAMPLE_BUFFER >= 2 * SAMPLE_CHUNK


def _binned_plan(heat, ids, w, decay):
    """The CUDA kernel's plan in float32 numpy: per tile of TILE_ENTRIES, the
    samples that hit it in sample order, buffered SAMPLE_CHUNK at a time and
    folded in when the next chunk might not fit; each entry sums its weights
    in that order from zero, then ``heat * decay + acc``.  Returns the plane
    and the number of folds before the last, over all tiles."""
    tile, buf, chunk = heat_scan.TILE_ENTRIES, SAMPLE_BUFFER, SAMPLE_CHUNK
    out = heat.copy()
    early_folds = 0
    for t in range(heat_scan.scan_tiles(len(heat))):
        lo = t * tile
        acc = np.zeros(min(tile, len(heat) - lo), np.float32)
        pending = []

        def fold():
            for off, x in pending:
                acc[off] = np.float32(acc[off] + x)
            pending.clear()

        for base in range(0, len(ids), chunk):
            if len(pending) > buf - chunk:
                fold()
                early_folds += 1
            part = zip(ids[base:base + chunk], w[base:base + chunk])
            pending += [(int(i) - lo, x) for i, x in part if 0 <= int(i) - lo < len(acc)]
        fold()
        out[lo:lo + len(acc)] = heat[lo:lo + len(acc)] * np.float32(decay) + acc
    return out, early_folds


@pytest.mark.parametrize(
    "where, k",
    [("uniform", 128), ("uniform", 1024), ("skewed", 1024), ("one_tile", 700),
     ("one_tile", 2600), ("inert", 300)],
)
def test_binned_plan_matches_pallas(where, k):
    """Uniform samples, samples skewed into two tiles, all in one tile, more
    in one tile than its buffer holds (folded in rounds), and ids >= L."""
    rng = np.random.default_rng(k)
    L = 4096
    heat = rng.gamma(1.0, 1.0, size=L).astype(np.float32)
    lo, hi = {"uniform": (0, L), "skewed": (0, 2048), "one_tile": (1024, 2048),
              "inert": (0, L)}[where]
    ids = rng.integers(lo, hi, size=k)
    if where == "inert":
        ids[rng.random(k) < 0.5] = L + rng.integers(0, 1000)
    w = rng.uniform(0.25, 2.0, size=k).astype(np.float32)
    got, early_folds = _binned_plan(heat, ids, w, 0.9)
    assert (early_folds > 0) == (where == "one_tile" and k > SAMPLE_BUFFER)
    want = heat_scan_pallas(jnp.asarray(heat), jnp.asarray(ids, jnp.int32), jnp.asarray(w),
                            0.9, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **HEAT_TOL)
    plain = ref.heat_scan_ref(torch.from_numpy(heat.copy()), torch.from_numpy(ids),
                              torch.from_numpy(w), 0.9)
    np.testing.assert_allclose(got, plain.numpy(), **HEAT_TOL)


# ---------------------------------------------------------------------------
# Dispatcher: CPU tensors take the plain version, "cuda" on the CPU raises
# ---------------------------------------------------------------------------


@pytest.fixture
def no_kernel_build(monkeypatch):
    """Any attempt to build or load the CUDA library fails the test."""

    def refuse():
        raise AssertionError("a CPU tensor must not reach the CUDA kernels")

    monkeypatch.setattr(_build, "load", refuse)


@pytest.mark.parametrize("impl", [None, "auto", "ref"])
def test_ops_sends_cpu_tensors_to_plain_versions(impl, no_kernel_build):
    pool = torch.arange(16 * 2 * 4, dtype=torch.float32).view(16, 2, 4)
    want = ref.copy_blocks_ref(pool.clone(), torch.tensor([0, 1]), torch.tensor([8, 9]))
    got = ops.copy_blocks_impl(pool.clone(), torch.tensor([0, 1]), torch.tensor([8, 9]), impl=impl)
    assert torch.equal(got, want)
    want = ref.copy_runs_ref(pool.clone(), torch.tensor([0]), torch.tensor([8]), 4)
    got = ops.copy_runs_impl(pool.clone(), torch.tensor([0]), torch.tensor([8]), run=4, impl=impl)
    assert torch.equal(got, want)
    heat = torch.ones(1024)
    ids, w = torch.tensor([3, 3, 2000]), torch.tensor([1.0, 2.0, 5.0])
    got = ops.heat_scan_impl(heat.clone(), ids, w, 0.5, impl=impl)
    assert torch.equal(got, ref.heat_scan_ref(heat.clone(), ids, w, 0.5))
    assert got[3] == 3.5 and got[0] == 0.5
    # the wrappers themselves take the plain version for a CPU tensor
    assert torch.equal(
        leap_copy.copy_blocks(pool.clone(), torch.tensor([0]), torch.tensor([8])),
        ref.copy_blocks_ref(pool.clone(), torch.tensor([0]), torch.tensor([8])),
    )
    assert torch.equal(heat_scan.heat_scan(heat.clone(), ids, w, 0.5), got)


def test_ops_empty_heat_batch_is_identity():
    heat = torch.arange(1024, dtype=torch.float32)
    out = ops.heat_scan_impl(heat, torch.zeros(0, dtype=torch.int64), torch.zeros(0), 0.5)
    assert torch.equal(out, torch.arange(1024, dtype=torch.float32))


def test_ops_cuda_impl_raises_on_cpu_tensors(no_kernel_build):
    pool = torch.zeros(8, 1, 4)
    idx = torch.tensor([0])
    with pytest.raises(ValueError, match="cuda"):
        ops.copy_blocks_impl(pool, idx, idx + 4, impl="cuda")
    with pytest.raises(ValueError, match="cuda"):
        ops.copy_runs_impl(pool, idx, idx + 4, run=4, impl="cuda")
    with pytest.raises(ValueError, match="cuda"):
        ops.heat_scan_impl(torch.zeros(1024), idx, torch.ones(1), 0.5, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.copy_blocks_impl(pool, idx, idx + 4, impl="pallas")


# ---------------------------------------------------------------------------
# Loader and host plan contract
# ---------------------------------------------------------------------------


def test_build_module_imports_and_names_library_by_source_hash():
    """Importing the loader builds nothing; the library name carries a hash
    of the sources, and the build directory is git-ignored."""
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert _build.source_hash() in path.name
    for name in _build.SOURCES:
        src = (_build.CSRC / name).read_text()
        assert "torch/extension.h" not in src
        assert "sm_90a" in src and "src/repro/kernels/" in src  # names its TPU kernel
    gitignore = (_build.CSRC.parents[3] / ".gitignore").read_text().splitlines()
    assert "src/repro_torch/kernels/build/" in gitignore


def test_find_nvcc_raises_without_a_toolkit(monkeypatch, tmp_path):
    if _build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this host has a CUDA toolkit at /usr/local/cuda")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_copy_plan_check_accepts_a_valid_plan():
    leap_copy.check_copy_plan([0, 1, 1], [4, 5, 6], n_slots=8)  # shared sources are fine
    leap_copy.check_copy_plan([0, 8], [16, 24], n_slots=32, run=8)
    leap_copy.check_copy_plan(np.zeros(0), np.zeros(0), n_slots=8)


@pytest.mark.parametrize(
    "src, dst, run, match",
    [
        ([0, 1], [4, 4], 1, "destination twice"),
        ([0, 1], [1, 5], 1, "also a source"),
        ([0], [8], 1, "outside"),
        ([-1], [3], 1, "outside"),
        ([0], [6], 4, "aligned"),
        ([0, 8], [8, 16], 8, "also a source"),
        ([0, 1], [4], 1, "equal 1-D"),
    ],
)
def test_copy_plan_check_fires(src, dst, run, match):
    n_slots = 8 if run < 8 else 32
    with pytest.raises(ValueError, match=match):
        leap_copy.check_copy_plan(src, dst, n_slots=n_slots, run=run)
