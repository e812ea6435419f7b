"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``gpu`` and skips without a CUDA device.  The file
imports neither JAX nor the JAX package, so on a machine with a card and no
JAX it runs on its own (the suite's ``conftest.py`` imports JAX)::

    python -m pytest -q -p no:cacheprovider --noconftest -m gpu tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import heat_scan, leap_copy, ops, ref  # noqa: E402

HEAT_TOL = dict(rtol=1e-6, atol=1e-6)  # sums over duplicate ids may associate differently

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32, torch.uint8])
@pytest.mark.parametrize("shape", [(64, 1, 16384), (64, 3, 5)])  # 16-byte words, bytes
def test_copy_kernels_match_plain(cuda, dtype, shape):
    g = torch.Generator().manual_seed(0)
    pool = torch.randint(0, 100, shape, generator=g).to(dtype).to(cuda)
    perm = torch.randperm(shape[0], generator=g)
    src, dst = perm[:16].to(cuda), perm[16:32].to(cuda)
    want = ref.copy_blocks_ref(pool.clone(), src, dst)
    got = leap_copy.copy_blocks(pool.clone(), src, dst)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    runs = torch.randperm(shape[0] // 8, generator=g).to(cuda) * 8
    want = ref.copy_runs_ref(pool.clone(), runs[:3], runs[3:6], 8)
    got = leap_copy.copy_runs(pool.clone(), runs[:3], runs[3:6], 8)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_heat_scan_matches_plain_and_repeats_bit_for_bit(cuda):
    g = torch.Generator().manual_seed(1)
    L = heat_scan.padded_heat_len(5000)
    heat = torch.rand(L, generator=g).to(cuda)
    ids = torch.randint(0, 300, (2500,), generator=g)
    ids[::7] = L + 3
    ids, w = ids.to(cuda), torch.rand(2500, generator=g).to(cuda)
    want = ref.heat_scan_ref(heat.clone(), ids, w, 0.9)
    got = heat_scan.heat_scan(heat.clone(), ids, w, 0.9)
    again = heat_scan.heat_scan(heat.clone(), ids, w, 0.9)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **HEAT_TOL)
    assert torch.equal(got, again)  # no atomics: bit-identical run to run


def test_ops_launch_kernels_on_cuda_and_count_them(cuda):
    pool = torch.zeros(16, 1, 64, device=cuda)
    idx = torch.tensor([0, 1], device=cuda)
    before = leap_copy.copy_blocks.launches
    ops.copy_blocks_impl(pool, idx, idx + 8)
    ops.copy_blocks_impl(pool, idx, idx + 8, impl="cuda")
    ops.copy_blocks_impl(pool, idx, idx + 8, impl="ref")  # the plain version: not counted
    assert leap_copy.copy_blocks.launches == before + 2
    with pytest.raises(ValueError, match="int64"):
        leap_copy.copy_blocks(pool, idx.int(), idx.int() + 8)
