"""Paged decode attention (K4): the port's plain version and ops wrapper
against the JAX package's Pallas kernel (interpret mode) and wrapper.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances are the JAX kernel tests' own: rtol = atol = 2e-5 in float32 and
2e-2 in bfloat16.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attn import paged_decode_pallas  # noqa: E402
from repro_torch.kernels import ops, paged_attn, ref  # noqa: E402

# (B, H, KVH, hd, BLK, MAXB): the JAX kernel tests' cases
CASES = [
    (2, 4, 2, 64, 8, 4),
    (1, 8, 1, 128, 16, 3),  # MQA
    (3, 6, 6, 64, 8, 2),  # MHA
    (2, 12, 4, 128, 8, 5),  # GQA g=3
]
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(b, h, kvh, hd, blk, maxb, seed=0, bf16=False):
    """Host arrays (q, kv_pool, tables, lens), the pool float32 or bf16."""
    rng = np.random.default_rng(seed)
    s = b * maxb + 4
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    kv = rng.normal(size=(s, 2, blk, kvh, hd)).astype(np.float32)
    if bf16:
        q, kv = q.astype(ml_dtypes.bfloat16), kv.astype(ml_dtypes.bfloat16)
    tables = rng.choice(s, size=(b, maxb), replace=False).astype(np.int32)
    lens = rng.integers(1, maxb * blk + 1, size=(b,)).astype(np.int32)
    return q, kv, tables, lens


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_version_matches_pallas_kernel(case, bf16):
    b, h, kvh, hd, blk, maxb = case
    q, kv, tables, lens = _inputs(*case, bf16=bf16)
    g = h // kvh
    out, m, l = paged_decode_pallas(
        jnp.asarray(q).reshape(b, kvh, g, hd), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(lens), interpret=True,
    )
    got = ref.paged_decode_ref(_torch(q), _torch(kv), _torch(tables), _torch(lens))
    assert got[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert got[1].dtype == got[2].dtype == torch.float32
    tol = BF16_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(_np(got[0]), np.asarray(out, np.float32).reshape(b, h, hd), **tol)
    np.testing.assert_allclose(_np(got[1]), np.asarray(m).reshape(b, h), **tol)
    np.testing.assert_allclose(_np(got[2]), np.asarray(l).reshape(b, h), **tol)


def test_softcap_matches_and_changes_the_result():
    case = (2, 4, 2, 64, 8, 4)
    b, h, kvh, hd, blk, maxb = case
    q, kv, tables, lens = _inputs(*case, seed=7)
    out, _, _ = paged_decode_pallas(
        jnp.asarray(q).reshape(b, kvh, h // kvh, hd), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(lens), softcap=20.0, interpret=True,
    )
    args = (_torch(q), _torch(kv), _torch(tables), _torch(lens))
    got, _, _ = ref.paged_decode_ref(*args, softcap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(out).reshape(b, h, hd), **F32_TOL)
    plain, _, _ = ref.paged_decode_ref(*args)
    assert not np.allclose(got.numpy(), plain.numpy())


def test_single_token_sequences_have_l_one():
    b, h, kvh, hd, blk, maxb = 2, 4, 2, 64, 8, 4
    q, kv, tables, _ = _inputs(b, h, kvh, hd, blk, maxb, seed=3)
    lens = np.ones(b, np.int32)
    want, _, _ = jref.paged_decode_ref(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
                                       jnp.asarray(lens))
    out, m, l = ref.paged_decode_ref(_torch(q), _torch(kv), _torch(tables), _torch(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_array_equal(l.numpy(), 1.0)
    # one token: the output is that token's V row, the query's group's head
    first = kv[tables[:, 0], 1, 0]  # [B, KVH, hd]
    np.testing.assert_allclose(out.numpy(), np.repeat(first, h // kvh, axis=1), **F32_TOL)


def test_wrapper_sanitizes_pad_entries_like_jax():
    b, h, kvh, hd, blk, maxb = 2, 4, 2, 64, 8, 4
    q, kv, tables, lens = _inputs(b, h, kvh, hd, blk, maxb, seed=5)
    n_valid = (lens + blk - 1) // blk
    for i in range(b):
        tables[i, n_valid[i]:] = 10**6  # out of range: must be set to slot 0 first
    want = jops.paged_decode(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(tables),
                             jnp.asarray(lens), kv_heads=kvh, impl="ref")
    for impl in (None, "ref"):
        got = ops.paged_decode(_torch(q), _torch(kv), _torch(tables), _torch(lens),
                               kv_heads=kvh, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    with pytest.raises(ValueError, match="cuda"):
        ops.paged_decode(_torch(q), _torch(kv), _torch(tables), _torch(lens), kv_heads=kvh,
                         impl="cuda")
    with pytest.raises(AssertionError):
        ops.paged_decode(_torch(q), _torch(kv), _torch(tables), _torch(lens), kv_heads=3)


def test_combine_partials_matches_jax_and_the_unsharded_result():
    b, h, kvh, hd, blk, maxb = 2, 8, 2, 64, 8, 6
    q, kv, tables, _ = _inputs(b, h, kvh, hd, blk, maxb, seed=9)
    lens = np.full(b, maxb * blk, np.int32)
    full, _, _ = ref.paged_decode_ref(_torch(q), _torch(kv), _torch(tables), _torch(lens))
    parts = [
        ref.paged_decode_ref(_torch(q), _torch(kv), _torch(tables[:, p * 3:(p + 1) * 3]),
                             torch.full((b,), 3 * blk, dtype=torch.int32))
        for p in range(2)
    ]
    outs, ms, ls = (torch.stack([p[i] for p in parts]) for i in range(3))
    got = ref.combine_partials(outs, ms, ls)
    want = jref.combine_partials(jnp.asarray(outs.numpy()), jnp.asarray(ms.numpy()),
                                 jnp.asarray(ls.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **F32_TOL)
    assert ops.combine_partials is ref.combine_partials


@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_strided_layer_view_equals_the_contiguous_copy(softcap):
    """One layer of a pool whose slots hold every layer, read in place."""
    n_layers, layer = 3, 1
    b, h, kvh, hd, blk, maxb = 3, 8, 2, 64, 4, 5
    rng = np.random.default_rng(11)
    s = b * maxb + 2
    pool = torch.from_numpy(rng.normal(size=(s, n_layers, 2, blk, kvh, hd)).astype(np.float32))
    view = pool[:, layer]
    assert not view.is_contiguous() and view.stride(0) == n_layers * 2 * blk * kvh * hd
    q = torch.from_numpy(rng.normal(size=(b, h, hd)).astype(np.float32))
    tables = torch.from_numpy(rng.choice(s, size=(b, maxb), replace=False).astype(np.int32))
    lens = torch.tensor([1, 7, maxb * blk], dtype=torch.int32)
    got = ops.paged_decode_partial(q, view, tables, lens, kv_heads=kvh, softcap=softcap)
    want = ops.paged_decode_partial(q, view.contiguous(), tables, lens, kv_heads=kvh,
                                    softcap=softcap)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    # the kernel wrapper's CPU path is the same plain version, in the kernel's layout
    out, m, l = paged_attn.paged_decode(q.reshape(b, kvh, h // kvh, hd), view, tables, lens,
                                        softcap=softcap)
    torch.testing.assert_close(out.reshape(b, h, hd), got[0], rtol=0, atol=0)
    torch.testing.assert_close(m.reshape(b, h), got[1], rtol=0, atol=0)
    assert paged_attn.paged_decode.launches == 0  # no card, no launch


# -- the CUDA kernel's split over the sequence, modelled with the plain version --

SPLIT = paged_attn.SPLIT_TOKENS
# (B, H, KVH, hd, BLK, MAXB) with tables longer than one split, and the lens
# each case takes: split boundaries, 1-token sequences and the full table
SPLIT_CASES = [
    ((6, 8, 2, 64, 16, 12), [1, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT, 12 * 16]),
    ((4, 4, 1, 128, 8, 20), [SPLIT + 1, 2 * SPLIT + 1, 1, 20 * 8]),  # MQA, hd 128
    ((3, 12, 4, 64, 16, 9), [3 * SPLIT, 1, 2 * SPLIT - 1]),  # GQA g = 3
]


def _live_splits(lens, maxb: int, blk: int) -> list[int]:
    """The splits of each sequence that do work, by the kernel's exit rule:
    ``ceil(min(len, MAXB * BLK) / SPLIT)``, at least 1; the rest exit at once."""
    cap = maxb * blk
    return [max(1, -(-min(int(n), cap) // SPLIT)) for n in lens]


def test_decode_splits_sizes_the_grid_from_the_table():
    assert SPLIT % 16 == 0  # a split holds whole pages of the models' 16 tokens
    assert paged_attn.decode_splits(64, 16) == 16  # granite serving: 1,024-token tables
    assert paged_attn.decode_splits(12, 16) == 3
    assert paged_attn.decode_splits(4, 8) == 1
    assert paged_attn.decode_splits(5, 13) == 2  # 65 tokens: a page may straddle two splits
    assert paged_attn.decode_splits(1, 1) == 1
    assert _live_splits([1, 63, 64, 65, 128, 1024, 5000], 64, 16) == [
        1, 1, 1, 2, 2, 16, 16]  # lens past the table are cut to MAXB * BLK
    assert _live_splits(torch.tensor([0, 576]), 64, 16) == [1, 9]


def _split_plan(q, kv, tables, lens, softcap=0.0):
    """What the kernel computes: each live split of SPLIT tokens through the
    plain version in fp32, then ``combine_partials`` over the live splits
    (empty splits skipped; a sequence of one split keeps its partials)."""
    b, h, hd = q.shape
    blk, maxb = kv.shape[2], tables.shape[1]
    pages = SPLIT // blk
    qf, kvf = q.float(), kv.float()
    live = _live_splits(lens, maxb, blk)
    outs, ms, ls = [], [], []
    for i in range(b):
        parts = []
        for j in range(live[i]):
            n = min(SPLIT, int(lens[i]) - j * SPLIT)
            parts.append(ref.paged_decode_ref(
                qf[i:i + 1], kvf, tables[i:i + 1, j * pages:(j + 1) * pages],
                torch.tensor([n], dtype=torch.int32), softcap=softcap))
        if len(parts) == 1:
            o, m, l = parts[0]
        else:
            po, pm, pl = (torch.stack([p[k] for p in parts]) for k in range(3))
            o = ref.combine_partials(po, pm, pl)
            m = pm.amax(dim=0)
            l = (pl * torch.exp(pm - m[None])).sum(dim=0)
        outs.append(o)
        ms.append(m)
        ls.append(l)
    return torch.cat(outs).to(q.dtype), torch.cat(ms), torch.cat(ls)


@pytest.mark.parametrize("case_lens", SPLIT_CASES + [(c, None) for c in CASES],
                         ids=lambda c: "x".join(map(str, c[0])))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_split_plan_matches_pallas_and_the_whole_sequence(case_lens, bf16, softcap):
    case, lens = case_lens
    b, h, kvh, hd, blk, maxb = case
    q, kv, tables, drawn = _inputs(*case, seed=b + maxb, bf16=bf16)
    lens = drawn if lens is None else np.asarray(lens, np.int32)
    assert SPLIT % blk == 0
    out, m, l = paged_decode_pallas(
        jnp.asarray(q).reshape(b, kvh, h // kvh, hd), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(lens), softcap=softcap, interpret=True,
    )
    args = (_torch(q), _torch(kv), _torch(tables), _torch(lens))
    got = _split_plan(*args, softcap=softcap)
    whole = ref.paged_decode_ref(*args, softcap=softcap)
    tol = BF16_TOL if bf16 else F32_TOL
    for x, y in zip(got, whole):
        np.testing.assert_allclose(_np(x), _np(y), **tol)
    np.testing.assert_allclose(_np(got[0]), np.asarray(out, np.float32).reshape(b, h, hd), **tol)
    np.testing.assert_allclose(_np(got[1]), np.asarray(m).reshape(b, h), **tol)
    np.testing.assert_allclose(_np(got[2]), np.asarray(l).reshape(b, h), **tol)
    ones = lens == 1
    np.testing.assert_array_equal(_np(got[2])[ones], 1.0)  # a 1-token sequence keeps l == 1
