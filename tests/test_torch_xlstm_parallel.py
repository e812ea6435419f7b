"""Tensor-parallel xLSTM on the CPU: the mLSTM and sLSTM blocks split by heads
over a data-parallel group's positions, held against the whole block.

Reduced xlstm_125m in f32, its mLSTM block (layer 0) and its sLSTM block
(layer 3), on the 8-position CPU ``DeviceMesh``: 4 x 2 for n = 2 and 2 x 4
for n = 4 tensor-parallel positions, under ``make_ctx``.  Two widths:
``d_model`` 64, whose sLSTM FFN (F = 85) the positions do not divide and
which runs whole on the lead, and ``d_model`` 96 (F = 128, split).  Each
case binds the block's regions as the placed executors bind them
(``lm._bound``, ``tensor_parallel.block_view``) and compares with the
block of the unplaced model within rtol/atol 1e-5:

* training: the output, with the input whole on the lead and as a
  ``common.Stream`` split by sequence, the input's gradient and every
  leaf's gradient (each position's blocks added into the whole leaf);
* a prefill of 12 tokens (the sequential mLSTM) and of 128 (the chunked
  one): the output and each position's piece of every state, then 4 decode
  steps from the positions' states;
* the plan: each position binds exactly its heads' regions, ``up``'s two
  branches among them, and 1/n of each split leaf; n = 3 and n = 8 (which
  do not divide the 4 heads) leave the cell whole on the lead;
* ``lm.init_group_caches``: an xLSTM state starts at the stabiliser's
  initial value, so a placed decode from it equals the whole model's from
  ``init_cache``.

The reference's own sharded programs and the JAX package are held against
the port's placed xLSTM in ``tests/test_torch_model_sharding.py``,
``tests/test_torch_placed_prefill.py`` and ``tests/test_torch_seq_parallel.py``.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import reduce  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_device_mesh  # noqa: E402
from repro_torch.models import lm, xlstm  # noqa: E402
from repro_torch.models import tensor_parallel as tp  # noqa: E402
from repro_torch.models.common import Stream, stream_tensors  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ROWS = 2  # a data-parallel group's rows
LAYERS = {"mlstm": 0, "slstm": 3}
WIDTHS = [64, 96]  # the sLSTM FFN whole (F = 85), split (F = 128)
NS = [2, 4]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(d_model: int):
    if d_model not in _MODELS:
        cfg = dataclasses.replace(reduce(get_config("xlstm_125m")), d_model=d_model)
        _MODELS[d_model] = cfg, lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return _MODELS[d_model]


def _placed(d_model: int, n: int, inference: bool = False):
    cfg, model = _model(d_model)
    mesh = make_device_mesh((8 // n, n), ("data", "model"), ["cpu"] * 8)
    ctx = sh.make_ctx(mesh)
    return cfg, model, ctx, sh.place(model, mesh, ctx, inference=inference)


def _inputs(cfg, s: int, seed: int = 1) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((ROWS, s, cfg.d_model), generator=gen)


def _close(got, want, what: str) -> None:
    got, want = got.detach().numpy(), want.detach().numpy()
    np.testing.assert_allclose(got, want, err_msg=f"{what}: max abs {np.abs(got - want).max():.3g}",
                               **TOL)


def _cell_names(placed, i: int) -> list[str]:
    return [n for n in placed.leaves if n.startswith(f"blocks.{i}.cell.")]


def _split_run(placed, ctx, i: int, s: int, fn, grad: bool = False):
    """``fn(split cell, bound)`` with block ``i``'s cell bound on group 0's
    positions as the executors bind it, under the plan at ``[B, s, D]``."""
    cfg = placed.cfg
    with sh.use_ctx(ctx):
        p = tp.plan(placed, ctx, (ROWS * len(sh.dp_leads(ctx)), s, cfg.d_model))
        grp = tp.group(placed, ctx, 0)
        skels = lm._skeletons(placed, p.n)
        with lm._bound(skels, placed, _cell_names(placed, i), p, grp, grad) as bound:
            return fn(tp.block_view(skels, i, p, grp).cell, bound), p


def _block(kind: str):
    return xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block


@pytest.mark.parametrize("seq", [False, True], ids=["whole", "stream"])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("d_model", WIDTHS)
@pytest.mark.parametrize("kind", list(LAYERS))
def test_split_train_matches_the_whole_block(kind, d_model, n, seq):
    cfg, model, ctx, placed = _placed(d_model, n)
    i, s = LAYERS[kind], 16
    x = _inputs(cfg, s)
    seed = _inputs(cfg, s, seed=2)
    whole = model.blocks[i].cell
    params = dict(whole.named_parameters())
    with torch.enable_grad():
        for p in params.values():
            p.requires_grad_(True)
        xw = x.clone().requires_grad_(True)
        want = _block(kind)(xw, whole, cfg, mode="train")
        want_grads = torch.autograd.grad(want, [xw, *params.values()], seed)
        for p in params.values():
            p.requires_grad_(False)

        def run(cell, bound):
            rows = x.clone().requires_grad_(True)
            xin = rows
            if seq:
                xin = Stream([r.clone().requires_grad_(True) for r in rows.chunk(n, dim=1)],
                             cell.group)
            out = _block(kind)(xin, cell, cfg, mode="train")
            assert isinstance(out, Stream) == seq
            seeds = list(seed.chunk(n, dim=1)) if seq else [seed]
            grads = torch.autograd.grad(stream_tensors(out), [*stream_tensors(xin),
                                        *(q for _, _, q in bound)], seeds,
                                        allow_unused=True, materialize_grads=True)
            k = len(stream_tensors(xin))
            dx = torch.cat(grads[:k], dim=1)
            out = torch.cat(stream_tensors(out), dim=1)
            full = {name: torch.zeros(placed.leaves[name].shape) for name in _cell_names(placed, i)}
            for (name, region, _), g in zip(bound, grads[k:]):
                for r, blk in tp.region_blocks(region, g):
                    full[name][r] += blk
            return out.detach(), dx, full

        (got, dx, full), _ = _split_run(placed, ctx, i, s, run, grad=True)
    _close(got, want, f"{kind} d {d_model} n {n} output")
    _close(dx, want_grads[0], "the input's gradient")
    for (leaf, _), g in zip(params.items(), want_grads[1:]):
        _close(full[f"blocks.{i}.cell.{leaf}"], g, f"gradient of {leaf}")


@pytest.mark.parametrize("s", [12, 128])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("d_model", WIDTHS)
@pytest.mark.parametrize("kind", list(LAYERS))
def test_split_prefill_and_decode_match_the_whole_block(kind, d_model, n, s):
    cfg, model, ctx, placed = _placed(d_model, n, inference=True)
    i = LAYERS[kind]
    x, steps = _inputs(cfg, s), [_inputs(cfg, 1, seed=10 + k) for k in range(4)]
    whole = model.blocks[i].cell
    want, first = _block(kind)(x, whole, cfg, mode="prefill")
    cache, want_steps = first, []
    for t in steps:
        y, cache = _block(kind)(t, whole, cfg, cache, mode="decode")
        want_steps.append((y, cache))

    def run(cell, _):
        out, pieces = _block(kind)(x, cell, cfg, mode="prefill")
        assert isinstance(pieces, list) and len(pieces) == n
        seen, c = [], pieces
        for t in steps:
            y, c = _block(kind)(t, cell, cfg, c, mode="decode")
            seen.append((y, c))
        return out, pieces, seen

    (out, pieces, seen), p = _split_run(placed, ctx, i, s, run)
    spans = p.layers[i]["cell"][1]
    _close(out, want, f"{kind} d {d_model} n {n} prefill of {s}")
    for t, piece in enumerate(pieces):
        assert sorted(piece) == sorted(first)
        for k, v in first.items():
            _close(piece[k], tp._piece(v, kind, k, spans[t]), f"position {t}'s {k}")
    for step, ((y, c), (wy, wc)) in enumerate(zip(seen, want_steps)):
        _close(y, wy, f"decode step {step}")
        for t, piece in enumerate(c):
            for k, v in wc.items():
                _close(piece[k], tp._piece(v, kind, k, spans[t]), f"step {step} position {t} {k}")


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("d_model", WIDTHS)
def test_each_position_binds_its_heads(d_model, n):
    """Every cell leaf of every block: position ``t``'s region is its heads'
    span of the leaf's cut dim (``up`` its span of each branch), its bytes
    1/n of the leaf; the sLSTM FFN's ``up`` and ``down`` split by hidden
    units where n divides F, else bind whole on the lead alone."""
    cfg, _, ctx, placed = _placed(d_model, n)
    with sh.use_ctx(ctx):
        p = tp.plan(placed, ctx, (8, 16, cfg.d_model))
    hd = {"mlstm": 2 * d_model // xlstm.N_HEADS, "slstm": d_model // xlstm.N_HEADS}
    f = int(d_model * 4 / 3)
    for i, kind in enumerate(cfg.layer_kinds):  # every block of both kinds
        assert "cell" in p.layers[i]
        for name in _cell_names(placed, i):
            leaf, shape = name.rsplit(".", 1)[1], placed.leaves[name].shape
            dim, what = tp._CUTS[kind][leaf]
            regions = p.regions[name]
            if what == "f" and f % n:
                assert regions == [sh.whole(shape)] + [None] * (n - 1), name
                continue
            size = {"h": 1, "c": hd[kind], "f": f // n}[what] * (xlstm.N_HEADS // n
                                                                 if what != "f" else 1)
            for t, region in enumerate(regions):
                pieces = region if isinstance(region, list) else [region]
                assert (leaf == "up") == isinstance(region, list), name
                half = shape[dim] // 2
                for b, r in enumerate(pieces):
                    want = list(sh.whole(shape))
                    start = b * half + t * size
                    want[dim] = slice(start, start + size)
                    assert r == tuple(want), (name, t)
                got = sum(math.prod(sh.region_shape(r)) for r in pieces)
                assert got * n == math.prod(shape), name


@pytest.mark.parametrize("shape,make", [((2, 3), sh.make_ctx), ((4, 2), sh.make_decode_2d_ctx)],
                         ids=["n3", "n8"])
def test_positions_that_do_not_divide_the_heads_leave_the_cell_whole(shape, make):
    cfg, model = _model(64)
    mesh = make_device_mesh(shape, ("data", "model"), ["cpu"] * math.prod(shape))
    ctx = make(mesh)
    placed = sh.place(model, mesh, ctx, inference=True)
    batch = 6 if make is sh.make_ctx else 8
    with sh.use_ctx(ctx):
        p = tp.plan(placed, ctx, (batch, 1, cfg.d_model))
        assert p.n == (3 if make is sh.make_ctx else 8)
        assert all("cell" not in layer for layer in p.layers)
        for i in LAYERS.values():
            for name in _cell_names(placed, i):
                assert p.regions[name] == [sh.whole(placed.leaves[name].shape)] + [None] * (
                    p.n - 1)
        caches = lm.init_group_caches(placed, batch, 16)
        assert all(isinstance(layer, dict) and layer["c"].device == mesh.devices[0]
                   for layer in caches[0])


@pytest.mark.parametrize("make", [sh.make_ctx, sh.make_decode_2d_ctx])
def test_decode_from_empty_group_caches_matches_the_whole_model(make):
    """``init_group_caches`` starts the xLSTM stabiliser ``m`` at
    ``xlstm._M0`` as ``init_cache`` does: 3 placed decode steps from it
    equal the whole model's from ``init_cache``."""
    cfg, model = _model(64)
    mesh = make_device_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    ctx = make(mesh)
    placed = sh.place(model, mesh, ctx, inference=True)
    gen = torch.Generator().manual_seed(4)
    toks = [torch.randint(0, cfg.vocab_size, (8, 1), generator=gen) for _ in range(3)]
    cache, want = model.init_cache(8, 16), []
    for pos, t in enumerate(toks):
        logits, cache = model.decode_step(cache, t, pos)
        want.append(logits)
    with sh.use_ctx(ctx):
        caches = lm.init_group_caches(placed, 8, 16)
        for pos, t in enumerate(toks):
            logits, caches = lm.decode_step(placed, caches, t, pos, cfg)
            _close(logits, want[pos], f"{make.__name__} step {pos}")
