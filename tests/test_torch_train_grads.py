"""The port's training forward and its gradients against the JAX package,
on the CPU: ``train_loss`` and ``jax.value_and_grad`` per block kind, the
block recompute, and gradients through K5's backward into the RG-LRU gates.

Setup and tolerances are ``tests/test_torch_train.py``'s (loss 1e-5;
gradients per leaf within 1e-4 of the leaf's largest, or of a thousandth
of the model's largest gradient where a leaf's are all smaller).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from test_torch_train import (  # noqa: E402
    CASES, LOSS_TOL, SHORT, _assert_grads, _batch, _cfgs, _ids, _jax, _pair, _torch,
    one_intra_op_thread,
)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_train_loss_and_grads_match_jax(case):
    arch, over = case
    jc, tc, jstate, _, tstate = _pair(arch, **over)
    batch = _batch(jc.vocab_size, embed_dim=None if jc.embed_inputs else jc.d_model)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.train_loss(p, b, jc), has_aux=True))(jstate.params, _jax(batch))
    model = tstate.params
    tloss, tmetrics = model.train_loss(_torch(batch))
    names, params = zip(*model.named_parameters())
    tgrads = torch.autograd.grad(tloss, params)
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    assert float(tmetrics["tokens"]) == float(jmetrics["tokens"]) == 2 * 16 - 3
    _assert_grads(dict(zip(names, tgrads)), jgrads, tc)


def test_xlstm_train_loss_matches_jax_on_the_chunked_cell():
    """128 tokens: both packages take the chunkwise-parallel mLSTM."""
    jc, tc, jstate, _, tstate = _pair("xlstm_125m", **SHORT["xlstm_125m"])
    batch = _batch(jc.vocab_size, b=1, s=2 * tx._CHUNK, seed=3)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.train_loss(p, b, jc)[0]))(jstate.params, _jax(batch))
    names, params = zip(*tstate.params.named_parameters())
    tloss = tstate.params.train_loss(_torch(batch))[0]
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    _assert_grads(dict(zip(names, torch.autograd.grad(tloss, params))), jgrads, tc)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "qwen3_moe_235b_a22b", "xlstm_125m"])
def test_block_recompute_changes_no_gradient_bit(arch):
    """train_loss recomputes every block in the backward; the same blocks run
    straight through give the same gradients, bit for bit."""
    _, tc, _, _, tstate = _pair(arch, **SHORT.get(arch, {}))
    model = tstate.params
    batch = _torch(_batch(tc.vocab_size, seed=5))
    names, params = zip(*model.named_parameters())
    remat = torch.autograd.grad(model.train_loss(batch)[0], params)

    x, aux = model.embed_tokens(batch["inputs"]), 0.0
    for blk in model.blocks:
        x, a = tblocks.block_train(x, blk, tc, blk.kind)
        aux = aux + a
    logits, labels = model.lm_logits(x), batch["labels"].long()
    mask = (labels >= 0).float()
    nll = (torch.logsumexp(logits, -1)
           - torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]) * mask
    loss = nll.sum() / mask.sum().clamp(min=1.0)
    if tc.moe is not None:
        loss = loss + tc.moe.aux_loss_weight * aux / tc.n_layers
    straight = torch.autograd.grad(loss, params)
    for name, a, b in zip(names, remat, straight):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_train_mode_is_the_prefill_output(kind):
    _, tc = _cfgs("xlstm_125m")
    gen = torch.Generator().manual_seed(1)
    init = tx.mlstm_init if kind == "mlstm" else tx.slstm_init
    block = tx.mlstm_block if kind == "mlstm" else tx.slstm_block
    cell = init(gen, tc, "cpu")
    x = torch.randn((2, 12, tc.d_model), generator=gen)
    out = block(x, cell, tc, mode="train")
    assert isinstance(out, torch.Tensor)
    assert torch.equal(out, block(x, cell, tc, mode="prefill")[0])


def test_inference_entry_points_stay_gradient_free():
    _, tc, _, _, tstate = _pair("granite_3_2b")
    assert all(p.requires_grad for p in tstate.params.parameters())
    logits, _ = tstate.params.prefill(torch.zeros((1, 4), dtype=torch.long), 6)
    assert not logits.requires_grad
    fresh = tlm.init_params(torch.Generator().manual_seed(0), tc, "cpu")
    assert not any(p.requires_grad for p in fresh.parameters())



def test_rglru_gate_weights_get_gradients():
    """wr, wi and lam feed K5's a and b: their gradients come through the
    scan's backward and are nonzero."""
    _, tc, _, _, tstate = _pair("recurrentgemma_9b", lru_width=128, **SHORT["recurrentgemma_9b"])
    model = tstate.params
    loss = model.train_loss(_torch(_batch(tc.vocab_size, seed=9)))[0]
    loss.backward()
    for i, blk in enumerate(model.blocks):
        if blk.kind == "rec":
            for name in ("wr", "wi", "lam", "br", "bi"):
                g = getattr(blk.rec, name).grad
                assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0, (i, name)
