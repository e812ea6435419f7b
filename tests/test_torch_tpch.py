"""Synthetic TPC-H over a leaping morsel store: the port against the JAX
package.

* ``gen_lineitem`` is the reference's, bit for bit (the port keeps its own
  copy).
* Q1/Q6 partials against the JAX ones within rtol 1e-5 (both sum fp32, in
  different orders) and whole queries against the float64 numpy references
  within rtol 1e-3, the reference's own tolerance
  (``tests/test_data_tpch.py``).
* ``MorselStore`` scenarios of ``tests/test_data_tpch.py`` (migration,
  the concurrent ``L_ORDERKEY`` writer, work stealing, a failed-region
  drain) run over both packages: states, stats and results bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_baselines import JAX, PORT, assert_same, both, outcome  # noqa: E402

from repro.data import tpch as jtpch  # noqa: E402
from repro.data.morsels import MorselStore as JStore  # noqa: E402
from repro_torch.data import tpch  # noqa: E402
from repro_torch.data.morsels import MorselStore  # noqa: E402

Q1_CUTOFF, Q6_YEAR = 2400.0, 730.0
RTOL_JAX, RTOL_REF = 1e-5, 1e-3


@pytest.mark.parametrize("n_rows,seed", [(1, 0), (4096, 0), (5000, 3)])
def test_gen_lineitem_is_the_references(n_rows, seed):
    got = tpch.gen_lineitem(n_rows, seed)
    np.testing.assert_array_equal(got, jtpch.gen_lineitem(n_rows, seed))
    assert got.dtype == np.float32 and got.shape == (n_rows, tpch.N_COLS)
    assert (tpch.ORDERKEY, tpch.SHIPDATE, tpch.N_GROUPS) == (
        jtpch.ORDERKEY, jtpch.SHIPDATE, jtpch.N_GROUPS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partials_match_jax_and_numpy(seed):
    data = tpch.gen_lineitem(64 * 128, seed)
    morsels = data.reshape(64, 128, tpch.N_COLS)
    for cutoff in (0.0, 1200.0, Q1_CUTOFF, 2526.0):
        got = tpch.q1_partial(torch.from_numpy(morsels), cutoff).double().numpy()
        want = np.asarray(jtpch.q1_partial(jnp.asarray(morsels), jnp.float32(cutoff)))
        np.testing.assert_allclose(got, want, rtol=RTOL_JAX, atol=1e-3)
        np.testing.assert_allclose(got, tpch.q1_reference(data, cutoff), rtol=RTOL_REF)
        np.testing.assert_array_equal(got[:, 5], want[:, 5])  # the count is exact
    for year in (0.0, Q6_YEAR, 2190.0):
        got = float(tpch.q6_partial(torch.from_numpy(morsels), year))
        want = float(jtpch.q6_partial(jnp.asarray(morsels), jnp.float32(year)))
        np.testing.assert_allclose(got, want, rtol=RTOL_JAX)
        np.testing.assert_allclose(got, tpch.q6_reference(data, year), rtol=RTOL_REF)


class _Store:
    """The two packages' MorselStore behind one surface."""

    def __init__(self, P, data, rows_per_morsel, n_regions):
        self.P = P
        if P.torch:
            self.s = MorselStore.create(data, rows_per_morsel, n_regions, device="cpu")
            self.q = tpch
        else:
            self.s = JStore.create(data, rows_per_morsel, n_regions)
            self.q = jtpch

    def query(self, which, param):
        return np.asarray(self.q.run_query(self.s, which, param), np.float64)

    def read_all(self):
        ids = np.arange(self.s.n_morsels)
        return np.asarray(self.s.read(ids if self.P.torch else jnp.asarray(ids)))


def _query_at_rest_and_after_leap(P):
    data = tpch.gen_lineitem(4096, 0)
    st = _Store(P, data, 128, 2)
    q1, q6 = st.query("q1", Q1_CUTOFF), st.query("q6", Q6_YEAR)
    np.testing.assert_allclose(q1, tpch.q1_reference(data, Q1_CUTOFF), rtol=RTOL_REF)
    np.testing.assert_allclose(q6, tpch.q6_reference(data, Q6_YEAR), rtol=RTOL_REF)
    assert st.s.steal(np.arange(st.s.n_morsels), dst_region=1) == st.s.n_morsels
    assert st.s.drain() and (st.s.placement() == 1).all()
    np.testing.assert_array_equal(st.query("q1", Q1_CUTOFF), q1)  # migration is transparent
    return dict(q1=q1, q6=q6, out=outcome(st.s.driver))


def test_queries_match_the_reference_and_survive_migration():
    got, want = _query_at_rest_and_after_leap(PORT), _query_at_rest_and_after_leap(JAX)
    np.testing.assert_allclose(got["q1"], want["q1"], rtol=RTOL_JAX)
    np.testing.assert_allclose(got["q6"], want["q6"], rtol=RTOL_JAX)
    assert_same(want["out"], got["out"])


def test_repeated_query_is_bit_identical():
    st = MorselStore.create(tpch.gen_lineitem(4096, 1), 64, 2, device="cpu")
    for which, p in (("q1", Q1_CUTOFF), ("q6", Q6_YEAR)):
        assert torch.equal(tpch.run_query(st, which, p), tpch.run_query(st, which, p))


def _leap_under_writer(P):
    """Paper §7 (fig8's writer): every morsel leaps 0 -> 1 while random
    single-row writes land in L_ORDERKEY, which Q1/Q6 never read."""
    data = tpch.gen_lineitem(2048, 0)
    st = _Store(P, data, 64, 2)
    st.s.steal(np.arange(st.s.n_morsels), dst_region=1)
    rng = np.random.default_rng(1)
    steps = 0
    while not st.s.driver.done and steps < 2000:
        st.s.tick()
        st.s.session.poll(block=True)
        st.s.write_random_fields(rng, n=4, col=tpch.ORDERKEY, value=-1.0)
        steps += 1
    assert st.s.drain()
    q1 = st.query("q1", Q1_CUTOFF)
    np.testing.assert_allclose(q1, tpch.q1_reference(data, Q1_CUTOFF), rtol=RTOL_REF)
    blocks = st.read_all()
    assert (blocks[..., tpch.ORDERKEY] == -1.0).any()
    assert st.s.driver.stats.dirty_rejections > 0
    return dict(out=outcome(st.s.driver), blocks=blocks)


def test_morsel_leap_under_orderkey_writer_matches_jax():
    both(_leap_under_writer)


def _work_stealing(P):
    st = _Store(P, tpch.gen_lineitem(2048, 0), 64, 4)
    assert (st.s.placement() == 0).all()
    moved = P.fault.rebalance_even(st.s.driver)
    assert moved > 0 and st.s.drain()
    hist = np.bincount(st.s.placement(), minlength=4)
    assert hist.max() - hist.min() <= 1
    return dict(moved=moved, out=outcome(st.s.driver))


def test_work_stealing_balances_regions():
    both(_work_stealing)


def _drain_failed_region(P):
    st = _Store(P, tpch.gen_lineitem(1024, 0), 64, 4)
    P.fault.rebalance_even(st.s.driver)
    st.s.drain()
    before = st.read_all()
    n = P.fault.drain_region(st.s.driver, failed_region=0)
    assert n > 0
    rng = np.random.default_rng(2)
    while not st.s.driver.done:
        st.s.tick()
        st.s.session.poll(block=True)
        st.s.write_random_fields(rng, n=2, col=tpch.ORDERKEY, value=-2.0)
    assert st.s.drain()
    assert (st.s.placement() != 0).all()
    after = st.read_all()
    np.testing.assert_array_equal(np.delete(after, tpch.ORDERKEY, axis=2),
                                  np.delete(before, tpch.ORDERKEY, axis=2))
    return dict(n=n, out=outcome(st.s.driver), after=after)


def test_drain_failed_region_under_writes():
    both(_drain_failed_region)


def test_store_defaults_to_the_card():
    data = tpch.gen_lineitem(256, 0)
    if torch.cuda.is_available():
        assert MorselStore.create(data, 64, 2).driver.state.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MorselStore.create(data, 64, 2)
