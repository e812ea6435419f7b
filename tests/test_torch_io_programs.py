"""The application I/O programs as compiled programs, against the JAX package,
on the CPU.

The reference jits ``leap_read``, ``leap_write``, ``leap_write_rows``,
``block_regions``, ``huge_read``, ``group_dirty``, ``group_in_flight``
(``core/state.py``) and admission's ``busy_mask``; the port compiles each
as a ``graphs.Program`` (``state.IO_PROGRAMS``, ``admission.BUSY_MASK``)
keyed on what the reference's jit keys on.  Here the same seeded calls go
through both packages:

* results and the state after each call bit for bit (integer, bool and
  copied fp32 payload);
* the variants each program registers equal the reference's
  ``_cache_size()``, both counted as a delta after ``clear_cache()``;
* a read's result stays as it was after later reads;
* a drain with application writes and reads has the reference's
  ``jit_cache_misses`` (the I/O programs are no migration programs, on
  either side) and, per I/O program, its variant count.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import state as jst  # noqa: E402
from repro.core.pipeline import admission as jadm  # noqa: E402
from repro_torch.core import migrator as tmig  # noqa: E402
from repro_torch.core import state as tst  # noqa: E402
from repro_torch.core.pipeline import admission as tadm  # noqa: E402

from test_torch_driver import Pair  # noqa: E402

NB, SL = 24, 32  # blocks (dense in region 0, then region 1) and slots a region
BLK = (2, 8)


def _programs():
    """name -> (the reference's jitted function, the port's Program)."""
    out = {name: (getattr(jst, name), prog) for name, prog in tst.IO_PROGRAMS.items()}
    out["busy_mask"] = (jadm.busy_mask, tadm.BUSY_MASK)
    return out


def _clear():
    for jf, prog in _programs().values():
        jf.clear_cache()
        prog.clear()


def _sizes() -> dict:
    return {name: (jf._cache_size(), len(prog)) for name, (jf, prog) in _programs().items()}


class _States:
    """Equal states in both packages; the reference's is rebound after each
    donating call."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        pool = rng.normal(size=(2, SL) + BLK).astype(np.float32)
        table = np.stack([np.arange(NB) % 2, np.arange(NB) // 2], 1).astype(np.int32)
        leaves = pool, table, rng.random(NB) < 0.3, rng.random(NB) < 0.5
        self.j = jst.LeapState(*(jnp.asarray(x) for x in leaves))
        self.t = tst.LeapState.from_numpy(*leaves, "cpu")

    def assert_equal(self):
        for got, want in zip(self.t.to_numpy(), (self.j.pool, self.j.table, self.j.dirty,
                                                 self.j.in_flight)):
            np.testing.assert_array_equal(got, np.asarray(want))


def _calls(name, rng):
    """Seeded argument lists of one program: two lengths, then the first
    again (a known variant); the group programs at two huge factors."""
    out = []
    for n in (3, 5, 3):
        ids = rng.choice(NB, size=n, replace=False)
        if name in ("huge_read", "group_dirty", "group_in_flight"):
            for g in (2, 4):
                out.append((rng.choice(NB // g, size=n, replace=False), g))
        elif name == "leap_write":
            out.append((ids, rng.normal(size=(n,) + BLK).astype(np.float32)))
        elif name == "leap_write_rows":
            out.append((ids, rng.integers(0, BLK[0], n), rng.normal(size=(n, BLK[1]))
                        .astype(np.float32)))
        else:
            out.append((ids,))
    return out


@pytest.mark.parametrize("name", ["leap_read", "leap_write", "leap_write_rows", "block_regions",
                                  "huge_read", "group_dirty", "group_in_flight", "busy_mask"])
def test_program_matches_the_reference_and_its_variants(name):
    jf, _ = _programs()[name]
    tf = tadm.busy_mask if name == "busy_mask" else getattr(tst, name)
    st = _States(seed=len(name))
    _clear()
    for args in _calls(name, np.random.default_rng(7)):
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        if name.startswith("leap_write"):
            st.j = jf(st.j, *jargs)
            assert tf(st.t, *args) is st.t
        else:
            np.testing.assert_array_equal(tf(st.t, *args).numpy(), np.asarray(jf(st.j, *jargs)))
        st.assert_equal()
    sizes = _sizes()
    assert sizes[name][0] == sizes[name][1] == (4 if name in ("huge_read", "group_dirty",
                                                              "group_in_flight") else 2)
    assert all(j == t == 0 for n, (j, t) in sizes.items() if n != name)


def test_write_trap_marks_exactly_the_in_flight_blocks():
    st = _States(seed=1)
    ids = np.arange(0, NB, 3)
    dirty, in_flight = st.t.dirty.clone(), st.t.in_flight.clone()
    tst.leap_write(st.t, ids, np.zeros((len(ids),) + BLK, np.float32))
    want = dirty.clone()
    want[ids] |= in_flight[ids]
    assert torch.equal(st.t.dirty, want) and torch.equal(st.t.in_flight, in_flight)


@pytest.mark.parametrize("name", ["leap_read", "block_regions", "huge_read", "group_dirty",
                                  "group_in_flight", "busy_mask"])
def test_a_read_is_not_overwritten_by_the_next(name):
    """The reference returns a fresh array from every call; so does every
    read-type program of the port (on the card a replay's outputs would be
    the graph's own, which the next replay overwrites)."""
    st = _States(seed=2)
    tf = tadm.busy_mask if name == "busy_mask" else getattr(tst, name)
    extra = (2,) if name in ("huge_read", "group_dirty", "group_in_flight") else ()
    first_ids, later_ids = np.array([0, 1, 2]), np.array([5, 7, 9])
    first = tf(st.t, first_ids, *extra)
    kept = first.clone()
    later = tf(st.t, later_ids, *extra)  # the same variant
    assert first.data_ptr() != later.data_ptr()
    assert torch.equal(first, kept)
    jf = _programs()[name][0]
    np.testing.assert_array_equal(first.numpy(), np.asarray(jf(st.j, jnp.asarray(first_ids),
                                                               *extra)))


def test_io_programs_are_no_migration_programs():
    names = set(tst.IO_PROGRAMS) | {"busy_mask"}
    assert not names & set(tmig.PROGRAMS)
    assert not names & set(tmig.program_cache_sizes())


@pytest.mark.parametrize("cfg_kw", [dict(), dict(fused_dispatch="batched"),
                                    dict(fused_dispatch="legacy")],
                         ids=["megastep", "batched", "legacy"])
def test_drain_with_reads_and_writes_has_the_references_misses(cfg_kw):
    """Writes and reads of the application every tick beside a leap, under
    each dispatch generation: the state bit for bit, ``jit_cache_misses``
    equal with no subtraction, and each I/O program's variants equal."""
    n = 32
    p = Pair(n, 2 * n, dict(initial_area_blocks=8, chunk_blocks=4, budget_blocks_per_tick=8,
                            **cfg_kw), seed=4)
    _clear()
    rng = np.random.default_rng(4)
    p.leap(np.arange(n), 1)
    for tick in range(200):
        if all(s.done for s in p.sessions):
            break
        p.tick()
        k = 2 + tick % 3  # three lengths of writes and of reads
        ids = rng.choice(n, size=k, replace=False)
        p.write(ids, rng.normal(size=(k, 4)).astype(np.float32))
        p.read(rng.choice(n, size=k, replace=False))  # checked against the reference
    p.drain()
    assert p.t.stats.jit_cache_misses == p.j.stats.jit_cache_misses
    assert p.t.stats.dirty_rejections > 0
    sizes = _sizes()  # before assert_equal reads the whole pool on the port's side alone
    for name in ("leap_write", "leap_read"):
        assert sizes[name][0] == sizes[name][1] == 3, name
    p.assert_equal()
