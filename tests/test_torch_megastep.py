"""The port's megastep against the JAX package's, phase combination by
phase combination.

The JAX megastep gets its operands padded as its dispatch stage pads them
(out-of-bounds sentinels, lane-0 replication, a bucket per phase); the port's
gets the real lengths.  The resulting state must match bit for bit, the
verdicts on their real lanes, and the heat plane within rtol = atol = 1e-6.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import migrator as jmig  # noqa: E402
from repro.core import state as jst  # noqa: E402
from repro.core.adaptive import pad_to_bucket  # noqa: E402
from repro_torch.core import migrator as tmig  # noqa: E402
from repro_torch.core import state as tst  # noqa: E402
from repro_torch.kernels.heat_scan import padded_heat_len  # noqa: E402

R, S, G, N = 2, 32, 4, 32  # all blocks start dense in region 0; region 1 is free
BUCKET, GBUCKET, HBUCKET = 8, 4, 64
HEAT_TOL = dict(rtol=1e-6, atol=1e-6)
PHASES = ("commit", "groups", "begin", "zero", "force", "copy", "runs", "heat")


def _scenario(seed):
    """One tick's operands over disjoint blocks and fresh destinations."""
    rng = np.random.default_rng(seed)
    pool = rng.normal(size=(R, S, 2, 8)).astype(np.float32)
    table = np.stack([np.zeros(N), np.arange(N)], 1).astype(np.int32)
    dirty = rng.random(N) < 0.5
    in_flight = np.zeros(N, bool)
    in_flight[:12] = True  # open epochs: the commit and group-commit blocks
    L = padded_heat_len(N)
    k = int(rng.integers(5, 40))
    heat_ids = rng.integers(0, N, size=k)
    ops = dict(
        commit_ids=np.arange(0, 4),
        commit_regions=np.ones(4),
        commit_slots=np.arange(0, 4),  # region 1 slots 0..3
        grp_members=np.arange(8, 12),  # group 2
        grp_regions=np.ones(1),
        grp_starts=np.array([4]),  # region 1 run 4..7
        begin_ids=np.arange(16, 20),
        zero_flat=S + np.arange(8, 12),  # region 1 slots 8..11
        force_ids=np.array([20, 21]),
        force_regions=np.ones(2),
        force_slots=np.array([12, 13]),
        copy_src=np.array([24, 25, 26]),  # blocks 24..26 at region 0
        copy_dst=S + np.arange(16, 19),
        run_src=np.array([28]),  # group 7 at region 0 slots 28..31
        run_dst=np.array([S + 20]),
        heat_ids=heat_ids,
        heat_w=rng.uniform(0.5, 2.0, size=k).astype(np.float32),
    )
    heat = rng.gamma(1.0, 1.0, size=L).astype(np.float32)
    return pool, table, dirty, in_flight, heat, ops


def _keep(ops, phases):
    """Empty the operands of every phase not in ``phases``."""
    owner = {
        "commit": ("commit_ids", "commit_regions", "commit_slots"),
        "groups": ("grp_members", "grp_regions", "grp_starts"),
        "begin": ("begin_ids",),
        "zero": ("zero_flat",),
        "force": ("force_ids", "force_regions", "force_slots"),
        "copy": ("copy_src", "copy_dst"),
        "runs": ("run_src", "run_dst"),
        "heat": ("heat_ids", "heat_w"),
    }
    out = dict(ops)
    for phase, names in owner.items():
        if phase not in phases:
            for name in names:
                out[name] = ops[name][:0]
    return out


def _jax_padded(ops, L):
    """Pad as the JAX dispatch stage does: sentinels, lane-0 copies, buckets."""

    def sentinel(a, bucket, value):
        if not len(a):
            return jnp.zeros(0, jnp.int32)
        out = np.full(bucket, value, np.int32)
        out[: len(a)] = a
        return jnp.asarray(out)

    def replicate(bucket, *arrays):
        if not len(arrays[0]):
            return [jnp.zeros(0, jnp.int32) for _ in arrays]
        return [jnp.asarray(a) for a in pad_to_bucket(bucket, *(np.asarray(x, np.int32) for x in arrays))]

    members = ops["grp_members"].reshape(-1, G)
    if len(members):
        members = np.concatenate([members, np.repeat(members[:1], GBUCKET - len(members), 0)])
    grp_regions, grp_starts = replicate(GBUCKET, ops["grp_regions"], ops["grp_starts"])
    copy_src, copy_dst = replicate(BUCKET, ops["copy_src"], ops["copy_dst"])
    run_src, run_dst = replicate(GBUCKET, ops["run_src"], ops["run_dst"])
    hw = np.zeros(HBUCKET if len(ops["heat_w"]) else 0, np.float32)
    hw[: len(ops["heat_w"])] = ops["heat_w"]
    return [
        sentinel(ops["commit_ids"], BUCKET, N),
        sentinel(ops["commit_regions"], BUCKET, R),
        sentinel(ops["commit_slots"], BUCKET, S),
        jnp.asarray(members.reshape(-1).astype(np.int32)),
        grp_regions,
        grp_starts,
        sentinel(ops["begin_ids"], BUCKET, N),
        sentinel(ops["zero_flat"], BUCKET, R * S),
        sentinel(ops["force_ids"], BUCKET, N),
        sentinel(ops["force_regions"], BUCKET, R),
        sentinel(ops["force_slots"], BUCKET, S),
        copy_src,
        copy_dst,
        run_src,
        run_dst,
        sentinel(ops["heat_ids"], HBUCKET, L),
        jnp.asarray(hw),
    ]


COMBOS = [
    (),
    PHASES,
    ("commit",),
    ("groups",),
    ("begin",),
    ("zero",),
    ("force",),
    ("copy",),
    ("runs",),
    ("heat",),
    ("commit", "begin", "copy"),
    ("commit", "groups", "heat"),
    ("groups", "begin", "runs"),
    ("zero", "force", "copy"),
    ("commit", "force", "copy", "runs", "heat"),
]


@pytest.mark.parametrize("phases", COMBOS, ids=lambda p: "+".join(p) or "none")
@pytest.mark.parametrize("seed", [0, 1])
def test_megastep_matches_jax(phases, seed):
    pool, table, dirty, in_flight, heat, ops = _scenario(seed)
    ops = _keep(ops, phases)
    L = len(heat)
    jops = _jax_padded(ops, L)
    with_heat = "heat" in phases
    js = jst.LeapState(*(jnp.asarray(x) for x in (pool, table, dirty, in_flight)))
    js, jv_small, jv_groups, jheat = jmig.megastep(
        js, *jops[:15],
        jnp.asarray(heat) if with_heat else jnp.zeros(0, jnp.float32),
        *jops[15:],
        group=G, heat_decay=0.9,
    )

    ts = tst.LeapState.from_numpy(pool, table, dirty, in_flight, "cpu")
    theat = torch.from_numpy(heat.copy())
    t = {k: torch.from_numpy(np.asarray(v, np.float32 if k == "heat_w" else np.int64))
         for k, v in ops.items()}
    ts, tv_small, tv_groups, theat_out = tmig.megastep(
        ts, *(t[k] for k in list(ops)[:15]),
        theat if with_heat else torch.zeros(0),
        t["heat_ids"], t["heat_w"],
        group=G, heat_decay=0.9,
    )

    tpool, ttable, tdirty, tflight = ts.to_numpy()
    np.testing.assert_array_equal(tpool, np.asarray(js.pool))
    np.testing.assert_array_equal(ttable, np.asarray(js.table))
    np.testing.assert_array_equal(tdirty, np.asarray(js.dirty))
    np.testing.assert_array_equal(tflight, np.asarray(js.in_flight))
    n_commit, n_groups = len(ops["commit_ids"]), len(ops["grp_starts"])
    assert tv_small.shape == (n_commit,) and tv_groups.shape == (n_groups,)
    np.testing.assert_array_equal(tv_small.numpy(), np.asarray(jv_small)[:n_commit])
    np.testing.assert_array_equal(tv_groups.numpy(), np.asarray(jv_groups)[:n_groups])
    if with_heat:
        assert theat_out is theat  # updated in place
        np.testing.assert_allclose(theat.numpy(), np.asarray(jheat), **HEAT_TOL)
    else:
        np.testing.assert_array_equal(theat.numpy(), heat)


def test_megastep_commit_verdict_reads_dirty_before_begin_clears_it():
    """A block committed and re-opened in one tick: the verdict is the dirty
    bit it had before this tick's begin phase cleared it in place."""
    pool, table, dirty, in_flight, heat, ops = _scenario(3)
    dirty[:4] = [True, False, True, False]
    ts = tst.LeapState.from_numpy(pool, table, dirty, in_flight, "cpu")
    ids = torch.arange(4)
    empty = torch.zeros(0, dtype=torch.int64)
    ts, verdict, _, _ = tmig.megastep(
        ts, ids, torch.ones(4, dtype=torch.int64), ids,
        empty, empty, empty, ids, *([empty] * 8),
        torch.zeros(0), empty, torch.zeros(0), group=G,
    )
    assert verdict.tolist() == [True, False, True, False]
    assert not ts.dirty[:4].any() and ts.in_flight[:4].all()


def test_force_areas_matches_jax():
    pool, table, dirty, in_flight, _, _ = _scenario(4)
    ids, regions, slots = np.arange(4, 8), np.ones(4), np.arange(24, 28)
    js = jst.LeapState(*(jnp.asarray(x) for x in (pool, table, dirty, in_flight)))
    js = jmig.force_areas(js, jnp.asarray(ids), jnp.asarray(regions, jnp.int32), jnp.asarray(slots))
    ts = tst.LeapState.from_numpy(pool, table, dirty, in_flight, "cpu")
    ts = tmig.force_areas(ts, *(torch.from_numpy(np.asarray(x, np.int64)) for x in (ids, regions, slots)))
    for got, want in zip(ts.to_numpy(), (js.pool, js.table, js.dirty, js.in_flight)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert tmig.program_cache_sizes()["force_areas"] == 0  # eager: compiles nothing
