"""Synthetic TPC-H ``lineitem`` + hand-written Q1/Q6 (paper §7).

Columns (numeric encoding, one fp32 matrix):
  0 L_ORDERKEY      (the column the paper's concurrent writer mutates —
                     unused by Q1/Q6, so results stay valid under writes)
  1 L_QUANTITY      1..50
  2 L_EXTENDEDPRICE
  3 L_DISCOUNT      0.00..0.10
  4 L_TAX           0.00..0.08
  5 L_RETURNFLAG    {0,1,2}  (A/N/R)
  6 L_LINESTATUS    {0,1}    (O/F)
  7 L_SHIPDATE      days since 1992-01-01 (0..2526)

Q1: scan-heavy grouped aggregation (6 groups); Q6: selective filtered sum.
Both run morsel-at-a-time through the leap block table, on the device of
the store.

The partial aggregates are fp32 sums in a fixed order, so a query repeats
bit for bit on the card: Q1 sums each group under its own mask in one
reduction, not through ``index_add_``, whose CUDA atomics reorder the adds
from run to run.  Q1's count column is exact in fp32 while a group holds
fewer than 2**24 selected rows.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import graphs

ORDERKEY, QTY, PRICE, DISC, TAX, RFLAG, LSTATUS, SHIPDATE = range(8)
N_COLS = 8
N_GROUPS = 6  # returnflag (3) x linestatus (2)


def gen_lineitem(n_rows: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.empty((n_rows, N_COLS), np.float32)
    out[:, ORDERKEY] = rng.integers(1, 6_000_000, n_rows)
    out[:, QTY] = rng.integers(1, 51, n_rows)
    out[:, PRICE] = rng.uniform(900.0, 105_000.0, n_rows).round(2)
    out[:, DISC] = rng.integers(0, 11, n_rows) / 100.0
    out[:, TAX] = rng.integers(0, 9, n_rows) / 100.0
    out[:, RFLAG] = rng.integers(0, 3, n_rows)
    out[:, LSTATUS] = rng.integers(0, 2, n_rows)
    out[:, SHIPDATE] = rng.integers(0, 2527, n_rows)
    return out


def _param(x) -> torch.Tensor:
    """A query parameter as the 0-d fp32 operand the program traces."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.float32(x))


def _query(prog, body, morsels: torch.Tensor, param) -> torch.Tensor:
    """``body(morsels, param)`` as a variant of ``prog``, keyed on the
    morsels' shape and dtype: the last, shorter batch gets its own."""
    key = (tuple(morsels.shape), morsels.dtype, str(morsels.device))
    return prog(key, body, [morsels, _param(param)], [], device=morsels.device)


# Q1 and Q6 are compiled as the reference jits them: a ``graphs.Program``
# each, whose parameter (cutoff, year) is an operand, not part of the graph
Q1 = graphs.Program("q1_partial", fresh=True)
Q6 = graphs.Program("q6_partial", fresh=True)


def q1_partial(morsels: torch.Tensor, cutoff) -> torch.Tensor:
    """Per-morsel-batch Q1 aggregation.  morsels: [M, R, C] fp32, cutoff a
    number or a 0-d fp32 tensor.

    Returns [N_GROUPS, 6]: sum_qty, sum_base, sum_disc_price, sum_charge,
    sum_disc, count — combined across calls by addition; averages derived at
    the end (standard morsel-wise Q1 plan).
    """
    return _query(Q1, _q1, morsels, cutoff)


def _q1(morsels: torch.Tensor, cutoff: torch.Tensor) -> torch.Tensor:
    rows = morsels.reshape(-1, N_COLS)
    sel = rows[:, SHIPDATE] <= cutoff
    group = (rows[:, RFLAG] * 2 + rows[:, LSTATUS]).to(torch.int64)
    disc_price = rows[:, PRICE] * (1.0 - rows[:, DISC])
    charge = disc_price * (1.0 + rows[:, TAX])
    vals = torch.stack(
        [
            rows[:, QTY],
            rows[:, PRICE],
            disc_price,
            charge,
            rows[:, DISC],
            torch.ones_like(disc_price),
        ],
        dim=1,
    )
    groups = torch.arange(N_GROUPS, device=rows.device)
    onehot = (group[:, None] == groups[None, :]) & sel[:, None]  # [n, G]
    # one masked reduction per group, in a fixed order (no atomics)
    return (vals[:, None, :] * onehot[:, :, None]).sum(dim=0)


def q6_partial(morsels: torch.Tensor, year_start) -> torch.Tensor:
    """Per-morsel-batch Q6 revenue.  Filter: shipdate in [ys, ys+365),
    discount in [0.05, 0.07], quantity < 24.  ``year_start`` a number or a
    0-d fp32 tensor."""
    return _query(Q6, _q6, morsels, year_start)


def _q6(morsels: torch.Tensor, year_start: torch.Tensor) -> torch.Tensor:
    rows = morsels.reshape(-1, N_COLS)
    sel = (
        (rows[:, SHIPDATE] >= year_start)
        & (rows[:, SHIPDATE] < year_start + 365)
        & (rows[:, DISC] >= 0.05 - 1e-6)
        & (rows[:, DISC] <= 0.07 + 1e-6)
        & (rows[:, QTY] < 24)
    )
    return torch.sum(rows[:, PRICE] * rows[:, DISC] * sel)


def q1_reference(data: np.ndarray, cutoff: float) -> np.ndarray:
    sel = data[:, SHIPDATE] <= cutoff
    group = (data[:, RFLAG] * 2 + data[:, LSTATUS]).astype(np.int64)
    disc_price = data[:, PRICE] * (1 - data[:, DISC])
    charge = disc_price * (1 + data[:, TAX])
    out = np.zeros((N_GROUPS, 6), np.float64)
    for g in range(N_GROUPS):
        m = sel & (group == g)
        out[g] = [
            data[m, QTY].sum(),
            data[m, PRICE].sum(),
            disc_price[m].sum(),
            charge[m].sum(),
            data[m, DISC].sum(),
            m.sum(),
        ]
    return out


def q6_reference(data: np.ndarray, year_start: float) -> float:
    sel = (
        (data[:, SHIPDATE] >= year_start)
        & (data[:, SHIPDATE] < year_start + 365)
        & (data[:, DISC] >= 0.05 - 1e-6)
        & (data[:, DISC] <= 0.07 + 1e-6)
        & (data[:, QTY] < 24)
    )
    return float((data[sel, PRICE] * data[sel, DISC]).sum())


def run_query(store, which: str, param: float, morsel_batch: int = 64) -> torch.Tensor:
    """Execute Q1/Q6 morsel-at-a-time through the store's block table."""
    total = None
    p = _param(param)
    for start in range(0, store.n_morsels, morsel_batch):
        ids = np.arange(start, min(start + morsel_batch, store.n_morsels))
        blocks = store.read(ids)
        part = q1_partial(blocks, p) if which == "q1" else q6_partial(blocks, p)
        total = part if total is None else total + part
    return total
