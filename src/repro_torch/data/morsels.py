"""Morsel store: fixed-size row-group morsels living on a leap pool.

The paper's §7 scenario: a morsel-driven engine [Leis et al., SIGMOD'14]
whose morsels sit on the wrong NUMA region get leap-migrated to the idle
worker's region before/while query processing.  Here one morsel = one leap
block ``[rows_per_morsel, n_cols]``; queries read through the block table
(transparent — migration never changes a morsel id), and concurrent
transactional writes go through ``write_rows`` (dirty protocol applies).

Also used for training-data work stealing (straggler mitigation): a region
that drains its morsel queue steals morsels from the most loaded region.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api import LeapHandle, LeapSession
from repro_torch.core import LeapConfig, MigrationDriver, PoolConfig, init_state
from repro_torch.core.state import as_index


@dataclasses.dataclass
class MorselStore:
    driver: MigrationDriver
    rows_per_morsel: int
    n_cols: int
    n_morsels: int

    @classmethod
    def create(
        cls,
        data: np.ndarray,  # [n_rows, n_cols]
        rows_per_morsel: int,
        n_regions: int,
        initial_region: int | np.ndarray = 0,
        region_capacity_frac: float = 1.0,
        leap: LeapConfig | None = None,
        dtype=torch.float32,
        device=None,
    ) -> "MorselStore":
        """``region_capacity_frac``: each region's pooled capacity as a
        fraction of the total morsel count (1.0 = any single region can hold
        the whole table, the paper's pooled-destination setup).  The pool
        lives on ``device``, the current CUDA device by default (raises
        without one)."""
        n_rows, n_cols = data.shape
        n_morsels = (n_rows + rows_per_morsel - 1) // rows_per_morsel
        pad = n_morsels * rows_per_morsel - n_rows
        if pad:
            data = np.concatenate([data, np.zeros((pad, n_cols), data.dtype)])
        slots = int(np.ceil(n_morsels * region_capacity_frac)) + 1
        pool_cfg = PoolConfig(n_regions, slots, (rows_per_morsel, n_cols), dtype)
        if np.isscalar(initial_region):
            placement = np.full(n_morsels, initial_region, np.int32)
        else:
            placement = np.asarray(initial_region, np.int32)
        state = init_state(pool_cfg, n_morsels, placement, device=device)
        driver = MigrationDriver(state, pool_cfg, leap or LeapConfig())
        blocks = torch.from_numpy(data.reshape(n_morsels, rows_per_morsel, n_cols))
        driver.write(np.arange(n_morsels), blocks.to(state.device, dtype))
        return cls(driver, rows_per_morsel, n_cols, n_morsels)

    # -- access ---------------------------------------------------------------

    def read(self, morsel_ids) -> torch.Tensor:
        return self.driver.read(morsel_ids)

    def write_rows(self, morsel_ids, row_offsets, rows) -> None:
        self.driver.write_rows(morsel_ids, row_offsets, rows)

    def write_random_fields(self, rng: np.random.Generator, n: int, col: int, value=0.0):
        """Transactional write burst: ``n`` random single-row field updates.

        The rows are read, patched and written back on the store's device;
        only the ids and offsets come from the host generator."""
        ids = rng.integers(0, self.n_morsels, size=n)
        offs = rng.integers(0, self.rows_per_morsel, size=n)
        current = self.read(ids)
        dev = current.device
        rows = current[torch.arange(n, device=dev), as_index(offs, dev)]
        rows[:, col] = value
        self.write_rows(ids, offs, rows)

    # -- migration -------------------------------------------------------------

    @property
    def session(self) -> LeapSession:
        return self.driver.default_session()

    def leap(self, morsel_ids, dst_region: int, priority: int = 0) -> LeapHandle:
        """Asynchronously migrate morsels; returns a trackable handle."""
        return self.session.leap(np.asarray(morsel_ids), dst_region, priority=priority)

    def steal(self, morsel_ids, dst_region: int) -> int:
        return self.leap(morsel_ids, dst_region).requested

    def placement(self) -> np.ndarray:
        return self.driver.host_placement()

    def tick(self) -> None:
        self.session.tick()

    def drain(self, max_ticks: int = 100_000) -> bool:
        return self.session.drain(max_ticks)
