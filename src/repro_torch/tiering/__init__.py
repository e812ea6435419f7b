"""Closed-loop hot/cold tiering over the device access-heat plane.

See :mod:`repro_torch.tiering.policy`.
"""

from repro_torch.tiering.policy import (
    TieringConfig,
    TieringPolicy,
    residency_extra,
    split_tiers,
)

__all__ = ["TieringConfig", "TieringPolicy", "residency_extra", "split_tiers"]
