"""Match-store cap sizing from the §IV-D estimators.

Host copy of ``StoreCaps`` and ``match_caps`` from
``repro/planner/sizing.py``. ``caps`` only needs ``group_cap`` and
``set_cap`` attributes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from ..core.estimator import match_size_estimate, skeleton_size_estimate
from ..core.pattern import Pattern

__all__ = ["StoreCaps", "match_caps"]


@dataclasses.dataclass(frozen=True)
class StoreCaps:
    """Copy of ``repro.planner.sizing.StoreCaps``: one store shard's
    ``group_cap`` groups × ``set_cap`` values per compressed-vertex set."""

    group_cap: int
    set_cap: int


def _up(x: float, align: int) -> int:
    return int(-(-max(1.0, x) // align) * align)


def match_caps(pattern: Pattern, cover: Sequence[int],
               ord_: Sequence[Tuple[int, int]], stats, caps,
               headroom: float = 4.0) -> StoreCaps:
    """Copy of ``repro.planner.sizing.match_caps``: store caps from the
    skeleton-size and match-size estimates, scaled by ``headroom`` and
    floored at the engine caps."""
    est_m = match_size_estimate(pattern, ord_, stats)
    est_g = skeleton_size_estimate(pattern, cover, ord_, stats)
    group_cap = max(caps.group_cap, _up(headroom * est_g, 64))
    set_cap = max(caps.set_cap, _up(headroom * est_m / max(est_g, 1.0), 8))
    return StoreCaps(group_cap=group_cap, set_cap=set_cap)
