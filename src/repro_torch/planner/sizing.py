"""Match-store cap sizing from the §IV-D estimators.

Host copy of ``StoreCaps``, ``match_caps``, ``quantize_store_caps`` and
``unit_table_caps`` from ``repro/planner/sizing.py``. ``caps`` only needs
``group_cap`` and ``set_cap`` attributes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from ..core.estimator import match_size_estimate, skeleton_size_estimate
from ..core.pattern import Pattern

__all__ = ["StoreCaps", "match_caps", "quantize_store_caps", "unit_table_caps"]


@dataclasses.dataclass(frozen=True)
class StoreCaps:
    """Copy of ``repro.planner.sizing.StoreCaps``: one store shard's
    ``group_cap`` groups × ``set_cap`` values per compressed-vertex set."""

    group_cap: int
    set_cap: int


def _up(x: float, align: int) -> int:
    return int(-(-max(1.0, x) // align) * align)


def _pow2_at_least(x: int, floor: int) -> int:
    n = floor
    while n < x:
        n *= 2
    return n


def quantize_store_caps(store: StoreCaps) -> StoreCaps:
    """Copy of ``repro.planner.sizing.quantize_store_caps``: a store's caps
    rounded up to powers of two (floors 64 / 8), so that near-equal
    estimates share one shape."""
    return StoreCaps(group_cap=_pow2_at_least(int(store.group_cap), 64),
                     set_cap=_pow2_at_least(int(store.set_cap), 8))


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


def unit_table_caps(units, cover: Sequence[int],
                    ord_: Sequence[Tuple[int, int]], stats, caps,
                    headroom: float = 2.0) -> StoreCaps:
    """Copy of ``repro.planner.sizing.unit_table_caps``: caps of the
    compressed unit-table carry from the largest per-unit skeleton-size
    and match-size estimates, scaled by ``headroom`` and floored at the
    engine caps."""
    est_g = max((skeleton_size_estimate(u.pattern, cover, ord_, stats)
                 for u in units), default=1.0)
    est_m = max((match_size_estimate(u.pattern, ord_, stats)
                 for u in units), default=1.0)
    group_cap = max(caps.group_cap, _up(headroom * est_g, 64))
    set_cap = max(caps.set_cap, _up(headroom * est_m / max(est_g, 1.0), 8))
    return StoreCaps(group_cap=group_cap, set_cap=set_cap)
