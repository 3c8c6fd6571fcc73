"""Match-store and WCOJ level cap sizing from the §IV-D estimators.

Host copy of ``StoreCaps``, ``match_caps``, ``quantize_store_caps``,
``unit_table_caps``, ``wcoj_prefix_estimates`` and ``wcoj_level_caps`` from
``repro/planner/sizing.py``. ``caps`` only needs ``group_cap`` and
``set_cap`` attributes. :func:`calibrate_wcoj_caps` is the register-time
calibration of the streaming service's sharded backend
(``ShardedBackend._calibrate_wcoj_caps``) as a plain function.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from ..core.estimator import match_size_estimate, skeleton_size_estimate
from ..core.match_engine import wcoj_level_counts
from ..core.pattern import Pattern
from ..core.plan import WcojPlan
from ..core.storage import NPStorage

__all__ = ["StoreCaps", "match_caps", "quantize_store_caps", "unit_table_caps",
           "wcoj_prefix_estimates", "wcoj_level_caps", "calibrate_wcoj_caps"]


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


def wcoj_prefix_estimates(pattern: Pattern, order: Sequence[int],
                          ord_: Sequence[Tuple[int, int]], stats):
    """Copy of ``repro.planner.sizing.wcoj_prefix_estimates``: the expected
    partial-match table size after each generic-join level. Entry ``l`` is
    the §IV-D estimate of the pattern induced by the first ``l + 1`` order
    vertices, clamped by the mean-degree chain ``est[l-1] · d̄``; entry 0
    is ``stats.n``. Summed, it is the WCOJ executor's cost."""
    order = tuple(order)
    dbar = 2.0 * stats.m / max(stats.n, 1)
    out = [float(stats.n)]
    prev = None
    for l in range(2, len(order) + 1):
        sub = pattern.induced(order[:l])
        est = match_size_estimate(sub, ord_, stats)
        chain = float(stats.m) if prev is None else prev * max(dbar, 1.0)
        prev = min(est, chain) if est > 0 else chain
        out.append(prev)
    return tuple(out)


def wcoj_level_caps(pattern: Pattern, order: Sequence[int],
                    ord_: Sequence[Tuple[int, int]], stats, m: int = 1,
                    headroom: float = 4.0) -> Tuple[int, ...]:
    """Copy of ``repro.planner.sizing.wcoj_level_caps``: one cap per placed
    prefix length (cap 0 bounds the anchor seeds), the prefix estimates
    over ``m`` partitions times ``headroom``, up the pow2 ladder (floor 64)."""
    ests = wcoj_prefix_estimates(pattern, order, ord_, stats)
    return tuple(
        _pow2_at_least(_up(headroom * est / max(int(m), 1), 1), 64)
        for est in ests
    )


def calibrate_wcoj_caps(storage: NPStorage, plan: WcojPlan,
                        level_headroom: float = 1.5,
                        store_headroom: float = 4.0) -> Tuple[Tuple[int, ...], int]:
    """The register-time calibration of ``ShardedBackend._calibrate_wcoj_caps``:
    one host pass of :func:`~repro_torch.core.match_engine.wcoj_level_counts`
    over every partition, and the largest table of each level across them.
    Returns ``(level_caps, store_group_floor)``: each level's peak times
    ``level_headroom`` (transient tensors) and the last level's times
    ``store_headroom`` (the persistent store), up the pow2 ladder (floor 64)."""
    observed = [wcoj_level_counts(part, plan, anchor_to_centers=True)
                for part in storage.parts]
    peaks = [max((o[lvl] for o in observed), default=0)
             for lvl in range(len(plan.order))]
    return (tuple(_pow2_at_least(int(level_headroom * p), 64) for p in peaks),
            _pow2_at_least(int(store_headroom * peaks[-1]), 64))
