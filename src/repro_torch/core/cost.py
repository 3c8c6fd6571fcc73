"""Join-tree cost model (paper §V, Eq. 10/11).

Host copy of ``repro/core/cost.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .estimator import GraphStats, match_size_estimate, skeleton_size_estimate
from .pattern import Pattern

__all__ = ["storage_estimate", "CostModel"]


def storage_estimate(
    pattern: Pattern,
    cover: Sequence[int],
    ord_: Sequence[Tuple[int, int]],
    stats: GraphStats,
) -> float:
    vset = set(pattern.vertices)
    vc = [v for v in cover if v in vset]
    n_skel = len(vc)
    n_comp = pattern.n - n_skel
    skel = skeleton_size_estimate(pattern, cover, ord_, stats)
    full = match_size_estimate(pattern, ord_, stats)
    return n_skel * skel + n_comp * full


class CostModel:
    """Memoized S(·) + Eq. 11 combinator for the DP (Alg. 3)."""

    def __init__(self, cover: Sequence[int], ord_: Sequence[Tuple[int, int]], stats: GraphStats):
        self.cover = tuple(sorted(cover))
        self.ord_ = tuple(ord_)
        self.stats = stats
        self._s_cache: dict = {}

    def storage(self, pattern: Pattern) -> float:
        k = pattern.key()
        if k not in self._s_cache:
            self._s_cache[k] = storage_estimate(pattern, self.cover, self.ord_, self.stats)
        return self._s_cache[k]

    def leaf_cost(self, unit_pattern: Pattern) -> float:
        return self.storage(unit_pattern)

    def join_cost(self, parent: Pattern, left: Pattern, right: Pattern,
                  cost_left: float, cost_right: float) -> float:
        return (
            cost_left
            + cost_right
            + 5.0 * self.storage(left)
            + 5.0 * self.storage(right)
            + self.storage(parent)
        )
