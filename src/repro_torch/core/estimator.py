"""Power-Law-Random match-count estimator (paper §II-E, §IV-D, Eq. 8/9).

Host copy of ``repro/core/estimator.py`` (NumPy only).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

from .graph import Graph
from .pattern import Pattern, linear_extension_count

__all__ = ["GraphStats", "match_size_estimate", "skeleton_size_estimate"]


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Sufficient statistics of ``d`` for the estimator."""

    n: int
    m: int
    deg_hist: Tuple[int, ...]  # hist[w] = #vertices with degree w

    @staticmethod
    def of(graph: Graph) -> "GraphStats":
        return GraphStats(n=graph.n, m=graph.num_edges, deg_hist=tuple(int(x) for x in graph.degree_histogram()))

    def t_term(self, c: int) -> float:
        """``T(c) = Σ_{w ≥ c} w^c p_w`` over the empirical histogram."""
        hist = np.asarray(self.deg_hist, dtype=np.float64)
        w = np.arange(hist.shape[0], dtype=np.float64)
        if self.n == 0:
            return 0.0
        p_w = hist / float(self.n)
        lo = max(int(c), 1) if c > 0 else 0
        ws = w[lo:]
        with np.errstate(over="ignore"):
            val = float(np.sum(np.power(ws, float(c)) * p_w[lo:]))
        return val


def match_size_estimate(
    pattern: Pattern,
    ord_: Sequence[Tuple[int, int]],
    stats: GraphStats,
) -> float:
    """``E|M(p, d)|`` under the PR model + symmetry correction (Eq. 9)."""
    k = pattern.n
    if k == 0 or stats.m == 0:
        return 0.0
    rho = 1.0 / (2.0 * stats.m)
    log_eps = pattern.m * math.log(rho)
    for v in pattern.vertices:
        t = stats.t_term(pattern.degree(v))
        if t <= 0.0:
            return 0.0
        log_eps += math.log(t)
    # assignments = n! / (n-k)!
    if stats.n < k:
        return 0.0
    log_assign = sum(math.log(stats.n - i) for i in range(k))
    lec = linear_extension_count(pattern.vertices, ord_)
    log_sym = math.log(lec) - math.lgamma(k + 1)
    return math.exp(log_assign + log_eps + log_sym)


def skeleton_size_estimate(
    pattern: Pattern,
    cover: Sequence[int],
    ord_: Sequence[Tuple[int, int]],
    stats: GraphStats,
) -> float:
    """``E|M(p[V_c ∩ V(p)], d)|`` — skeleton-count bound used by Thm. 4.1.

    Isolated cover vertices (no cover-neighbor inside ``p``) contribute a
    degree-0 factor ``T(0) = 1`` and a plain assignment slot, matching the
    worst-case skeleton count.
    """
    vc = [v for v in cover if v in set(pattern.vertices)]
    induced = pattern.induced(vc)
    return match_size_estimate(induced, ord_, stats)
