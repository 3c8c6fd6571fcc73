"""Cover selection (paper §IV-F, optimal connected compression).

Host copy of ``choose_cover`` from ``repro/planner/compiler.py`` and
``r_lower`` from ``repro/core/vcbc.py``; the rest of the staged compiler is
not ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from ..core.estimator import GraphStats, match_size_estimate, skeleton_size_estimate
from ..core.pattern import Pattern, connected_vertex_covers, enumerate_r1_units

__all__ = ["choose_cover", "r_lower"]


def r_lower(n_pattern: int, n_cover: int, m_pattern: float, m_cover: float) -> float:
    """Copy of ``repro.core.vcbc.r_lower``: ``R_lower`` of Thm. 4.1."""
    num = n_pattern * m_pattern
    den = n_pattern * m_pattern + n_cover * max(m_cover - m_pattern, 0.0)
    return float(num / den) if den > 0 else 1.0


def choose_cover(
    pattern: Pattern,
    ord_: Sequence[Tuple[int, int]],
    stats: GraphStats,
) -> Tuple[int, ...]:
    """Copy of ``repro.planner.compiler.choose_cover``: maximize R_lower over
    connected covers that admit a cover-anchored R1 decomposition."""
    best, best_r = None, -1.0
    full = match_size_estimate(pattern, ord_, stats)
    units = enumerate_r1_units(pattern)
    for vc in connected_vertex_covers(pattern):
        vcs = set(vc)
        anchored = [u for u in units if u.anchor_in(vcs) is not None]
        covered = frozenset().union(*[u.pattern.edges for u in anchored]) if anchored else frozenset()
        if covered != pattern.edges:
            continue
        skel = skeleton_size_estimate(pattern, vc, ord_, stats)
        r = r_lower(pattern.n, len(vc), full, skel)
        if r > best_r or (r == best_r and best is not None and len(vc) < len(best)):
            best, best_r = vc, r
    if best is None:
        raise ValueError("no connected cover admits an anchored R1 decomposition")
    return best
