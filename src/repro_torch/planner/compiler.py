"""Cover selection (paper §IV-F) and the choice of executor.

Host copy of ``choose_cover`` from ``repro/planner/compiler.py`` and
``r_lower`` from ``repro/core/vcbc.py``, and of the executor pass of
``compile_plan`` as :func:`choose_executor`; the rest of the staged
compiler is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

from ..core.estimator import GraphStats, match_size_estimate, skeleton_size_estimate
from ..core.pattern import Pattern, connected_vertex_covers, enumerate_r1_units
from ..core.plan import WcojPlan, build_wcoj_plan, wcoj_eligible
from .sizing import StoreCaps, wcoj_level_caps, wcoj_prefix_estimates

__all__ = ["choose_cover", "r_lower", "ExecutorChoice", "choose_executor"]

EXECUTORS = ("tree", "wcoj", "auto")


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


@dataclasses.dataclass(frozen=True)
class ExecutorChoice:
    """The executor pass's result: ``executor`` (``"tree"`` or ``"wcoj"``),
    the WCOJ plan and its compile-time level caps where it is ``"wcoj"``,
    the store caps and the cost the choice was made on."""

    executor: str
    wcoj: Optional[WcojPlan]
    level_caps: Optional[Tuple[int, ...]]
    store_caps: Optional[StoreCaps]
    cost: float


def choose_executor(pattern: Pattern, ord_: Sequence[Tuple[int, int]], stats: GraphStats,
                    tree_cost: float, executor: str = "tree", m: int = 1,
                    caps: Optional[Any] = None, store_caps: Optional[StoreCaps] = None,
                    store_headroom: float = 4.0) -> ExecutorChoice:
    """Copy of the executor pass of ``repro.planner.compiler.compile_plan``.

    ``"tree"`` keeps the join tree (``tree_cost``, ``store_caps``);
    ``"wcoj"`` takes the generic join and raises for a pattern with no
    vertex adjacent to all others; ``"auto"`` takes it for an eligible
    pattern whose summed WCOJ prefix estimates cost less than the tree.
    With ``caps`` a WCOJ choice gets its level caps (over ``m`` partitions,
    ``store_headroom``) and store caps ``StoreCaps(max(caps.group_cap,
    level_caps[-1]), 8)``: the store holds plain rows, whose sets are empty."""
    if executor not in EXECUTORS:
        raise ValueError(f"unknown executor {executor!r} (expected 'tree', 'wcoj' or 'auto')")
    tree = ExecutorChoice("tree", None, None, store_caps, tree_cost)
    if executor == "tree":
        return tree
    if not wcoj_eligible(pattern):
        if executor == "wcoj":
            raise ValueError("executor='wcoj' but pattern has no vertex adjacent to "
                             "all others (not WCOJ-eligible)")
        return tree
    wp = build_wcoj_plan(pattern, None, ord_)
    wcost = float(sum(wcoj_prefix_estimates(pattern, wp.order, ord_, stats)))
    if executor == "auto" and not wcost < tree_cost:
        return tree
    level_caps = None
    if caps is not None:
        level_caps = wcoj_level_caps(pattern, wp.order, ord_, stats, m, headroom=store_headroom)
        store_caps = StoreCaps(group_cap=max(caps.group_cap, level_caps[-1]), set_cap=8)
    return ExecutorChoice("wcoj", wp, level_caps, store_caps, wcost)
