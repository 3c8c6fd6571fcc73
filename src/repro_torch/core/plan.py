"""Backend-agnostic listing/join plan IR.

Host copy of ``repro/core/plan.py``: :class:`UnitPlan` (anchored frontier
listing of one R1 unit), :class:`WcojPlan` (anchored generic-join listing
of a whole pattern, with :func:`wcoj_anchors` and :func:`wcoj_eligible`)
and :class:`JoinPlan` (one CC-join), with the value-check modes
``NEQ``/``LT``/``GT``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from .pattern import Pattern

__all__ = [
    "ExtendStep",
    "UnitPlan",
    "build_unit_plan",
    "WcojLevel",
    "WcojPlan",
    "build_wcoj_plan",
    "wcoj_anchors",
    "wcoj_eligible",
    "ValueCheck",
    "CompVertexPlan",
    "JoinPlan",
    "plan_extension_order",
    "NEQ",
    "LT",
    "GT",
]

# Value-check modes: candidate value `x` against a skeleton column `s`.
NEQ = 0  # x != s   (injectivity)
LT = 1   # x <  s   (ord: candidate-vertex ≺ skeleton-vertex)
GT = 2   # x >  s   (ord: skeleton-vertex ≺ candidate-vertex)


def plan_extension_order(pattern: Pattern, start: int) -> List[int]:
    """Vertex matching order: ``start`` first, then greedy max-connectivity
    (ties: higher pattern degree, then lower label)."""
    order = [start]
    rest = [v for v in pattern.vertices if v != start]
    while rest:
        def score(v):
            conn = sum(1 for u in order if pattern.has_edge(u, v))
            return (conn, pattern.degree(v), -v)

        nxt = max(rest, key=score)
        if not any(pattern.has_edge(u, nxt) for u in order):
            raise ValueError("pattern must be connected for frontier listing")
        order.append(nxt)
        rest.remove(nxt)
    return order


@dataclasses.dataclass(frozen=True)
class ExtendStep:
    """One frontier extension: place ``vertex`` from the pivot's adjacency."""

    vertex: int
    pivot: int                                  # prefix column index to expand from
    edge_checks: Tuple[int, ...]                # prefix column indices needing an edge test
    ord_checks: Tuple[Tuple[int, bool], ...]    # (prefix col idx, candidate_must_be_greater)
    min_degree: int                             # MC₁ degree prune threshold


@dataclasses.dataclass(frozen=True)
class UnitPlan:
    """Listing plan of one anchored R1 unit (paper Alg. 1 substrate)."""

    pattern: Pattern
    anchor: int
    order: Tuple[int, ...]                      # extension order; order[0] == anchor
    steps: Tuple[ExtendStep, ...]               # len == |V| - 1
    edge_cols: Tuple[Tuple[int, int], ...]      # pattern edges as (col_i, col_j) pairs
    anchor_min_degree: int

    @property
    def cols(self) -> Tuple[int, ...]:
        """Column labels of the produced match table (== extension order)."""
        return self.order


def _ord_pairs_for(ord_: Sequence[Tuple[int, int]], new_v: int, placed: Sequence[int]):
    placed_idx = {u: j for j, u in enumerate(placed)}
    out = []
    for a, b in ord_:
        if a == new_v and b in placed_idx:
            out.append((placed_idx[b], False))   # f(new) < f(b)
        elif b == new_v and a in placed_idx:
            out.append((placed_idx[a], True))    # f(a) < f(new)
    return tuple(out)


def build_unit_plan(
    pattern: Pattern,
    anchor: int | None,
    ord_: Sequence[Tuple[int, int]] = (),
) -> UnitPlan:
    """Compile an anchored listing plan for ``pattern``.

    ``anchor`` seeds the frontier (for ``M_ac`` it must lie in the cover
    and be an R1 anchor); ``None`` falls back to the max-degree vertex.
    """
    if pattern.m == 0:
        raise ValueError("pattern needs ≥1 edge")
    start = anchor if anchor is not None else max(pattern.vertices, key=pattern.degree)
    order = plan_extension_order(pattern, start)
    steps = []
    for i in range(1, len(order)):
        v = order[i]
        placed = order[:i]
        nbr_cols = tuple(j for j, u in enumerate(placed) if pattern.has_edge(u, v))
        steps.append(ExtendStep(
            vertex=v,
            pivot=nbr_cols[0],
            edge_checks=nbr_cols[1:],
            ord_checks=_ord_pairs_for(ord_, v, placed),
            min_degree=pattern.degree(v),
        ))
    col_of = {u: j for j, u in enumerate(order)}
    edge_cols = tuple(sorted((col_of[a], col_of[b]) for a, b in pattern.edges))
    return UnitPlan(
        pattern=pattern, anchor=start, order=tuple(order), steps=tuple(steps),
        edge_cols=edge_cols, anchor_min_degree=pattern.degree(start),
    )


# ---------------------------------------------------------------------------
# Worst-case-optimal (generic-join) plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WcojLevel:
    """One generic-join extension level: candidates for ``vertex`` are the
    intersection of the adjacency lists of every placed neighbor. ``pivot``
    enumerates (the seed adjacency list); ``intersect_cols`` constrain via
    set membership."""

    vertex: int
    pivot: int                                  # prefix column whose adjacency seeds candidates
    intersect_cols: Tuple[int, ...]             # prefix columns intersected against
    ord_checks: Tuple[Tuple[int, bool], ...]    # (prefix col idx, candidate_must_be_greater)
    min_degree: int                             # MC₁ degree prune threshold


@dataclasses.dataclass(frozen=True)
class WcojPlan:
    """Attribute-at-a-time generic-join plan over a whole pattern.

    Unlike :class:`UnitPlan` (one R1 unit of a decomposition, later CC-
    joined), a WCOJ plan lists the full pattern in one anchored pass:
    each level is a multiway adjacency intersection, so intermediate
    table sizes are bounded per level (AGM-style) instead of per binary
    join. Only R1-anchored patterns qualify (:func:`wcoj_eligible`) —
    the anchor adjacent to every other vertex makes per-partition
    center-anchored listing complete, exactly as for unit plans."""

    pattern: Pattern
    anchor: int
    order: Tuple[int, ...]                      # extension order; order[0] == anchor
    levels: Tuple[WcojLevel, ...]               # len == |V| - 1
    edge_cols: Tuple[Tuple[int, int], ...]      # pattern edges as (col_i, col_j) pairs
    anchor_min_degree: int

    @property
    def cols(self) -> Tuple[int, ...]:
        """Column labels of the produced match table (== extension order)."""
        return self.order


def wcoj_anchors(pattern: Pattern) -> Tuple[int, ...]:
    """Vertices adjacent to every other pattern vertex (R1 anchors of the
    whole pattern): valid WCOJ seeds for partition-complete listing."""
    vset = set(pattern.vertices)
    return tuple(v for v in pattern.vertices
                 if set(pattern.neighbors(v)) | {v} == vset)


def wcoj_eligible(pattern: Pattern) -> bool:
    """True iff the whole pattern admits an anchored generic-join plan."""
    return pattern.m > 0 and bool(wcoj_anchors(pattern))


def build_wcoj_plan(
    pattern: Pattern,
    anchor: int | None = None,
    ord_: Sequence[Tuple[int, int]] = (),
) -> WcojPlan:
    """Compile a generic-join plan for ``pattern``.

    ``anchor`` must be adjacent to all other vertices; ``None`` picks the
    max-degree such vertex. The extension order is the same greedy
    max-connectivity order as frontier listing, so on cliques every
    level intersects against the whole prefix."""
    anchors = wcoj_anchors(pattern)
    if not anchors:
        raise ValueError("pattern has no vertex adjacent to all others; "
                         "not WCOJ-eligible")
    if anchor is None:
        anchor = max(anchors, key=pattern.degree)
    elif anchor not in anchors:
        raise ValueError(f"anchor {anchor} is not adjacent to all other vertices")
    order = plan_extension_order(pattern, anchor)
    levels = []
    for i in range(1, len(order)):
        v = order[i]
        placed = order[:i]
        nbr_cols = tuple(j for j, u in enumerate(placed) if pattern.has_edge(u, v))
        levels.append(WcojLevel(
            vertex=v,
            pivot=nbr_cols[0],
            intersect_cols=nbr_cols[1:],
            ord_checks=_ord_pairs_for(ord_, v, placed),
            min_degree=pattern.degree(v),
        ))
    col_of = {u: j for j, u in enumerate(order)}
    edge_cols = tuple(sorted((col_of[a], col_of[b]) for a, b in pattern.edges))
    return WcojPlan(
        pattern=pattern, anchor=anchor, order=tuple(order),
        levels=tuple(levels), edge_cols=edge_cols,
        anchor_min_degree=pattern.degree(anchor),
    )


# ---------------------------------------------------------------------------
# CC-join plans (paper Alg. 2)
# ---------------------------------------------------------------------------

ValueCheck = Tuple[int, int]  # (output-skeleton column index, mode NEQ/LT/GT)


@dataclasses.dataclass(frozen=True)
class CompVertexPlan:
    """How one compressed vertex of the joined pattern is produced."""

    vertex: int
    source: str                     # 'both' | 'left' | 'right'
    checks: Tuple[ValueCheck, ...]  # validity of each value vs the new skeleton


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    """Static description of one CC-join ``p3 = p1 ∪ p2`` under a cover."""

    pattern: Pattern                              # p3
    left_skel: Tuple[int, ...]                    # sorted(cover ∩ V(p1))
    right_skel: Tuple[int, ...]
    key_cols: Tuple[int, ...]                     # sorted(left_skel ∩ right_skel)
    skel_out: Tuple[int, ...]                     # sorted(left_skel ∪ right_skel)
    only_left: Tuple[int, ...]                    # skeleton cols exclusive to p1
    only_right: Tuple[int, ...]
    key_left_idx: Tuple[int, ...]                 # key cols as indices into left_skel
    key_right_idx: Tuple[int, ...]
    out_from_left: Tuple[Tuple[int, int], ...]    # (out idx, left idx)
    out_from_right: Tuple[Tuple[int, int], ...]   # (out idx, right idx) for only_right
    pair_neq: Tuple[Tuple[int, int], ...]         # cross-side injectivity (out idx pairs)
    pair_ord: Tuple[Tuple[int, int], ...]         # cross-side ord: s3[a] < s3[b]
    comp: Tuple[CompVertexPlan, ...]              # sorted by vertex label

    @staticmethod
    def make(
        p1: Pattern,
        p2: Pattern,
        cover: Sequence[int],
        ord_: Sequence[Tuple[int, int]] = (),
    ) -> "JoinPlan":
        cover_set = set(cover)
        v1, v2 = set(p1.vertices), set(p2.vertices)
        s1 = tuple(c for c in sorted(cover_set & v1))
        s2 = tuple(c for c in sorted(cover_set & v2))
        key = tuple(sorted(set(s1) & set(s2)))
        s3 = tuple(sorted(set(s1) | set(s2)))
        only1 = tuple(c for c in s1 if c not in s2)
        only2 = tuple(c for c in s2 if c not in s1)
        j1 = {c: j for j, c in enumerate(s1)}
        j2 = {c: j for j, c in enumerate(s2)}
        j3 = {c: j for j, c in enumerate(s3)}

        out_from_left = tuple((j3[c], j1[c]) for c in s1)
        out_from_right = tuple((j3[c], j2[c]) for c in only2)
        pair_neq = tuple((j3[a], j3[b]) for a in only1 for b in only2)
        pair_ord = tuple(
            (j3[a], j3[b]) for a, b in ord_
            if a in j3 and b in j3 and not ((a in j1 and b in j1) or (a in j2 and b in j2))
        )

        def checks_for(v: int, cols: Sequence[int]) -> Tuple[ValueCheck, ...]:
            out: List[ValueCheck] = []
            for c in cols:
                out.append((j3[c], NEQ))
                for a, b in ord_:
                    if (a, b) == (v, c):
                        out.append((j3[c], LT))
                    elif (a, b) == (c, v):
                        out.append((j3[c], GT))
            return tuple(out)

        comp_plans: List[CompVertexPlan] = []
        for v in sorted((v1 | v2) - set(s3)):
            in1, in2 = v in v1, v in v2
            if in1 and in2:
                comp_plans.append(CompVertexPlan(v, "both", checks_for(v, only2 + only1)))
            elif in1:
                comp_plans.append(CompVertexPlan(v, "left", checks_for(v, only2)))
            else:
                comp_plans.append(CompVertexPlan(v, "right", checks_for(v, only1)))

        return JoinPlan(
            pattern=p1.union(p2),
            left_skel=s1, right_skel=s2, key_cols=key, skel_out=s3,
            only_left=only1, only_right=only2,
            key_left_idx=tuple(j1[c] for c in key),
            key_right_idx=tuple(j2[c] for c in key),
            out_from_left=out_from_left, out_from_right=out_from_right,
            pair_neq=pair_neq, pair_ord=pair_ord, comp=tuple(comp_plans),
        )
