"""Join-tree → plan-IR lowering.

Host copy of ``repro/planner/lowering.py``: :class:`TreeNode`,
:class:`TreeProgram` and :func:`build_tree_program`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..core.join_tree import JoinTree
from ..core.pattern import Pattern
from ..core.plan import JoinPlan, UnitPlan, build_unit_plan

__all__ = ["TreeNode", "TreeProgram", "build_tree_program"]


@dataclasses.dataclass(frozen=True)
class TreeNode:
    """One node of a compiled join-tree program (leaf or join)."""

    pattern: Pattern
    skel_cols: Tuple[int, ...]
    unit_plan: Optional[UnitPlan] = None
    join_plan: Optional[JoinPlan] = None
    left: int = -1
    right: int = -1


@dataclasses.dataclass(frozen=True)
class TreeProgram:
    """Post-order node list; ``nodes[root]`` is the full pattern."""

    nodes: Tuple[TreeNode, ...]
    root: int
    cover: Tuple[int, ...]
    ord: Tuple[Tuple[int, int], ...]


def build_tree_program(
    tree: JoinTree,
    cover: Sequence[int],
    ord_: Sequence[Tuple[int, int]],
) -> TreeProgram:
    """Compile an optimal join tree into plan-IR nodes."""
    cover = tuple(sorted(int(c) for c in cover))
    ord_t = tuple((int(a), int(b)) for a, b in ord_)
    nodes: List[TreeNode] = []

    def rec(jt: JoinTree) -> int:
        if jt.is_leaf:
            anchor = jt.unit.anchor_in(cover)
            if anchor is None:
                raise ValueError("unit anchor must lie inside the cover")
            up = build_unit_plan(jt.unit.pattern, anchor, ord_t)
            skel = tuple(c for c in cover if c in set(jt.pattern.vertices))
            nodes.append(TreeNode(pattern=jt.pattern, skel_cols=skel, unit_plan=up))
            return len(nodes) - 1
        li = rec(jt.left)
        ri = rec(jt.right)
        jp = JoinPlan.make(jt.left.pattern, jt.right.pattern, cover, ord_t)
        if not jp.key_cols:
            raise ValueError("CC-join requires a non-empty cover join key (Lemma 4.2)")
        nodes.append(TreeNode(pattern=jt.pattern, skel_cols=jp.skel_out,
                              join_plan=jp, left=li, right=ri))
        return len(nodes) - 1

    root = rec(tree)
    return TreeProgram(nodes=tuple(nodes), root=root, cover=cover, ord=ord_t)
