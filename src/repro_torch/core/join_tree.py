"""Optimal join tree (paper Alg. 3) and minimum unit decomposition.

Host copy of ``repro/core/join_tree.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from .cost import CostModel
from .pattern import Pattern, R1Unit, enumerate_r1_units

__all__ = ["JoinTree", "optimal_join_tree", "minimum_unit_decomposition"]


@dataclasses.dataclass
class JoinTree:
    pattern: Pattern
    cost: float
    unit: Optional[R1Unit] = None            # set on leaves
    left: Optional["JoinTree"] = None
    right: Optional["JoinTree"] = None

    @property
    def is_leaf(self) -> bool:
        return self.unit is not None

    def leaves(self) -> List[R1Unit]:
        if self.is_leaf:
            return [self.unit]
        return self.left.leaves() + self.right.leaves()

    def internal_nodes(self) -> List[Pattern]:
        if self.is_leaf:
            return []
        return self.left.internal_nodes() + self.right.internal_nodes() + [self.pattern]

    def depth(self) -> int:
        if self.is_leaf:
            return 1
        return 1 + max(self.left.depth(), self.right.depth())

    def describe(self, indent: int = 0) -> str:
        pad = "  " * indent
        if self.is_leaf:
            return f"{pad}unit V={list(self.pattern.vertices)} anchor={self.unit.anchor} cost={self.cost:.3g}"
        out = f"{pad}join V={list(self.pattern.vertices)} |E|={self.pattern.m} cost={self.cost:.3g}\n"
        out += self.left.describe(indent + 1) + "\n"
        out += self.right.describe(indent + 1)
        return out


@dataclasses.dataclass
class _Entry:
    cost: float
    unit: Optional[R1Unit]
    left: Optional[Tuple]
    right: Optional[Tuple]


def optimal_join_tree(
    p: Pattern,
    cover: Sequence[int],
    model: CostModel,
    max_unit_size: int | None = None,
) -> JoinTree:
    """Alg. 3 — returns the minimum-estimated-cost join tree for ``p``.

    Departs from ``repro/core/join_tree.py`` in one place, for host time
    only: a candidate union's edge count is checked before its ``Pattern``
    is built, and each pattern's vertex set is kept as a frozenset. The
    union built is ``pa.union(pb)`` field for field, so the candidates, their
    order and the trees are JAX's; K5's search takes a fraction of the time.
    """
    vc = set(cover)
    units = [u for u in enumerate_r1_units(p, max_size=max_unit_size) if u.anchor_in(vc) is not None]
    if not units:
        raise ValueError("no R1 unit has an anchor inside the cover; pick another cover")

    best: Dict[Tuple, _Entry] = {}
    by_edges: Dict[int, List[Tuple]] = {}

    def consider(key: Tuple, entry: _Entry) -> None:
        cur = best.get(key)
        if cur is None or entry.cost < cur.cost:
            best[key] = entry

    unit_by_key = {}
    for u in units:
        unit_by_key.setdefault(u.pattern.key(), u)

    patterns: Dict[Tuple, Pattern] = {u.pattern.key(): u.pattern for u in units}
    vsets = {k: frozenset(q.vertices) for k, q in patterns.items()}
    target = p.key()
    max_edges = p.m

    finalized: Dict[Tuple, _Entry] = {}
    for r in range(1, max_edges + 1):
        # (a) units with exactly r edges
        for key, u in unit_by_key.items():
            if patterns[key].m == r:
                consider(key, _Entry(cost=model.leaf_cost(patterns[key]), unit=u, left=None, right=None))
        # (b) unions of finalized pairs with exactly r edges
        fin_keys = list(finalized.keys())
        for ka, kb in itertools.combinations_with_replacement(fin_keys, 2):
            if ka == kb:
                continue
            va, vb = vsets[ka], vsets[kb]
            if not (va & vb & vc):
                continue
            pa, pb = patterns[ka], patterns[kb]
            eu = pa.edges | pb.edges
            if len(eu) != r:
                continue
            pu = Pattern(vertices=tuple(sorted(va | vb)), edges=eu)   # pa.union(pb)
            ku = pu.key()
            if ku == ka or ku == kb:
                continue
            if ku not in patterns:
                patterns[ku] = pu
                vsets[ku] = va | vb
            cost = model.join_cost(pu, pa, pb, finalized[ka].cost, finalized[kb].cost)
            consider(ku, _Entry(cost=cost, unit=None, left=ka, right=kb))
        # finalize everything with exactly r edges
        for key, entry in list(best.items()):
            if patterns[key].m == r and key not in finalized:
                finalized[key] = entry
                by_edges.setdefault(r, []).append(key)
            elif patterns[key].m == r and entry.cost < finalized[key].cost:
                finalized[key] = entry

    if target not in finalized:
        raise ValueError("pattern is not coverable by R1 units under this cover")

    def build(key: Tuple) -> JoinTree:
        e = finalized[key]
        if e.unit is not None:
            return JoinTree(pattern=patterns[key], cost=e.cost, unit=e.unit)
        return JoinTree(
            pattern=patterns[key], cost=e.cost,
            left=build(e.left), right=build(e.right),
        )

    return build(target)


# ---------------------------------------------------------------------------
# Minimum-cardinality unit decomposition for Nav-join left-deep trees (§VI-B:
# "the optimal left-deep tree is the one involving the minimum number of join
# units"), with the join-key connectivity constraint at every prefix.
# ---------------------------------------------------------------------------

def minimum_unit_decomposition(
    p: Pattern,
    cover: Sequence[int],
    max_unit_size: int | None = None,
) -> List[R1Unit]:
    vc = set(cover)
    units = [u for u in enumerate_r1_units(p, max_size=max_unit_size) if u.anchor_in(vc) is not None]
    # Prefer large units (they cover more edges); exact search over subset
    # sizes — pattern edge counts are tiny.
    units.sort(key=lambda u: -u.pattern.m)
    all_edges = p.edges
    for k in range(1, len(units) + 1):
        for combo in itertools.combinations(units, k):
            covered = frozenset().union(*[u.pattern.edges for u in combo]) if combo else frozenset()
            if covered != all_edges:
                continue
            ordered = _orderable(list(combo), vc)
            if ordered is not None:
                return ordered
    raise ValueError("pattern cannot be decomposed into cover-anchored R1 units")


def _orderable(units: List[R1Unit], vc: set) -> List[R1Unit] | None:
    """Order units so every prefix-join has a non-empty cover join key."""
    for first in units:
        order = [first]
        rest = [u for u in units if u is not first]
        placed = set(first.pattern.vertices)
        ok = True
        while rest:
            nxt = None
            for u in rest:
                if set(u.pattern.vertices) & placed & vc:
                    nxt = u
                    break
            if nxt is None:
                ok = False
                break
            order.append(nxt)
            placed |= set(nxt.pattern.vertices)
            rest.remove(nxt)
        if ok:
            return order
    return None
