"""Pattern graphs, symmetry breaking, vertex covers and R1 units.

Host copy of ``repro/core/pattern.py`` (pure Python): the SimB order,
connected vertex covers and R1 units the planner needs, and
``PATTERN_LIBRARY``.
"""

from __future__ import annotations

import dataclasses
import itertools
from functools import lru_cache
from typing import Dict, FrozenSet, Iterable, List, Sequence, Tuple

__all__ = [
    "Pattern",
    "automorphisms",
    "symmetry_break",
    "linear_extension_count",
    "vertex_covers",
    "connected_vertex_covers",
    "R1Unit",
    "enumerate_r1_units",
    "PATTERN_LIBRARY",
]

Edge = Tuple[int, int]


def _norm_edge(e: Sequence[int]) -> Edge:
    a, b = int(e[0]), int(e[1])
    if a == b:
        raise ValueError(f"self loop {e}")
    return (a, b) if a < b else (b, a)


@dataclasses.dataclass(frozen=True)
class Pattern:
    """An undirected pattern graph over explicit vertex labels."""

    vertices: Tuple[int, ...]
    edges: FrozenSet[Edge]

    @staticmethod
    def make(edges: Iterable[Sequence[int]], vertices: Iterable[int] | None = None) -> "Pattern":
        es = frozenset(_norm_edge(e) for e in edges)
        vs = set(vertices) if vertices is not None else set()
        for a, b in es:
            vs.add(a)
            vs.add(b)
        return Pattern(vertices=tuple(sorted(vs)), edges=es)

    # ------------------------------------------------------------------ views
    @property
    def n(self) -> int:
        return len(self.vertices)

    @property
    def m(self) -> int:
        return len(self.edges)

    def key(self) -> Tuple[Tuple[int, ...], Tuple[Edge, ...]]:
        return (self.vertices, tuple(sorted(self.edges)))

    def neighbors(self, v: int) -> Tuple[int, ...]:
        out = [b if a == v else a for a, b in self.edges if v in (a, b)]
        return tuple(sorted(out))

    def degree(self, v: int) -> int:
        return len(self.neighbors(v))

    def has_edge(self, a: int, b: int) -> bool:
        return _norm_edge((a, b)) in self.edges

    def adjacency(self) -> Dict[int, Tuple[int, ...]]:
        return {v: self.neighbors(v) for v in self.vertices}

    # ------------------------------------------------------------ operations
    def union(self, other: "Pattern") -> "Pattern":
        return Pattern(
            vertices=tuple(sorted(set(self.vertices) | set(other.vertices))),
            edges=self.edges | other.edges,
        )

    def induced(self, vs: Iterable[int]) -> "Pattern":
        vset = set(vs)
        return Pattern(
            vertices=tuple(sorted(vset)),
            edges=frozenset(e for e in self.edges if e[0] in vset and e[1] in vset),
        )

    def is_connected(self) -> bool:
        if not self.vertices:
            return True
        adj = self.adjacency()
        seen = {self.vertices[0]}
        stack = [self.vertices[0]]
        while stack:
            v = stack.pop()
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return len(seen) == len(self.vertices)

    def is_subpattern_of(self, other: "Pattern") -> bool:
        return set(self.vertices) <= set(other.vertices) and self.edges <= other.edges

    def __repr__(self) -> str:  # pragma: no cover
        return f"Pattern(V={list(self.vertices)}, E={sorted(self.edges)})"


# ---------------------------------------------------------------------------
# Automorphisms and symmetry breaking
# ---------------------------------------------------------------------------

def automorphisms(p: Pattern) -> List[Dict[int, int]]:
    """All automorphisms of ``p`` (brute force with degree pruning; |V| ≤ 10)."""
    vs = list(p.vertices)
    deg = {v: p.degree(v) for v in vs}
    # Group vertices by degree to prune the permutation search.
    by_deg: Dict[int, List[int]] = {}
    for v in vs:
        by_deg.setdefault(deg[v], []).append(v)

    autos: List[Dict[int, int]] = []

    def backtrack(i: int, mapping: Dict[int, int], used: set) -> None:
        if i == len(vs):
            autos.append(dict(mapping))
            return
        v = vs[i]
        for w in by_deg[deg[v]]:
            if w in used:
                continue
            ok = True
            for u in vs[:i]:
                if p.has_edge(v, u) != p.has_edge(w, mapping[u]):
                    ok = False
                    break
            if ok:
                mapping[v] = w
                used.add(w)
                backtrack(i + 1, mapping, used)
                used.discard(w)
                del mapping[v]

    backtrack(0, {}, set())
    return autos


def symmetry_break(p: Pattern) -> Tuple[Tuple[int, int], ...]:
    """Compute the SimB partial order ``ord`` = tuple of (a, b) meaning a ≺ b.

    Guarantees exactly one ord-valid match per subgraph instance of ``p``.
    """
    conditions: List[Tuple[int, int]] = []
    group = automorphisms(p)
    while len(group) > 1:
        # Orbit sizes under the current stabilizer subgroup.
        orbits: Dict[int, set] = {}
        for v in p.vertices:
            orbits[v] = {g[v] for g in group}
        v = max(p.vertices, key=lambda x: (len(orbits[x]), -x))
        for u in sorted(orbits[v]):
            if u != v:
                conditions.append((v, u))
        group = [g for g in group if g[v] == v]
    return tuple(conditions)


def _restrict_ord(ord_: Sequence[Tuple[int, int]], vs: Iterable[int]) -> Tuple[Tuple[int, int], ...]:
    vset = set(vs)
    return tuple((a, b) for a, b in ord_ if a in vset and b in vset)


@lru_cache(maxsize=4096)
def _lec_cached(n: int, rel: Tuple[Tuple[int, int], ...]) -> int:
    # Subset DP over linear extensions of a partial order on n elements.
    preds = [0] * n
    for a, b in rel:
        preds[b] |= 1 << a
    full = (1 << n) - 1
    dp = [0] * (1 << n)
    dp[0] = 1
    for mask in range(1 << n):
        if not dp[mask]:
            continue
        for x in range(n):
            bit = 1 << x
            if mask & bit:
                continue
            if preds[x] & ~mask:
                continue
            dp[mask | bit] += dp[mask]
    return dp[full]


def linear_extension_count(vertices: Sequence[int], ord_: Sequence[Tuple[int, int]]) -> int:
    """#linear extensions of ``ord_`` restricted to ``vertices``.

    The estimator's symmetry correction is ``L(ord|_q) / |V(q)|!`` — for a
    SimB-complete order on ``p`` this equals ``1 / |Aut(p)|`` (the paper's
    ``|Auto(p, ord)| / |Auto(p, ∅)|`` term), and it generalizes smoothly to
    subpatterns whose automorphisms are only partially broken.
    """
    vs = sorted(set(vertices))
    idx = {v: i for i, v in enumerate(vs)}
    rel = tuple(sorted((idx[a], idx[b]) for a, b in _restrict_ord(ord_, vs)))
    return _lec_cached(len(vs), rel)


# ---------------------------------------------------------------------------
# Vertex covers
# ---------------------------------------------------------------------------

def vertex_covers(p: Pattern) -> List[Tuple[int, ...]]:
    """All vertex covers of ``p`` (inclusion-ordered, |V| ≤ 10 ⇒ ≤ 1024 subsets)."""
    vs = list(p.vertices)
    covers = []
    for r in range(len(vs) + 1):
        for sub in itertools.combinations(vs, r):
            sset = set(sub)
            if all(a in sset or b in sset for a, b in p.edges):
                covers.append(tuple(sub))
    return covers


def connected_vertex_covers(p: Pattern) -> List[Tuple[int, ...]]:
    """Vertex covers whose induced subgraph ``p[V_c]`` is connected (Lemma 4.2)."""
    return [c for c in vertex_covers(p) if c and p.induced(c).is_connected()]


# ---------------------------------------------------------------------------
# R1 units (paper §III-A)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class R1Unit:
    """A radius-1 join unit: ``anchor`` is adjacent to every other vertex."""

    pattern: Pattern
    anchors: Tuple[int, ...]  # every vertex adjacent to all others

    @property
    def anchor(self) -> int:
        return self.anchors[0]

    def anchor_in(self, vc: Iterable[int]) -> int | None:
        """Return an anchor contained in ``vc`` (CC condition 3) or None."""
        vset = set(vc)
        for a in self.anchors:
            if a in vset:
                return a
        return None


def _unit_anchors(p: Pattern) -> Tuple[int, ...]:
    out = []
    vset = set(p.vertices)
    for v in p.vertices:
        if set(p.neighbors(v)) | {v} == vset:
            out.append(v)
    return tuple(out)


def enumerate_r1_units(p: Pattern, max_size: int | None = None) -> List[R1Unit]:
    """All R1 units inside ``p``: induced subgraphs ``p[{v} ∪ S]``, S ⊆ N(v).

    Induced subgraphs carry the maximum number of ``p``-edges, which makes
    them maximally selective join units; their union still only needs to
    cover ``E(p)``.
    """
    seen: Dict[Tuple, R1Unit] = {}
    for v in p.vertices:
        nb = p.neighbors(v)
        limit = len(nb) if max_size is None else min(len(nb), max_size - 1)
        for r in range(1, limit + 1):
            for sub in itertools.combinations(nb, r):
                q = p.induced((v,) + sub)
                anchors = _unit_anchors(q)
                if not anchors:
                    continue
                k = q.key()
                if k not in seen:
                    seen[k] = R1Unit(pattern=q, anchors=anchors)
    return list(seen.values())


# ---------------------------------------------------------------------------
# The paper's five benchmark patterns (Fig. 5): square, triangle,
# square-with-diagonal ("house base"), 4-clique, and the 5-vertex "house".
# Exact shapes follow the common choices of [11], [8], [12].
# ---------------------------------------------------------------------------

PATTERN_LIBRARY: Dict[str, Pattern] = {
    # q1: 4-cycle (square)
    "q1_square": Pattern.make([(0, 1), (1, 2), (2, 3), (3, 0)]),
    # q2: triangle
    "q2_triangle": Pattern.make([(0, 1), (1, 2), (2, 0)]),
    # q3: 4-cycle with one diagonal
    "q3_diamond": Pattern.make([(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)]),
    # q4: 4-clique
    "q4_clique4": Pattern.make([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]),
    # q5: house — 4-cycle + roof triangle
    "q5_house": Pattern.make([(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (1, 4)]),
    # q6: 5-clique — the dense pattern where the WCOJ executor mode wins
    "q6_clique5": Pattern.make([(a, b) for a in range(5) for b in range(a + 1, 5)]),
}
