"""Staged plan compiler: (pattern, live stats, machine shape) → CompiledPlan.

Host copy of ``repro/planner/compiler.py``, whole: :class:`CompileContext`,
:class:`PassReport`, :class:`CompiledPlan`, :func:`compile_plan`,
:func:`candidate_covers`, :func:`tree_key` and :func:`choose_cover`. The
executor pass of :func:`compile_plan` is :func:`choose_executor`, which
callers that hold a join tree already may call alone. The passes, each
recorded as a :class:`PassReport`::

    symmetry   SimB total order (ord)
    cover      optimal connected compression (§IV-F, R_lower argmax)
    decompose  minimum Nav-join unit decomposition (§VI-B)
    tree       optimal join tree DP (Alg. 3, Eq. 10/11 cost)
    lower      UnitPlan/JoinPlan IR (TreeProgram)
    size       match_caps / unit_table_caps from the §IV-D estimators
    shard      full-skeleton owner-hash placement descriptor
    executor   join tree or generic join (WCOJ), unless executor="tree"

Every pass is a pure function of the context, so two compiles from the
same stats give equal plans.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.cost import CostModel
from ..core.estimator import GraphStats, match_size_estimate, skeleton_size_estimate
from ..core.join_tree import JoinTree, minimum_unit_decomposition, optimal_join_tree
from ..core.pattern import (Pattern, R1Unit, connected_vertex_covers, enumerate_r1_units,
                            symmetry_break)
from ..core.plan import WcojPlan, build_wcoj_plan, wcoj_eligible
from ..core.vcbc import r_lower
from .lowering import TreeProgram, build_tree_program
from .sizing import (ShardingSpec, StoreCaps, match_caps, unit_table_caps, wcoj_level_caps,
                     wcoj_prefix_estimates)

__all__ = ["CompileContext", "PassReport", "CompiledPlan", "compile_plan", "choose_cover",
           "candidate_covers", "tree_key", "r_lower", "ExecutorChoice", "choose_executor"]

EXECUTORS = ("tree", "wcoj", "auto")


def _anchored_covers(pattern: Pattern):
    """Connected covers admitting a cover-anchored R1 decomposition."""
    units = enumerate_r1_units(pattern)
    for vc in connected_vertex_covers(pattern):
        vcs = set(vc)
        anchored = [u for u in units if u.anchor_in(vcs) is not None]
        covered = frozenset().union(*[u.pattern.edges for u in anchored]) if anchored else frozenset()
        if covered == pattern.edges:
            yield vc


def choose_cover(
    pattern: Pattern,
    ord_: Sequence[Tuple[int, int]],
    stats: GraphStats,
) -> Tuple[int, ...]:
    """Optimal connected compression: maximize R_lower over connected covers
    that admit a cover-anchored R1 decomposition."""
    best, best_r = None, -1.0
    full = match_size_estimate(pattern, ord_, stats)
    for vc in _anchored_covers(pattern):
        skel = skeleton_size_estimate(pattern, vc, ord_, stats)
        r = r_lower(pattern.n, len(vc), full, skel)
        if r > best_r or (r == best_r and best is not None and len(vc) < len(best)):
            best, best_r = vc, r
    if best is None:
        raise ValueError("no connected cover admits an anchored R1 decomposition")
    return best


def candidate_covers(pattern: Pattern) -> List[Tuple[int, ...]]:
    """Every cover the compiler may legally pick (the feasibility filter of
    :func:`choose_cover`, before its R_lower argmax)."""
    return [tuple(sorted(int(c) for c in vc)) for vc in _anchored_covers(pattern)]


def tree_key(tree: JoinTree) -> Tuple:
    """Canonical hashable identity of a join tree's *shape* (the order of a
    join's children does not matter, so they compare unordered)."""
    if tree.is_leaf:
        return ("leaf", tree.pattern.key(), tree.unit.anchor)
    return ("join", tree.pattern.key(),
            frozenset((tree_key(tree.left), tree_key(tree.right))))


@dataclasses.dataclass(frozen=True)
class ExecutorChoice:
    """The executor pass's result: ``executor`` (``"tree"`` or ``"wcoj"``),
    the WCOJ plan and its compile-time level caps where it is ``"wcoj"``,
    the store caps and the cost the choice was made on. ``wcoj_cost`` is the
    summed WCOJ prefix estimate it was held against (None where the pattern
    is not WCOJ-eligible or the executor is ``"tree"``)."""

    executor: str
    wcoj: Optional[WcojPlan]
    level_caps: Optional[Tuple[int, ...]]
    store_caps: Optional[StoreCaps]
    cost: float
    wcoj_cost: Optional[float] = None


def choose_executor(pattern: Pattern, ord_: Sequence[Tuple[int, int]], stats: GraphStats,
                    tree_cost: float, executor: str = "tree", m: int = 1,
                    caps: Optional[Any] = None, store_caps: Optional[StoreCaps] = None,
                    store_headroom: float = 4.0) -> ExecutorChoice:
    """The executor pass of :func:`compile_plan`.

    ``"tree"`` keeps the join tree (``tree_cost``, ``store_caps``);
    ``"wcoj"`` takes the generic join and raises for a pattern with no
    vertex adjacent to all others; ``"auto"`` takes it for an eligible
    pattern whose summed WCOJ prefix estimates cost less than the tree.
    With ``caps`` a WCOJ choice gets its level caps (over ``m`` partitions,
    ``store_headroom``) and store caps ``StoreCaps(max(caps.group_cap,
    level_caps[-1]), 8)``: the store holds plain rows, whose sets are empty."""
    if executor not in EXECUTORS:
        raise ValueError(f"unknown executor {executor!r} (expected 'tree', 'wcoj' or 'auto')")
    if executor == "tree":
        return ExecutorChoice("tree", None, None, store_caps, tree_cost)
    if not wcoj_eligible(pattern):
        if executor == "wcoj":
            raise ValueError("executor='wcoj' but pattern has no vertex adjacent to "
                             "all others (not WCOJ-eligible)")
        return ExecutorChoice("tree", None, None, store_caps, tree_cost)
    wp = build_wcoj_plan(pattern, None, ord_)
    wcost = float(sum(wcoj_prefix_estimates(pattern, wp.order, ord_, stats)))
    if executor == "auto" and not wcost < tree_cost:
        return ExecutorChoice("tree", None, None, store_caps, tree_cost, wcost)
    level_caps = None
    if caps is not None:
        level_caps = wcoj_level_caps(pattern, wp.order, ord_, stats, m, headroom=store_headroom)
        store_caps = StoreCaps(group_cap=max(caps.group_cap, level_caps[-1]), set_cap=8)
    return ExecutorChoice("wcoj", wp, level_caps, store_caps, wcost, wcost)


@dataclasses.dataclass(frozen=True)
class CompileContext:
    """Everything a compile reads: the pattern, the live graph statistics,
    the machine. ``caps`` needs ``group_cap`` / ``set_cap`` (an
    :class:`~repro_torch.engine.EngineCaps` in practice); ``None`` skips
    the size and shard passes. ``cover=None`` lets the cover pass choose; a
    pinned cover is validated and used as it is. ``cover_objective``:
    ``"r_lower"`` (§IV-F, minimum storage) or ``"cost"`` (one compile per
    valid cover, the Eq. 11 runtime argmin). ``executor``: ``"tree"``,
    ``"wcoj"`` or ``"auto"`` (:func:`choose_executor`)."""

    pattern: Pattern
    stats: GraphStats
    m: int = 1
    caps: Optional[Any] = None
    cover: Optional[Tuple[int, ...]] = None
    cover_objective: str = "r_lower"
    store_headroom: float = 4.0
    unit_headroom: float = 2.0
    max_unit_size: Optional[int] = None
    executor: str = "tree"


@dataclasses.dataclass(frozen=True)
class PassReport:
    """One pipeline stage's receipt: what it decided and what it cost."""

    name: str
    elapsed_ms: float
    detail: str


@dataclasses.dataclass(frozen=True)
class CompiledPlan:
    """The single immutable artifact every engine consumes.

    ``tree`` / ``units`` drive the host engine, ``program`` the device
    steps, ``store_caps`` / ``unit_caps`` / ``sharding`` the device memory
    layout; ``cost`` is the Eq. 11 estimate under ``stats`` (the WCOJ
    prefix-estimate sum for a generic-join plan). ``passes`` is the
    per-stage report."""

    pattern: Pattern
    ord: Tuple[Tuple[int, int], ...]
    cover: Tuple[int, ...]
    units: Tuple[R1Unit, ...]
    tree: JoinTree
    program: TreeProgram
    cost: float
    stats: GraphStats
    m: int
    store_caps: Optional[StoreCaps]
    unit_caps: Optional[StoreCaps]
    sharding: Optional[ShardingSpec]
    passes: Tuple[PassReport, ...]
    executor: str = "tree"
    wcoj: Optional[WcojPlan] = None
    wcoj_level_caps: Optional[Tuple[int, ...]] = None

    def plan_key(self) -> Tuple:
        """Identity for swap decisions: same key ⇒ same execution plan
        (cover + tree shape + executor), whatever stats produced it."""
        return (self.pattern.key(), self.cover, tree_key(self.tree), self.executor)

    @property
    def storage_cover(self) -> Tuple[int, ...]:
        """The cover the match store is laid out under: the compile
        ``cover`` for a tree plan; every pattern vertex for a WCOJ plan,
        whose store holds plain rows (a skeleton of every vertex, no sets)."""
        if self.executor == "wcoj":
            return tuple(int(v) for v in sorted(self.pattern.vertices))
        return self.cover

    def describe(self) -> str:
        lines = [
            f"pattern V={list(self.pattern.vertices)} |E|={self.pattern.m}",
            f"cover={list(self.cover)} units={len(self.units)} "
            f"cost={self.cost:.6g} m={self.m} executor={self.executor}",
            self.tree.describe(),
        ]
        for pr in self.passes:
            lines.append(f"[{pr.name:>9}] {pr.elapsed_ms:7.3f} ms  {pr.detail}")
        return "\n".join(lines)

    def to_json(self) -> Dict[str, Any]:
        """JSON-safe dump, the form ``Observability.record_plan`` keeps."""
        return {
            "pattern": {"vertices": list(self.pattern.vertices),
                        "edges": sorted(map(list, self.pattern.edges))},
            "ord": [list(e) for e in self.ord],
            "cover": list(self.cover),
            "units": [{"vertices": list(u.pattern.vertices),
                       "anchor": int(u.anchor)} for u in self.units],
            "tree": self.tree.describe(),
            "cost": self.cost,
            "stats": {"n": self.stats.n, "m": self.stats.m},
            "m": self.m,
            "store_caps": dataclasses.asdict(self.store_caps) if self.store_caps else None,
            "unit_caps": dataclasses.asdict(self.unit_caps) if self.unit_caps else None,
            "sharding": dataclasses.asdict(self.sharding) if self.sharding else None,
            "executor": self.executor,
            "wcoj": None if self.wcoj is None else {
                "anchor": int(self.wcoj.anchor),
                "order": [int(v) for v in self.wcoj.order],
                "level_caps": (list(self.wcoj_level_caps)
                               if self.wcoj_level_caps is not None else None),
            },
            "passes": [dataclasses.asdict(pr) for pr in self.passes],
        }


def compile_plan(ctx: CompileContext) -> CompiledPlan:
    """Run the staged pipeline over ``ctx`` and return the artifact.
    Deterministic: equal contexts give plans whose tree, program and caps
    compare equal."""
    if ctx.cover_objective not in ("r_lower", "cost"):
        raise ValueError(
            f"unknown cover_objective {ctx.cover_objective!r} "
            "(expected 'r_lower' or 'cost')")
    if ctx.executor not in EXECUTORS:
        raise ValueError(
            f"unknown executor {ctx.executor!r} "
            "(expected 'tree', 'wcoj' or 'auto')")
    if ctx.cover is None and ctx.cover_objective == "cost":
        # joint cover + tree search: one compile per valid cover, the Eq. 11
        # argmin kept (the first wins ties)
        t0 = time.perf_counter()
        best: Optional[CompiledPlan] = None
        covers = candidate_covers(ctx.pattern)
        for vc in covers:
            cand = compile_plan(dataclasses.replace(ctx, cover=vc))
            if best is None or cand.cost < best.cost:
                best = cand
        if best is None:
            raise ValueError("no connected cover admits an anchored R1 decomposition")
        search = PassReport(
            name="search", elapsed_ms=(time.perf_counter() - t0) * 1e3,
            detail=f"{len(covers)} covers compiled, kept {list(best.cover)} "
                   f"(cost={best.cost:.6g})")
        return dataclasses.replace(best, passes=best.passes + (search,))

    passes: List[PassReport] = []

    def stage(name: str):
        t0 = time.perf_counter()

        def done(detail: str) -> None:
            passes.append(PassReport(name=name,
                                     elapsed_ms=(time.perf_counter() - t0) * 1e3,
                                     detail=detail))
        return done

    p = ctx.pattern

    done = stage("symmetry")
    ord_ = symmetry_break(p)
    done(f"ord={list(ord_)}")

    done = stage("cover")
    if ctx.cover is not None:
        cover = tuple(sorted(int(c) for c in ctx.cover))
        if not all(int(a) in cover or int(b) in cover for a, b in p.edges):
            raise ValueError(f"pinned cover {cover} is not a vertex cover")
        done(f"pinned cover={list(cover)}")
    else:
        cover = choose_cover(p, ord_, ctx.stats)
        done(f"chose cover={list(cover)} (R_lower argmax)")

    done = stage("decompose")
    units = tuple(minimum_unit_decomposition(p, cover, ctx.max_unit_size))
    done(f"{len(units)} Nav-join units, anchors={[u.anchor for u in units]}")

    done = stage("tree")
    tree = optimal_join_tree(p, cover, CostModel(cover, ord_, ctx.stats), ctx.max_unit_size)
    done(f"Eq.11 cost={tree.cost:.6g}, depth={tree.depth()}, "
         f"{len(tree.leaves())} leaves")

    done = stage("lower")
    program = build_tree_program(tree, cover, ord_)
    done(f"{len(program.nodes)} IR nodes (root skel={list(program.nodes[program.root].skel_cols)})")

    store_caps = unit_caps = sharding = None
    if ctx.caps is not None:
        done = stage("size")
        store_caps = match_caps(p, cover, ord_, ctx.stats, ctx.caps,
                                headroom=ctx.store_headroom)
        unit_caps = unit_table_caps(units, cover, ord_, ctx.stats, ctx.caps,
                                    headroom=ctx.unit_headroom)
        done(f"store={store_caps.group_cap}x{store_caps.set_cap} "
             f"units={unit_caps.group_cap}x{unit_caps.set_cap}")

        done = stage("shard")
        sharding = ShardingSpec(m=ctx.m, key_cols=program.nodes[program.root].skel_cols)
        done(f"m={ctx.m} key_cols={list(sharding.key_cols)}")

    choice = ExecutorChoice("tree", None, None, store_caps, tree.cost)
    if ctx.executor != "tree":
        done = stage("executor")
        choice = choose_executor(p, ord_, ctx.stats, tree.cost, ctx.executor, ctx.m, ctx.caps,
                                 store_caps, ctx.store_headroom)
        if choice.wcoj_cost is None:
            done("pattern not WCOJ-eligible; kept tree-join")
        elif choice.executor == "wcoj":
            done(f"picked wcoj anchor={choice.wcoj.anchor} "
                 f"(wcoj={choice.cost:.6g} vs tree={tree.cost:.6g}"
                 + (f", level_caps={list(choice.level_caps)}" if choice.level_caps else "")
                 + ")")
        else:
            done(f"kept tree (tree={tree.cost:.6g} <= wcoj={choice.wcoj_cost:.6g})")

    plan = CompiledPlan(
        pattern=p, ord=tuple(ord_), cover=cover, units=units, tree=tree,
        program=program, cost=choice.cost, stats=ctx.stats, m=ctx.m,
        store_caps=choice.store_caps, unit_caps=unit_caps, sharding=sharding,
        passes=tuple(passes),
        executor=choice.executor, wcoj=choice.wcoj, wcoj_level_caps=choice.level_caps,
    )
    # a dump that does not serialize fails here, not at export
    json.dumps(plan.to_json())
    return plan
