"""DDSL facade — the paper's two stages behind one object.

Host copy (NumPy only) of ``repro/core/ddsl.py``, the host reference engine
the streaming service audits against and its host backend runs::

    engine = DDSL(graph, m=4, pattern=PATTERN_LIBRARY["q5_house"])
    engine.initial()            # stage 1: initial calculation
    engine.apply(update)        # stage 2: incremental updating
    engine.count()              # |M(p, d)| right now

Plans come from the port's staged compiler
(:func:`repro_torch.planner.compile_plan`), whose cover pass implements the
*optimal connected compression* (§IV-F).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .cost import CostModel
from .estimator import GraphStats
from .graph import Graph, GraphUpdate, edge_codes
from .incremental import (
    IncrementalReport,
    apply_update_to_matches,
    filter_deleted,
    merge_tables,
)
from .join_tree import JoinTree
from .listing import ExecutionReport, execute_join_tree
from .match_engine import execute_wcoj
from .navjoin import NavReport
from .pattern import Pattern
from .storage import NPStorage, PartitionFn, UpdateCostReport, build_np_storage, update_np_storage
from .vcbc import CompressedTable, compress_table

__all__ = ["DDSL", "choose_cover"]


def choose_cover(*args, **kwargs):
    """The compiler's cover pass (:func:`repro_torch.planner.compiler.choose_cover`),
    re-exported here as ``repro.core.ddsl`` does; imported at call time,
    because the planner imports this package."""
    from ..planner.compiler import choose_cover as cover_pass

    return cover_pass(*args, **kwargs)


@dataclasses.dataclass
class DDSLState:
    storage: NPStorage
    matches: Optional[CompressedTable] = None


class DDSL:
    """Distributed & Dynamic Subgraph Listing (host reference engine)."""

    def __init__(
        self,
        graph: Graph,
        pattern: Pattern,
        m: int = 4,
        h: PartitionFn | None = None,
        cover: Sequence[int] | None = None,
        storage: NPStorage | None = None,
        plan=None,
        executor: str = "tree",
    ):
        from ..planner import CompileContext, compile_plan

        self.pattern = pattern
        if plan is None:
            plan = compile_plan(CompileContext(
                pattern=pattern, stats=GraphStats.of(graph), m=m,
                cover=tuple(sorted(cover)) if cover is not None else None,
                executor=executor))
        elif plan.pattern.key() != pattern.key():
            raise ValueError("precompiled plan is for a different pattern")
        self.plan = plan
        self.ord_ = plan.ord
        self.stats = plan.stats
        self.cover = plan.cover
        self.model = CostModel(self.cover, self.ord_, self.stats)
        self.tree: JoinTree = plan.tree
        self.units = list(plan.units)
        if storage is not None and storage.graph is not graph:
            raise ValueError("shared storage must be built over the same graph object")
        self.state = DDSLState(storage=storage if storage is not None else build_np_storage(graph, m, h))
        self.reports: List = []

    # ------------------------------------------------------------------ stage 1
    def initial(self) -> CompressedTable:
        rep = ExecutionReport()
        if self.plan.executor == "wcoj":
            self.state.matches = self._list_wcoj(self.state.storage)
        else:
            self.state.matches = execute_join_tree(
                self.state.storage, self.tree, self.cover, self.ord_, rep
            )
        self.reports.append(rep)
        return self.state.matches

    # ------------------------------------------------------------------ wcoj mode
    def _list_wcoj(
        self,
        storage: NPStorage,
        require_codes: np.ndarray | None = None,
        seed_vertices: np.ndarray | None = None,
    ) -> CompressedTable:
        """List matches via the generic-join executor (executor="wcoj").

        Anchoring seeds to partition centers makes the per-partition
        sweep globally complete and disjoint (Lemma 3.1 analogue: every
        match is found exactly once, at its anchor's center partition).
        The result is stored under *trivial* compression — the storage
        cover is all of ``V(p)``, matching the device WCOJ store layout.
        """
        wcoj = self.plan.wcoj
        tbls = [
            execute_wcoj(
                part, wcoj, anchor_to_centers=True,
                require_edge_codes=require_codes, seed_vertices=seed_vertices,
            )
            for part in storage.parts
        ]
        tbl = (np.concatenate(tbls, axis=0) if tbls
               else np.empty((0, len(wcoj.cols)), np.int64))
        return compress_table(
            self.pattern, self.plan.storage_cover, wcoj.cols, tbl)

    def _apply_wcoj(
        self,
        storage2: NPStorage,
        update: GraphUpdate,
        storage_report: UpdateCostReport | None = None,
    ) -> Tuple[CompressedTable, IncrementalReport]:
        """Stage 2 for executor="wcoj": delta-dataflow generic join.

        Deletes drop whole skeleton groups (every edge is
        skeleton–skeleton under trivial compression); the insert patch
        re-seeds the generic join from ``C1 ∪ N_{d'}(C1)`` (endpoints of
        inserted edges and their Φ(d') neighbors — a new match's anchor
        is adjacent to both endpoints of some contained inserted edge)
        and keeps only rows containing an inserted edge, so each new
        match is listed exactly once with no Thm 6.1 dedup pass.
        """
        matches = self.state.matches
        kept = filter_deleted(matches, update.delete)
        add = np.asarray(update.add, dtype=np.int64).reshape(-1, 2)
        if add.size:
            g2 = storage2.graph
            ends = np.unique(add.reshape(-1))
            nbrs = [g2.indices[g2.indptr[v]:g2.indptr[v + 1]]
                    for v in ends if 0 <= v < g2.n]
            cand = np.unique(np.concatenate([ends, *nbrs]))
            patch = self._list_wcoj(
                storage2, require_codes=np.sort(edge_codes(add)),
                seed_vertices=cand)
        else:
            patch = compress_table(
                self.pattern, self.plan.storage_cover, self.plan.wcoj.cols,
                np.empty((0, len(self.plan.wcoj.cols)), np.int64))
        merged = merge_tables(kept, patch)
        rep = IncrementalReport(
            storage=storage_report if storage_report is not None else UpdateCostReport(),
            nav=NavReport(patch_matches=patch.count_matches(self.ord_)),
            removed_groups=matches.n_groups - kept.n_groups,
            patch=patch,
        )
        return merged, rep

    # ------------------------------------------------------------------ stage 2
    def apply(self, update: GraphUpdate) -> IncrementalReport:
        if self.state.matches is None:
            raise RuntimeError("call initial() before apply()")
        storage2, cost = update_np_storage(self.state.storage, update)
        if self.plan.executor == "wcoj":
            merged, rep = self._apply_wcoj(storage2, update, storage_report=cost)
        else:
            merged, rep = apply_update_to_matches(
                storage2, self.state.matches, update,
                self.units, self.pattern, self.cover, self.ord_,
                storage_report=cost,
            )
        self.state.storage = storage2
        self.state.matches = merged
        self.stats = GraphStats.of(storage2.graph)
        # History keeps counters only — retaining every batch's patch
        # table would grow memory with stream length.
        self.reports.append(dataclasses.replace(rep, patch=None))
        return rep

    def apply_shared(
        self,
        storage2: NPStorage,
        update: GraphUpdate,
        *,
        stats: GraphStats | None = None,
        storage_report: UpdateCostReport | None = None,
        seed_fn=None,
        provider=None,
    ) -> IncrementalReport:
        """Stage 2 over a *shared* pre-updated Φ(d') (streaming hook).

        ``storage2``/``stats`` are computed once per micro-batch by
        :mod:`repro_torch.stream.scheduler` and shared by every registered
        pattern; ``seed_fn`` optionally shares Nav-join seed listings;
        ``provider`` serves the chain-step unit tables from the
        delta-maintained :class:`~repro_torch.core.unit_cache.PartitionUnitCache`.
        """
        if self.state.matches is None:
            raise RuntimeError("call initial() before apply_shared()")
        if self.plan.executor == "wcoj":
            merged, rep = self._apply_wcoj(storage2, update, storage_report=storage_report)
        else:
            merged, rep = apply_update_to_matches(
                storage2, self.state.matches, update,
                self.units, self.pattern, self.cover, self.ord_,
                storage_report=storage_report, seed_fn=seed_fn, provider=provider,
            )
        self.state.storage = storage2
        self.state.matches = merged
        self.stats = stats if stats is not None else GraphStats.of(storage2.graph)
        self.reports.append(dataclasses.replace(rep, patch=None))
        return rep

    # ------------------------------------------------------------------ results
    def count(self) -> int:
        assert self.state.matches is not None
        return self.state.matches.count_matches(self.ord_)

    def matches_plain(self) -> np.ndarray:
        assert self.state.matches is not None
        _, table = self.state.matches.decompress(self.ord_)
        return table

    @property
    def graph(self) -> Graph:
        return self.state.storage.graph
