"""Vectorized anchored subgraph listing (paper Alg. 1 substrate).

Host copy (NumPy only) of ``repro/core/match_engine.py``, whole: the
frontier-table executor of a :class:`~repro_torch.core.plan.UnitPlan`
(:func:`execute_unit_plan`, :func:`list_matches`) and the generic-join
executor of a :class:`~repro_torch.core.plan.WcojPlan`
(:func:`execute_wcoj`, :func:`list_matches_wcoj`), over a whole
:class:`~repro_torch.core.graph.Graph` or one NP :class:`Partition`.
A table of partial matches (one column per matched pattern vertex) is
extended by gathering candidates from the adjacency of a matched pivot
and filtering them with vectorized edge, injectivity and order masks.
:func:`wcoj_level_counts` is the register-time calibration probe of the
WCOJ level caps (:func:`repro_torch.planner.sizing.calibrate_wcoj_caps`);
the listings are the host oracle the device steps are held against.

Constraints supported:

- **anchor→center** (``M_ac``, Lemma 3.1): the anchor column is seeded
  only with center vertices of the partition;
- **ord** (SimB, §II-B): ``f(a) < f(b)`` for ``(a, b) ∈ ord``;
- **inserted-edge requirement** (Nav-join step 2, §VI-B): at least one
  pattern edge must map into ``E_a(U)``;
- **degree pruning** (MC₁ of §IV-D): candidates whose in-scope degree is
  below the pattern degree are dropped early.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .graph import Graph
from .pattern import Pattern
from .plan import UnitPlan, WcojPlan, build_unit_plan, build_wcoj_plan, plan_extension_order
from .storage import Partition

__all__ = [
    "plan_extension_order",
    "list_matches",
    "list_matches_wcoj",
    "execute_unit_plan",
    "execute_wcoj",
    "wcoj_level_counts",
    "require_edge_rows_mask",
    "ragged_expand",
]

_ROW_CHUNK = 1 << 17


def _rows_of(provider, u: np.ndarray) -> np.ndarray:
    if isinstance(provider, Partition):
        return provider.local_ids(u)
    return u


def _has_edges(provider, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    return provider.has_edges(u, v)


def ragged_expand(starts: np.ndarray, counts: np.ndarray, values: np.ndarray):
    """For row i, yield ``values[starts[i] : starts[i]+counts[i]]``.

    Returns ``(row_index, gathered_values)`` — the core repeat/gather
    primitive shared by adjacency expansion, VCBC decompression, and the
    CC-join pair expansion.
    """
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty((0,), np.int64), values[:0]
    rep = np.repeat(np.arange(counts.shape[0], dtype=np.int64), counts)
    offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(counts) - counts, counts)
    return rep, values[np.repeat(starts.astype(np.int64), counts) + offs]


def execute_unit_plan(
    provider: Graph | Partition,
    plan: UnitPlan,
    *,
    anchor_to_centers: bool = False,
    require_edge_codes: np.ndarray | None = None,
    degree_prune: bool = True,
    row_chunk: int = _ROW_CHUNK,
) -> np.ndarray:
    """Run a :class:`UnitPlan` on the NumPy substrate.

    Returns ``int64[n_matches, |V|]`` with columns aligned to
    ``plan.cols`` (the extension order).
    """
    # --- seed the anchor column ---------------------------------------------
    if anchor_to_centers:
        assert isinstance(provider, Partition)
        seeds = provider.center_vertices()
    elif isinstance(provider, Partition):
        seeds = provider.vertices
    else:
        seeds = np.nonzero(provider.degrees > 0)[0].astype(np.int64)
    if degree_prune and seeds.size:
        if isinstance(provider, Partition):
            degs = provider.degrees_of(seeds)
        else:
            degs = provider.degrees[seeds]
        seeds = seeds[degs >= plan.anchor_min_degree]
    table = seeds.reshape(-1, 1)

    # --- extend vertex by vertex ---------------------------------------------
    for i, step in enumerate(plan.steps, start=1):
        chunks = []
        for lo in range(0, table.shape[0], row_chunk):
            sub = table[lo : lo + row_chunk]
            rows = _rows_of(provider, sub[:, step.pivot])
            starts = provider.indptr[rows]
            counts = provider.indptr[rows + 1] - starts
            rep, cand = ragged_expand(starts, counts, provider.indices)
            if cand.size == 0:
                continue
            mask = np.ones(cand.shape[0], dtype=bool)
            # degree prune (MC₁)
            if degree_prune:
                crow = _rows_of(provider, cand)
                cdeg = provider.indptr[crow + 1] - provider.indptr[crow]
                mask &= cdeg >= step.min_degree
            # injectivity
            for j in range(sub.shape[1]):
                mask &= cand != sub[rep, j]
            # extra edge constraints
            for j in step.edge_checks:
                mask &= _has_edges(provider, cand, sub[rep, j])
            # symmetry-breaking order
            for j, greater in step.ord_checks:
                cu = sub[rep, j]
                mask &= (cand > cu) if greater else (cand < cu)
            rep, cand = rep[mask], cand[mask]
            chunks.append(np.concatenate([sub[rep], cand[:, None]], axis=1))
        table = (
            np.concatenate(chunks, axis=0)
            if chunks
            else np.empty((0, i + 1), dtype=np.int64)
        )
        if table.shape[0] == 0 and i < len(plan.steps):
            return np.empty((0, len(plan.order)), np.int64)

    # --- optional: at least one pattern edge maps to an inserted edge --------
    if require_edge_codes is not None and table.shape[0]:
        req = np.sort(np.asarray(require_edge_codes, dtype=np.int64))
        table = table[require_edge_rows_mask(table, plan.edge_cols, req)]
    return table if table.shape[0] else np.empty((0, len(plan.order)), np.int64)


def execute_wcoj(
    provider: Graph | Partition,
    plan: WcojPlan,
    *,
    anchor_to_centers: bool = False,
    require_edge_codes: np.ndarray | None = None,
    seed_vertices: np.ndarray | None = None,
    degree_prune: bool = True,
    row_chunk: int = _ROW_CHUNK,
) -> np.ndarray:
    """Run a :class:`WcojPlan` on the NumPy substrate — the reference
    attribute-at-a-time generic join.

    Each level's candidates are the pivot's adjacency list intersected
    (via vectorized membership probes) with the adjacency of every other
    placed neighbor, so intermediate tables are bounded per level rather
    than per binary join. Returns ``int64[n_matches, |V|]`` with columns
    aligned to ``plan.cols``.

    ``seed_vertices`` restricts the anchor seeds to the given vertex set
    — the delta-dataflow hook: a new match's anchor is adjacent to both
    endpoints of some inserted edge (or is one), so seeding from the
    delta-candidate set ``C1 ∪ N_{d'}(C1)`` with ``require_edge_codes``
    set to ``E_a(U)`` yields exactly the batch's new matches.
    """
    if anchor_to_centers:
        assert isinstance(provider, Partition)
        seeds = provider.center_vertices()
    elif isinstance(provider, Partition):
        seeds = provider.vertices
    else:
        seeds = np.nonzero(provider.degrees > 0)[0].astype(np.int64)
    if seed_vertices is not None:
        seeds = seeds[np.isin(seeds, seed_vertices)]
    if degree_prune and seeds.size:
        if isinstance(provider, Partition):
            degs = provider.degrees_of(seeds)
        else:
            degs = provider.degrees[seeds]
        seeds = seeds[degs >= plan.anchor_min_degree]
    table = seeds.reshape(-1, 1)

    for i, level in enumerate(plan.levels, start=1):
        chunks = []
        for lo in range(0, table.shape[0], row_chunk):
            sub = table[lo : lo + row_chunk]
            rows = _rows_of(provider, sub[:, level.pivot])
            starts = provider.indptr[rows]
            counts = provider.indptr[rows + 1] - starts
            rep, cand = ragged_expand(starts, counts, provider.indices)
            if cand.size == 0:
                continue
            mask = np.ones(cand.shape[0], dtype=bool)
            if degree_prune:
                crow = _rows_of(provider, cand)
                cdeg = provider.indptr[crow + 1] - provider.indptr[crow]
                mask &= cdeg >= level.min_degree
            for j in range(sub.shape[1]):
                mask &= cand != sub[rep, j]
            # multiway adjacency intersection against the other placed
            # neighbors — the generic-join step
            for j in level.intersect_cols:
                mask &= _has_edges(provider, cand, sub[rep, j])
            for j, greater in level.ord_checks:
                cu = sub[rep, j]
                mask &= (cand > cu) if greater else (cand < cu)
            rep, cand = rep[mask], cand[mask]
            chunks.append(np.concatenate([sub[rep], cand[:, None]], axis=1))
        table = (
            np.concatenate(chunks, axis=0)
            if chunks
            else np.empty((0, i + 1), dtype=np.int64)
        )
        if table.shape[0] == 0 and i < len(plan.levels):
            return np.empty((0, len(plan.order)), np.int64)

    if require_edge_codes is not None and table.shape[0]:
        req = np.sort(np.asarray(require_edge_codes, dtype=np.int64))
        table = table[require_edge_rows_mask(table, plan.edge_cols, req)]
    return table if table.shape[0] else np.empty((0, len(plan.order)), np.int64)


def wcoj_level_counts(
    provider: Graph | Partition,
    plan: WcojPlan,
    *,
    anchor_to_centers: bool = False,
    degree_prune: bool = True,
    row_chunk: int = _ROW_CHUNK,
) -> Tuple[int, ...]:
    """Exact per-level partial-match table sizes of a WCOJ plan.

    One host pass over ``provider`` recording ``|table|`` after the seed
    and after every extension level — the register-time *calibration
    probe* the sharded backend uses to tighten the compile-time
    (estimator-clamped) device level caps down to the observed sizes.
    Runs the same loop as :func:`execute_wcoj` without keeping the final
    table.
    """
    counts = []
    if anchor_to_centers:
        assert isinstance(provider, Partition)
        seeds = provider.center_vertices()
    elif isinstance(provider, Partition):
        seeds = provider.vertices
    else:
        seeds = np.nonzero(provider.degrees > 0)[0].astype(np.int64)
    if degree_prune and seeds.size:
        if isinstance(provider, Partition):
            degs = provider.degrees_of(seeds)
        else:
            degs = provider.degrees[seeds]
        seeds = seeds[degs >= plan.anchor_min_degree]
    table = seeds.reshape(-1, 1)
    counts.append(int(table.shape[0]))

    for i, level in enumerate(plan.levels, start=1):
        chunks = []
        for lo in range(0, table.shape[0], row_chunk):
            sub = table[lo : lo + row_chunk]
            rows = _rows_of(provider, sub[:, level.pivot])
            starts = provider.indptr[rows]
            cnts = provider.indptr[rows + 1] - starts
            rep, cand = ragged_expand(starts, cnts, provider.indices)
            if cand.size == 0:
                continue
            mask = np.ones(cand.shape[0], dtype=bool)
            if degree_prune:
                crow = _rows_of(provider, cand)
                cdeg = provider.indptr[crow + 1] - provider.indptr[crow]
                mask &= cdeg >= level.min_degree
            for j in range(sub.shape[1]):
                mask &= cand != sub[rep, j]
            for j in level.intersect_cols:
                mask &= _has_edges(provider, cand, sub[rep, j])
            for j, greater in level.ord_checks:
                cu = sub[rep, j]
                mask &= (cand > cu) if greater else (cand < cu)
            rep, cand = rep[mask], cand[mask]
            chunks.append(np.concatenate([sub[rep], cand[:, None]], axis=1))
        table = (
            np.concatenate(chunks, axis=0)
            if chunks
            else np.empty((0, i + 1), dtype=np.int64)
        )
        counts.append(int(table.shape[0]))
    return tuple(counts)


def require_edge_rows_mask(
    table: np.ndarray,
    col_pairs: Sequence[Tuple[int, int]],
    sorted_codes: np.ndarray,
) -> np.ndarray:
    """Rows mapping ≥1 of the given column-pair edges into the *sorted*
    edge-code set — the inserted-edge requirement of a Nav-join seed
    (§VI-B step 2). The one host implementation of this filter: the
    plan executor applies it after a restricted listing and the
    unit-table cache applies it to re-seed a cached full listing, so
    the two stay bit-identical by construction.
    """
    hit = np.zeros(table.shape[0], dtype=bool)
    if not sorted_codes.size or not table.shape[0]:
        return hit
    for ia, ib in col_pairs:
        fa, fb = table[:, ia], table[:, ib]
        lo, hi = np.minimum(fa, fb), np.maximum(fa, fb)
        q = (lo << np.int64(32)) | hi
        pos = np.clip(np.searchsorted(sorted_codes, q), 0, sorted_codes.shape[0] - 1)
        hit |= sorted_codes[pos] == q
    return hit


def list_matches(
    provider: Graph | Partition,
    pattern: Pattern,
    ord_: Sequence[Tuple[int, int]] = (),
    *,
    anchor: int | None = None,
    anchor_to_centers: bool = False,
    require_edge_codes: np.ndarray | None = None,
    degree_prune: bool = True,
    row_chunk: int = _ROW_CHUNK,
) -> Tuple[Tuple[int, ...], np.ndarray]:
    """List all matches of ``pattern`` within ``provider``.

    Compiles a :class:`UnitPlan` and executes it, then permutes columns
    to the canonical sorted label order. Returns ``(cols, table)`` where
    ``cols`` is the sorted tuple of pattern vertex labels and ``table``
    is ``int64[n_matches, len(cols)]`` of data-graph vertex ids.
    """
    plan = build_unit_plan(pattern, anchor, ord_)
    table = execute_unit_plan(
        provider, plan,
        anchor_to_centers=anchor_to_centers,
        require_edge_codes=require_edge_codes,
        degree_prune=degree_prune,
        row_chunk=row_chunk,
    )
    cols = tuple(sorted(pattern.vertices))
    perm = [plan.order.index(c) for c in cols]
    return cols, table[:, perm] if table.shape[0] else np.empty((0, len(cols)), np.int64)


def list_matches_wcoj(
    provider: Graph | Partition,
    pattern: Pattern,
    ord_: Sequence[Tuple[int, int]] = (),
    *,
    anchor: int | None = None,
    anchor_to_centers: bool = False,
    require_edge_codes: np.ndarray | None = None,
    degree_prune: bool = True,
    row_chunk: int = _ROW_CHUNK,
) -> Tuple[Tuple[int, ...], np.ndarray]:
    """List all matches of ``pattern`` via the generic-join executor.

    Same contract as :func:`list_matches`: compiles a :class:`WcojPlan`,
    executes it, and permutes columns to sorted label order.
    """
    plan = build_wcoj_plan(pattern, anchor, ord_)
    table = execute_wcoj(
        provider, plan,
        anchor_to_centers=anchor_to_centers,
        require_edge_codes=require_edge_codes,
        degree_prune=degree_prune,
        row_chunk=row_chunk,
    )
    cols = tuple(sorted(pattern.vertices))
    perm = [plan.order.index(c) for c in cols]
    return cols, table[:, perm] if table.shape[0] else np.empty((0, len(cols)), np.int64)
