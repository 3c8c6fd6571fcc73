"""Incremental result maintenance (paper §VI): filter + patch + merge.

Host copy (NumPy only) of ``repro/core/incremental.py``::

    M(p, d') = (M(p, d) − removed) ∪ M_new(p, d')

- *removed* matches are detected fully on the compressed form: every
  pattern edge has a cover endpoint, so each edge is either
  skeleton–skeleton (drop the whole group) or skeleton–compressed
  (drop the offending value) — Lemma 6.1 with zero decompression.
- the *patch set* comes from the Nav-join (Lemma 6.2 + Thm. 6.1).
- *merge* regroups by skeleton so the result stays a canonical
  compressed table.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from .graph import GraphUpdate, edge_codes
from .navjoin import NavReport, nav_join_patch
from .pattern import Pattern, R1Unit
from .storage import NPStorage, UpdateCostReport, update_np_storage
from .vcbc import CompressedTable, Ragged, _drop_empty_groups

__all__ = [
    "filter_deleted",
    "removed_rows",
    "merge_tables",
    "incremental_update",
    "apply_update_to_matches",
    "IncrementalReport",
]


def _codes_of(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    return (lo << np.int64(32)) | hi


def _in_sorted(q: np.ndarray, sorted_codes: np.ndarray) -> np.ndarray:
    if not sorted_codes.size or not q.size:
        return np.zeros(q.shape, bool)
    pos = np.clip(np.searchsorted(sorted_codes, q), 0, sorted_codes.shape[0] - 1)
    return sorted_codes[pos] == q


def filter_deleted(table: CompressedTable, deleted: np.ndarray) -> CompressedTable:
    """Remove matches mapping any pattern edge into ``E_d(U)`` (Lemma 6.1)."""
    del_codes = np.sort(edge_codes(deleted)) if np.asarray(deleted).size else np.empty(0, np.int64)
    if not del_codes.size or table.n_groups == 0:
        return table
    p = table.pattern
    skel_set = set(table.skeleton_cols)
    jcol = {c: j for j, c in enumerate(table.skeleton_cols)}

    # skeleton–skeleton edges → drop whole groups
    drop = np.zeros(table.n_groups, dtype=bool)
    for a, b in p.edges:
        if a in skel_set and b in skel_set:
            q = _codes_of(table.skeleton[:, jcol[a]], table.skeleton[:, jcol[b]])
            drop |= _in_sorted(q, del_codes)
    keep_groups = np.nonzero(~drop)[0]
    remap = -np.ones(table.n_groups, dtype=np.int64)
    remap[keep_groups] = np.arange(keep_groups.shape[0])

    comp = {}
    for v, r in table.comp.items():
        gids = np.repeat(np.arange(r.n_groups, dtype=np.int64), r.counts())
        vals = r.values
        alive = ~drop[gids]
        gids, vals = gids[alive], vals[alive]
        # skeleton–compressed edges → drop offending values
        bad = np.zeros(vals.shape[0], dtype=bool)
        for a, b in p.edges:
            w = None
            if a == v and b in skel_set:
                w = b
            elif b == v and a in skel_set:
                w = a
            if w is not None:
                q = _codes_of(vals, table.skeleton[gids, jcol[w]])
                bad |= _in_sorted(q, del_codes)
        gids, vals = gids[~bad], vals[~bad]
        comp[v] = Ragged.from_group_ids(remap[gids], vals, keep_groups.shape[0])

    out = CompressedTable(
        pattern=p, cover=table.cover, skeleton_cols=table.skeleton_cols,
        skeleton=table.skeleton[keep_groups], comp=comp,
    )
    return _drop_empty_groups(out)


def removed_rows(table: CompressedTable, deleted: np.ndarray,
                 ord_: Sequence[Tuple[int, int]] = ()) -> np.ndarray:
    """Plain rows of ``table`` that map a pattern edge into ``E_d(U)``.

    The decompressed complement of :func:`filter_deleted` (same Lemma
    6.1 edge test on rows instead of on the compressed form) — used by
    match-delta sinks to report exactly which matches a batch destroyed.
    """
    del_codes = np.sort(edge_codes(deleted)) if np.asarray(deleted).size else np.empty(0, np.int64)
    if not del_codes.size:
        return np.empty((0, table.pattern.n), np.int64)
    cols, rows = table.decompress(ord_)
    if not rows.shape[0]:
        return rows[:0]
    col_of = {c: j for j, c in enumerate(cols)}
    hit = np.zeros(rows.shape[0], dtype=bool)
    for a, b in table.pattern.edges:
        q = _codes_of(rows[:, col_of[a]], rows[:, col_of[b]])
        hit |= _in_sorted(q, del_codes)
    return rows[hit]


def merge_tables(a: CompressedTable, b: CompressedTable) -> CompressedTable:
    """Union of two compressed tables of the same pattern, regrouped by skeleton."""
    assert a.pattern.key() == b.pattern.key() and a.skeleton_cols == b.skeleton_cols
    if a.n_groups == 0:
        return b
    if b.n_groups == 0:
        return a
    skel = np.concatenate([a.skeleton, b.skeleton], axis=0)
    uniq, inv = np.unique(skel, axis=0, return_inverse=True)
    comp = {}
    for v in a.comp:
        pieces = []
        for t, off in ((a, 0), (b, a.n_groups)):
            r = t.comp[v]
            gids = np.repeat(np.arange(r.n_groups, dtype=np.int64), r.counts())
            pieces.append((inv[gids + off].astype(np.int64), r.values))
        g = np.concatenate([p[0] for p in pieces])
        vv = np.concatenate([p[1] for p in pieces])
        fused = np.unique((g << np.int64(32)) | vv)
        comp[v] = Ragged.from_group_ids(fused >> np.int64(32), fused & np.int64(0xFFFFFFFF), uniq.shape[0])
    return CompressedTable(pattern=a.pattern, cover=a.cover, skeleton_cols=a.skeleton_cols, skeleton=uniq, comp=comp)


@dataclasses.dataclass
class IncrementalReport:
    storage: UpdateCostReport
    nav: NavReport
    removed_groups: int = 0
    # The compressed patch set M_new(p, d') of this batch — kept so
    # streaming sinks can decompress exactly the *new* matches without
    # re-deriving them from the merged table.
    patch: Optional[CompressedTable] = None


def apply_update_to_matches(
    storage2: NPStorage,
    matches: CompressedTable,
    update: GraphUpdate,
    units: Sequence[R1Unit],
    pattern: Pattern,
    cover: Sequence[int],
    ord_: Sequence[Tuple[int, int]],
    storage_report: Optional[UpdateCostReport] = None,
    seed_fn: Optional[Callable] = None,
    provider=None,
) -> Tuple[CompressedTable, IncrementalReport]:
    """Result-maintenance half of the §VI pipeline over a *pre-updated* Φ(d').

    The shared-delta hook for the streaming layer: ``storage2`` is the
    already-updated NP storage (computed **once** per batch and shared
    by every registered pattern), ``seed_fn`` optionally shares per-unit
    Nav-join seed listings across patterns, and ``provider`` (a
    delta-maintained :class:`~repro_torch.core.unit_cache.PartitionUnitCache`)
    serves the Nav-join chain-step unit tables from cache. Filter +
    patch + merge stay per-pattern.
    """
    nav = NavReport()
    kept = filter_deleted(matches, update.delete)
    patch = nav_join_patch(storage2, units, pattern, cover, ord_, update.add,
                           report=nav, seed_fn=seed_fn, provider=provider)
    merged = merge_tables(kept, patch)
    rep = IncrementalReport(
        storage=storage_report if storage_report is not None else UpdateCostReport(),
        nav=nav,
        removed_groups=matches.n_groups - kept.n_groups,
        patch=patch,
    )
    return merged, rep


def incremental_update(
    storage: NPStorage,
    matches: CompressedTable,
    update: GraphUpdate,
    units: Sequence[R1Unit],
    pattern: Pattern,
    cover: Sequence[int],
    ord_: Sequence[Tuple[int, int]],
) -> Tuple[NPStorage, CompressedTable, IncrementalReport]:
    """Full §VI pipeline: Φ(d)→Φ(d'), patch via Nav-join, filter + merge."""
    storage2, cost = update_np_storage(storage, update)
    merged, rep = apply_update_to_matches(
        storage2, matches, update, units, pattern, cover, ord_, storage_report=cost
    )
    return storage2, merged, rep
