"""Navigated Join (paper §VI-B) — patch-set extraction on dynamic graphs.

Host copy (NumPy only) of ``repro/core/navjoin.py``: the host Nav-join
that the streaming service's host backend and the host ``DDSL`` run (the
device patch chains of :mod:`repro_torch.sharded` are its twin).

For each join unit ``q_i`` (under the total order of Thm. 6.1) we build a
left-deep tree with ``q_i`` as the lowest leaf, seed it with
``M_new(q_i, d', q_i)`` (unit matches forced to map ≥1 edge into
``E_a(U)``), and then repeatedly *partition-and-expand*: the running match
set is navigated to partitions (via per-vertex partition bitmaps) and
joined there against locally-listed unit matches ``M_ac(q_k, d'_j)``.

Because every unit anchor lies in the cover, the anchor is always a
skeleton column of the local table; the anchor→center constraint then
makes the per-partition join results pairwise disjoint (Lemma 3.1), so
their concatenation needs no dedup. Cross-``q_i`` duplicates are removed
by the inserted-edge total order (Thm. 6.1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np

from .graph import edge_codes
from .listing import list_unit_all_parts, list_unit_compressed
from .pattern import Pattern, R1Unit
from .storage import NPStorage
from .vcbc import CompressedTable, cc_join, compress_table, concat_tables

__all__ = ["NavReport", "nav_join_patch", "left_deep_order"]


@dataclasses.dataclass
class NavReport:
    """Shuffle-cost instrumentation for the Nav-join (paper's I/O terms)."""

    shipped_ints: int = 0        # match integers navigated across partitions
    local_unit_ints: int = 0     # unit matches listed locally (never shipped)
    rounds: int = 0
    patch_matches: int = 0


def left_deep_order(units: Sequence[R1Unit], first: R1Unit, cover: Sequence[int]) -> List[R1Unit]:
    """Order ``units`` into a left-deep chain starting at ``first`` with a
    non-empty cover join key at every step."""
    vc = set(cover)
    order = [first]
    placed = set(first.pattern.vertices)
    rest = [u for u in units if u is not first]
    while rest:
        nxt = next((u for u in rest if set(u.pattern.vertices) & placed & vc), None)
        if nxt is None:
            raise ValueError("units cannot form a connected left-deep tree under this cover")
        order.append(nxt)
        placed |= set(nxt.pattern.vertices)
        rest.remove(nxt)
    return order


def _partition_bitmaps(storage: NPStorage) -> np.ndarray:
    """bitmap[u] = OR of (1 << h(w)) over w ∈ N_{d'}(u) (§VI-B Match Navigation).

    Packed into int64 words; ``m ≤ 64`` uses one word (larger ``m`` falls
    back to multiple words in the device engine; the host engine raises)."""
    g = storage.graph
    if storage.m > 63:
        raise ValueError("host-engine bitmaps support m ≤ 63; use the device engine")
    und = g.edges()
    bits = np.zeros(g.n, dtype=np.int64)
    hv_a = storage.h(und[:, 0])
    hv_b = storage.h(und[:, 1])
    np.bitwise_or.at(bits, und[:, 0], np.int64(1) << hv_b)
    np.bitwise_or.at(bits, und[:, 1], np.int64(1) << hv_a)
    return bits


def _navigation_targets(
    cur: CompressedTable,
    unit: R1Unit,
    storage: NPStorage,
    bitmaps: np.ndarray,
) -> np.ndarray:
    """For each skeleton group of ``cur``: bitmap of partitions it must visit."""
    key_cols = sorted(set(cur.skeleton_cols) & set(unit.pattern.vertices) & set(cur.cover))
    anchor = unit.anchor_in(cur.cover)
    if anchor in key_cols:
        vals = cur.skeleton[:, cur.skeleton_cols.index(anchor)]
        return (np.int64(1) << storage.h(vals)).astype(np.int64)
    out = np.full(cur.n_groups, -1, dtype=np.int64)  # all ones
    for c in key_cols:
        vals = cur.skeleton[:, cur.skeleton_cols.index(c)]
        out &= bitmaps[np.clip(vals, 0, bitmaps.shape[0] - 1)]
    return out


def nav_join_patch(
    storage: NPStorage,
    units: Sequence[R1Unit],
    pattern: Pattern,
    cover: Sequence[int],
    ord_: Sequence[Tuple[int, int]],
    inserted: np.ndarray,
    report: NavReport | None = None,
    seed_fn: Callable[[R1Unit], CompressedTable] | None = None,
    provider=None,
) -> CompressedTable:
    """Compute the deduplicated patch set ``M_new(p, d')`` (Lemma 6.2 + Thm 6.1).

    ``storage`` must already be the *updated* Φ(d'); ``inserted`` is the
    ``[k, 2]`` array of added edges ``E_a(U)``. ``seed_fn`` overrides the
    seed listing ``M_new(q_i, d', q_i)`` — the streaming scheduler passes
    a memoizing provider here so several patterns registered over the
    same graph share one seed listing per unit per batch. ``provider``
    (a :class:`repro_torch.core.unit_cache.ListingProvider`, e.g. the
    delta-maintained :class:`~repro_torch.core.unit_cache.PartitionUnitCache`)
    replaces the chain-step unit listings ``M_ac(q_k, d'_j)`` — the
    batch-size-independent `fixed` cost of every patch — with cached
    tables invalidated only for the partitions the update dirtied. The
    provider must be bound to the same Φ(d') (asserted).
    """
    report = report if report is not None else NavReport()
    if provider is not None and provider.storage is not storage:
        raise ValueError("listing provider is bound to a different Φ(d') "
                         "than the one being patched — call advance() first")
    ins_codes = np.sort(edge_codes(inserted)) if np.asarray(inserted).size else np.empty(0, np.int64)
    bitmaps = _partition_bitmaps(storage) if storage.m <= 63 else None

    plain_patches: List[np.ndarray] = []
    out_cols: Tuple[int, ...] | None = None

    for i, qi in enumerate(units):
        order = left_deep_order(units, qi, cover)
        # Step 2: seed — unit matches mapping ≥1 edge into E_a(U).
        if seed_fn is not None:
            cur = seed_fn(qi)
        else:
            cur = list_unit_all_parts(storage, qi, cover, ord_, require_edge_codes=ins_codes)
        # Steps 3-4: Nav-join up the left-deep chain.
        for qk in order[1:]:
            report.rounds += 1
            if bitmaps is not None and cur.n_groups:
                targets = _navigation_targets(cur, qk, storage, bitmaps)
                ints_per_group = len(cur.skeleton_cols) + sum(
                    int(np.mean(r.counts())) if r.n_groups else 0 for r in cur.comp.values()
                )
                report.shipped_ints += int(
                    sum(bin(int(t) & ((1 << storage.m) - 1)).count("1") for t in targets) * ints_per_group
                )
            anchor = qk.anchor_in(cover)
            key_cols = set(cur.skeleton_cols) & set(qk.pattern.vertices)
            anchor_cands = None
            if anchor in key_cols and cur.n_groups:
                anchor_cands = np.unique(cur.skeleton[:, cur.skeleton_cols.index(anchor)])
            pieces = []
            for pi, part in enumerate(storage.parts):
                if provider is not None:
                    uj = provider.unit_compressed(pi, qk, cover, ord_,
                                                  anchor_candidates=anchor_cands)
                else:
                    uj = list_unit_compressed(part, qk, cover, ord_,
                                              anchor_candidates=anchor_cands)
                report.local_unit_ints += uj.storage_ints()
                if uj.n_groups == 0:
                    continue
                piece = cc_join(cur, uj, ord_)
                if piece.n_groups:
                    pieces.append(piece)
            if pieces:
                cur = concat_tables(pieces)
            else:
                cur = compress_table(cur.pattern.union(qk.pattern), cover,
                                     tuple(sorted(cur.pattern.union(qk.pattern).vertices)),
                                     np.empty((0, len(cur.pattern.union(qk.pattern).vertices)), np.int64))
                break

        # Step 5 (Thm. 6.1): dedup — drop matches that already map an edge of
        # an earlier unit q_j (j < i) to an inserted edge.
        cols, table = cur.decompress(ord_)
        out_cols = cols
        if table.shape[0] and i > 0 and ins_codes.size:
            col_of = {c: j for j, c in enumerate(cols)}
            dup = np.zeros(table.shape[0], dtype=bool)
            for qj in units[:i]:
                for a, b in qj.pattern.edges:
                    fa, fb = table[:, col_of[a]], table[:, col_of[b]]
                    lo, hi = np.minimum(fa, fb), np.maximum(fa, fb)
                    q = (lo << np.int64(32)) | hi
                    pos = np.clip(np.searchsorted(ins_codes, q), 0, ins_codes.shape[0] - 1)
                    dup |= ins_codes[pos] == q
            table = table[~dup]
        plain_patches.append(table)

    merged = (
        np.concatenate([t for t in plain_patches if t.shape[0]], axis=0)
        if any(t.shape[0] for t in plain_patches)
        else np.empty((0, pattern.n), np.int64)
    )
    report.patch_matches = int(merged.shape[0])
    return compress_table(pattern, cover, out_cols or tuple(sorted(pattern.vertices)), merged)
