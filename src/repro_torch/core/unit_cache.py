"""Delta-maintained per-partition unit-table cache (§VI-B `fixed`-cost killer).

Host copy (NumPy only) of ``repro/core/unit_cache.py``. Both the Nav-join
chain steps and the seed listings of a streaming micro-batch re-list every
join unit's full per-partition match table ``M_ac(q, d'_j)`` — the dominant
batch-size-independent (`fixed`) term of the §IV-D scheduler cost model.
But a unit table is an *independent per-partition artifact*: Lemma 3.1's
anchor→center rule makes ``M_ac(q, d_j)`` a pure function of partition
``j``'s stored edges, so it stays byte-identical across batches until
``E_j`` itself changes. The Alg. 4 candidate sets name exactly which
partitions a batch can dirty
(:attr:`~repro_torch.core.storage.UpdateCostReport.dirty_parts`), so caching
unit tables with candidate-driven invalidation is sound — per-batch listing
work shrinks from ``|units| · m`` tables to ``|units| · |dirty|``.

:class:`PartitionUnitCache` is that cache: it maps ``(unit key, anchor,
restricted ord, partition)`` to the *plain* listed table (the expensive
half) and ``(..., cover)`` to the VCBC-compressed form the chain steps
consume. It implements the :class:`ListingProvider` protocol that
:func:`repro_torch.core.navjoin.nav_join_patch` chain steps and the
:meth:`repro_torch.stream.scheduler.SharedDelta.seed_provider` pull through.
Hits, misses and invalidations are counted on the object (the streaming
layer mirrors them into ``stream.scheduler.PROBE``).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Protocol, Sequence, Tuple

import numpy as np

from .match_engine import list_matches, require_edge_rows_mask
from .pattern import Pattern, R1Unit
from .storage import NPStorage
from .vcbc import CompressedTable, Ragged, compress_table

__all__ = ["ListingProvider", "PartitionUnitCache", "take_groups"]


def _restrict_ord(ord_: Sequence[Tuple[int, int]], vs) -> frozenset:
    """The *set* of ord pairs scoped to a unit's vertices — the part of
    ``ord`` a unit listing can observe (checks are conjunctive, so pair
    order is irrelevant; anything less would alias distinct listings)."""
    vset = set(vs)
    return frozenset((a, b) for a, b in ord_ if a in vset and b in vset)


def take_groups(table: CompressedTable, keep: np.ndarray) -> CompressedTable:
    """Subset a compressed table to the groups flagged in ``keep``.

    Value sets travel untouched (every kept group keeps all its values),
    so this is the compressed twin of filtering plain rows *before*
    compression by any predicate that is constant within a skeleton
    group — e.g. the Nav-join anchor-candidate restriction.
    """
    keep = np.asarray(keep, bool)
    if keep.all():
        return table
    keep_idx = np.nonzero(keep)[0]
    remap = -np.ones(table.n_groups, dtype=np.int64)
    remap[keep_idx] = np.arange(keep_idx.shape[0])
    comp = {}
    for v, r in table.comp.items():
        gids = np.repeat(np.arange(r.n_groups, dtype=np.int64), r.counts())
        sel = keep[gids]
        comp[v] = Ragged.from_group_ids(remap[gids[sel]], r.values[sel],
                                        keep_idx.shape[0])
    return CompressedTable(
        pattern=table.pattern, cover=table.cover,
        skeleton_cols=table.skeleton_cols,
        skeleton=table.skeleton[keep_idx], comp=comp,
    )


class ListingProvider(Protocol):
    """What the Nav-join chain steps require from a listing source.

    ``storage`` names the Φ(d') the tables are listed from — callers
    assert it is the storage they are patching against, so a stale
    provider can never silently serve tables of an older graph.
    """

    storage: NPStorage

    def unit_plain(self, part_idx: int, unit: R1Unit, anchor: int,
                   ord_: Sequence[Tuple[int, int]]) -> Tuple[Tuple[int, ...], np.ndarray]:
        """Full plain ``M_ac(unit, d'_j)`` of one partition."""
        ...

    def unit_compressed(self, part_idx: int, unit: R1Unit,
                        cover: Sequence[int], ord_: Sequence[Tuple[int, int]],
                        anchor_candidates: np.ndarray | None = None) -> CompressedTable:
        """Compressed ``M_ac(unit, d'_j)``, optionally anchor-restricted."""
        ...


@dataclasses.dataclass
class CacheStats:
    """Monotone counters; consumers diff them for per-batch numbers."""

    hits: int = 0
    misses: int = 0
    invalidated_parts: int = 0
    #: LRU evictions under an entry/byte budget (0 when unbudgeted).
    #: Deliberately NOT part of :meth:`snapshot` — existing consumers
    #: unpack the 3-tuple positionally.
    evictions: int = 0

    def snapshot(self) -> Tuple[int, int, int]:
        return (self.hits, self.misses, self.invalidated_parts)


class PartitionUnitCache:
    """Delta-maintained map ``(unit, anchor, ord, partition) → table``.

    Two layers share one invalidation domain:

    - the **plain** layer holds the listed match table per partition —
      the expensive artifact (frontier expansion + edge probes); misses
      here are the only actual re-listings and are what
      :attr:`stats.misses <CacheStats.misses>` counts;
    - the **compressed** layer memoizes the cover-specific VCBC
      regrouping of a plain entry (cheap, but paid once per chain step
      per batch otherwise). It is derived state: invalidating a
      partition drops both layers.

    :meth:`advance` moves the cache to the next watermark's Φ(d'),
    invalidating exactly the partitions the batch dirtied
    (:attr:`~repro_torch.core.storage.UpdateCostReport.dirty_parts` — sound
    because a unit table is a pure function of its partition's edge
    set). Everything a consumer reads afterwards is byte-identical to
    listing directly from the new storage (property-tested).

    An optional memory budget (``max_entries`` live plain entries /
    ``max_bytes`` resident bytes, either or both) bounds the cache with
    LRU eviction over (plain key, partition) units; derived compressed
    entries are evicted with their plain parent. Evictions are counted
    in :attr:`stats.evictions <CacheStats.evictions>` and
    :attr:`resident_bytes` tracks the live footprint — both surface in
    the streaming layer's metrics registry.
    """

    def __init__(self, storage: NPStorage,
                 max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self.storage = storage
        self.stats = CacheStats()
        # Optional memory budget: at most `max_entries` live plain
        # entries and/or `max_bytes` resident bytes (plain + derived
        # compressed tables). Over budget, the least-recently-used
        # (plain key, partition) entry is evicted together with its
        # derived compressed entries — correctness is untouched (an
        # evicted entry is a future miss, re-listed byte-identically),
        # only the §VI-B `fixed`-cost amortization shrinks.
        self.max_entries = None if max_entries is None else max(1, int(max_entries))
        self.max_bytes = None if max_bytes is None else max(0, int(max_bytes))
        self.resident_bytes = 0
        # (unit key, anchor, restricted-ord) → part_idx → (cols, table)
        self._plain: Dict[Tuple, Dict[int, Tuple[Tuple[int, ...], np.ndarray]]] = {}
        # (unit key, anchor, restricted-ord, cover) → part_idx → CompressedTable
        self._comp: Dict[Tuple, Dict[int, CompressedTable]] = {}
        # LRU order + byte accounting over (plain key, part_idx) units.
        self._lru: "OrderedDict[Tuple[Tuple, int], None]" = OrderedDict()
        self._entry_bytes: Dict[Tuple[Tuple, int], int] = {}

    # --------------------------------------------------------------- budget
    @staticmethod
    def _comp_nbytes(t: CompressedTable) -> int:
        n = int(t.skeleton.nbytes)
        for r in t.comp.values():
            n += int(np.asarray(r.offsets).nbytes) + int(np.asarray(r.values).nbytes)
        return n

    def _account(self, lru_key: Tuple[Tuple, int], nbytes: int) -> None:
        self._entry_bytes[lru_key] = self._entry_bytes.get(lru_key, 0) + int(nbytes)
        self.resident_bytes += int(nbytes)

    def _forget(self, lru_key: Tuple[Tuple, int]) -> None:
        """Drop one LRU unit's accounting (entry data handled by caller)."""
        self._lru.pop(lru_key, None)
        self.resident_bytes -= self._entry_bytes.pop(lru_key, 0)

    def _drop_entry(self, lru_key: Tuple[Tuple, int]) -> None:
        """Remove one (plain key, part) entry and its derived compressed
        tables from both layers."""
        pk, part = lru_key
        per_part = self._plain.get(pk)
        if per_part is not None:
            per_part.pop(part, None)
        for ck, cp in self._comp.items():
            if ck[:3] == pk:
                cp.pop(part, None)
        self._forget(lru_key)

    def _over_budget(self) -> bool:
        if self.max_entries is not None and len(self._lru) > self.max_entries:
            return True
        if self.max_bytes is not None and self.resident_bytes > self.max_bytes:
            return True
        return False

    def _evict_over_budget(self) -> None:
        # Never evict the most recently touched entry: a single entry
        # larger than max_bytes would otherwise thrash forever.
        while self._over_budget() and len(self._lru) > 1:
            oldest = next(iter(self._lru))
            self._drop_entry(oldest)
            self.stats.evictions += 1

    # ------------------------------------------------------------ maintenance
    def advance(self, storage: NPStorage, dirty_parts: Sequence[int]) -> int:
        """Rebind to the updated Φ(d'), dropping dirty partitions' entries.

        Returns the number of invalidated partitions. Binding to a
        storage with a different partition count resets the cache (a
        resharding invalidates everything).
        """
        if storage.m != self.storage.m:
            self.clear()
            self.storage = storage
            self.stats.invalidated_parts += storage.m
            return storage.m
        dirty = sorted({int(j) for j in dirty_parts})
        dirty_set = set(dirty)
        for j in dirty:
            for per_part in self._plain.values():
                per_part.pop(j, None)
            for per_part in self._comp.values():
                per_part.pop(j, None)
        if dirty_set:
            for lk in [k for k in self._lru if k[1] in dirty_set]:
                self._forget(lk)
        self.storage = storage
        self.stats.invalidated_parts += len(dirty)
        return len(dirty)

    def clear(self) -> None:
        self._plain.clear()
        self._comp.clear()
        self._lru.clear()
        self._entry_bytes.clear()
        self.resident_bytes = 0

    def entries(self) -> int:
        """Live plain entries (≤ |unit keys| · m) — memory introspection."""
        return sum(len(d) for d in self._plain.values())

    # ------------------------------------------------------------- the tables
    def unit_plain(self, part_idx: int, unit: R1Unit, anchor: int,
                   ord_: Sequence[Tuple[int, int]]) -> Tuple[Tuple[int, ...], np.ndarray]:
        """Cached full ``M_ac(unit, d_j)`` as ``(cols, plain table)``."""
        if anchor is None:
            raise ValueError("unit anchor must lie inside the cover")
        key = (unit.pattern.key(), int(anchor),
               _restrict_ord(ord_, unit.pattern.vertices))
        per_part = self._plain.setdefault(key, {})
        lru_key = (key, part_idx)
        if part_idx not in per_part:
            self.stats.misses += 1
            cols, table = list_matches(
                self.storage.parts[part_idx], unit.pattern, ord_,
                anchor=int(anchor), anchor_to_centers=True,
            )
            per_part[part_idx] = (cols, table)
            self._lru[lru_key] = None
            self._account(lru_key, table.nbytes)
            self._evict_over_budget()
        else:
            self.stats.hits += 1
            self._lru.move_to_end(lru_key)
        return per_part[part_idx]

    def unit_compressed(self, part_idx: int, unit: R1Unit,
                        cover: Sequence[int], ord_: Sequence[Tuple[int, int]],
                        anchor_candidates: np.ndarray | None = None) -> CompressedTable:
        """Cached compressed ``M_ac(unit, d_j)`` under ``cover``; the
        anchor-candidate restriction (which changes every chain step) is
        applied on top as a group filter, never cached."""
        cover_t = tuple(sorted(int(c) for c in cover))
        anchor = unit.anchor_in(cover_t)
        if anchor is None:
            raise ValueError("unit anchor must lie inside the cover")
        key = (unit.pattern.key(), int(anchor),
               _restrict_ord(ord_, unit.pattern.vertices), cover_t)
        per_part = self._comp.setdefault(key, {})
        if part_idx not in per_part:
            cols, table = self.unit_plain(part_idx, unit, anchor, ord_)
            comp = compress_table(unit.pattern, cover_t, cols, table)
            per_part[part_idx] = comp
            # Derived state rides on its plain entry's LRU slot (the
            # unit_plain call above just touched it, so it exists and is
            # most-recent — never evicted by this accounting).
            self._account((key[:3], part_idx), self._comp_nbytes(comp))
            self._evict_over_budget()
        t = per_part[part_idx]
        if anchor_candidates is not None and t.n_groups:
            aidx = t.skeleton_cols.index(anchor)
            t = take_groups(t, np.isin(t.skeleton[:, aidx], anchor_candidates))
        return t

    # ------------------------------------------------------------------ seeds
    def seed_fn(self, cover: Sequence[int], ord_: Sequence[Tuple[int, int]],
                add_codes: np.ndarray):
        """A Nav-join ``seed_fn`` deriving ``M_new(q, d', q)`` from the
        cached full tables: the inserted-edge requirement (§VI-B step 2)
        is a row filter over the cached listing — zero re-listing on
        clean partitions. Byte-identical to listing with
        ``require_edge_codes`` directly (the engine applies that
        restriction as the same post-filter).
        """
        cover_t = tuple(sorted(int(c) for c in cover))
        codes = np.sort(np.asarray(add_codes, np.int64).reshape(-1))

        def fn(unit: R1Unit) -> CompressedTable:
            anchor = unit.anchor_in(cover_t)
            if anchor is None:
                raise ValueError("unit anchor must lie inside the cover")
            pieces = []
            cols: Tuple[int, ...] | None = None
            for pi in range(self.storage.m):
                cols, table = self.unit_plain(pi, unit, anchor, ord_)
                pieces.append(require_edge_rows(cols, table, unit.pattern, codes))
            table = (np.concatenate(pieces, axis=0) if pieces
                     else np.empty((0, unit.pattern.n), np.int64))
            return compress_table(unit.pattern, cover_t, cols, table)

        return fn


def require_edge_rows(cols: Sequence[int], table: np.ndarray,
                      pattern: Pattern, sorted_codes: np.ndarray) -> np.ndarray:
    """Rows mapping ≥1 pattern edge into the (sorted) edge-code set —
    the same :func:`~repro_torch.core.match_engine.require_edge_rows_mask`
    filter the engine applies after a restricted listing, addressed by
    column labels instead of plan-order indices."""
    if not table.shape[0] or not sorted_codes.size:
        return table[:0]
    col_of = {c: j for j, c in enumerate(cols)}
    pairs = [(col_of[a], col_of[b]) for a, b in pattern.edges]
    return table[require_edge_rows_mask(table, pairs, sorted_codes)]
