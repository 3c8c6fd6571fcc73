"""Vertex-Cover-Based Compression (VCBC, paper §IV) and the CC-join (Alg. 2).

Host copy (NumPy only) of ``repro/core/vcbc.py``, whole: :class:`Ragged`,
:class:`CompressedTable`, :func:`compress_table`, :func:`concat_tables`,
:func:`cc_join` and :func:`r_lower`. A :class:`CompressedTable` stores the
matches of a (sub)pattern grouped by *skeleton*, the assignment of the
vertices in ``V_c(p) ∩ V(p_i)``; each compressed vertex maps to a ragged
per-group vertex set. It is the host form of a device match store
(:func:`repro_torch.engine.comp_to_host`, :func:`repro_torch.sharded.stack_matches`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import plan as plan_ir
from .match_engine import ragged_expand
from .pattern import Pattern

__all__ = [
    "Ragged",
    "CompressedTable",
    "compress_table",
    "cc_join",
    "concat_tables",
    "r_lower",
]


@dataclasses.dataclass
class Ragged:
    """Per-group sorted value sets: group g owns ``values[offsets[g]:offsets[g+1]]``."""

    offsets: np.ndarray  # int64 [g + 1]
    values: np.ndarray   # int64 [total]

    @property
    def n_groups(self) -> int:
        return int(self.offsets.shape[0] - 1)

    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    @staticmethod
    def from_group_ids(gids: np.ndarray, values: np.ndarray, n_groups: int) -> "Ragged":
        order = np.lexsort((values, gids))
        gids, values = gids[order], values[order]
        offsets = np.zeros(n_groups + 1, dtype=np.int64)
        np.add.at(offsets, gids + 1, 1)
        return Ragged(offsets=np.cumsum(offsets), values=values)

    def fused(self) -> np.ndarray:
        """``gid << 32 | value`` — sorted; supports batched membership tests."""
        gids = np.repeat(np.arange(self.n_groups, dtype=np.int64), self.counts())
        return (gids << np.int64(32)) | self.values


@dataclasses.dataclass
class CompressedTable:
    """Compressed matches ``{f|s}`` of ``pattern`` under the global cover."""

    pattern: Pattern
    cover: Tuple[int, ...]              # global V_c(p) (full-pattern labels)
    skeleton_cols: Tuple[int, ...]      # sorted(V_c(p) ∩ V(pattern))
    skeleton: np.ndarray                # int64 [g, n_skel_cols]
    comp: Dict[int, Ragged]             # compressed vertex label → per-group sets

    # ------------------------------------------------------------------ stats
    @property
    def n_groups(self) -> int:
        return int(self.skeleton.shape[0])

    def storage_ints(self) -> int:
        """The paper's integer-count storage metric S(p_i)."""
        total = self.n_groups * len(self.skeleton_cols)
        for r in self.comp.values():
            total += int(r.values.shape[0])
        return total

    def _expand_vertex(self, table, gids, cols, v, ord_, materialize=True):
        """Expand one compressed vertex with injectivity + ord filtering.

        Returns ``(table', gids')`` when ``materialize`` else only the
        surviving row count (skipping the concatenate, the expensive
        part of the final expansion step).
        """
        r = self.comp[v]
        starts = r.offsets[gids]
        counts = r.offsets[gids + 1] - starts
        rep, vals = ragged_expand(starts, counts, r.values)
        tb = table[rep]
        mask = np.ones(vals.shape[0], dtype=bool)
        for j, c in enumerate(cols):
            mask &= vals != tb[:, j]  # injectivity
            for a, b in ord_:
                if (a, b) == (v, c):
                    mask &= vals < tb[:, j]
                elif (a, b) == (c, v):
                    mask &= vals > tb[:, j]
        if not materialize:
            return int(np.count_nonzero(mask))
        return (np.concatenate([tb[mask], vals[mask][:, None]], axis=1),
                gids[rep][mask])

    def count_matches(self, ord_: Sequence[Tuple[int, int]] = ()) -> int:
        """|M| without materializing the decompressed table.

        Same expansion as :meth:`decompress` but the last (largest) step
        only counts — matters when the streaming service polls counts of
        multi-million-row match sets every batch.
        """
        comp_vs = sorted(self.comp.keys())
        if not comp_vs:
            return self.n_groups
        cols = list(self.skeleton_cols)
        table = self.skeleton
        gids = np.arange(self.n_groups, dtype=np.int64)
        for v in comp_vs[:-1]:
            table, gids = self._expand_vertex(table, gids, cols, v, ord_)
            cols.append(v)
        return self._expand_vertex(table, gids, cols, comp_vs[-1], ord_,
                                   materialize=False)

    # ------------------------------------------------------------ decompress
    def decompress(self, ord_: Sequence[Tuple[int, int]] = ()) -> Tuple[Tuple[int, ...], np.ndarray]:
        """Cartesian-expand per group with injectivity + ord filtering (§IV-B)."""
        comp_vs = sorted(self.comp.keys())
        cols = list(self.skeleton_cols)
        table = self.skeleton
        gids = np.arange(self.n_groups, dtype=np.int64)
        for v in comp_vs:
            table, gids = self._expand_vertex(table, gids, cols, v, ord_)
            cols.append(v)
        out_cols = tuple(sorted(self.pattern.vertices))
        perm = [cols.index(c) for c in out_cols]
        return out_cols, (table[:, perm] if table.size else np.empty((0, len(out_cols)), np.int64))


def compress_table(
    pattern: Pattern,
    cover: Sequence[int],
    cols: Sequence[int],
    table: np.ndarray,
) -> CompressedTable:
    """Group a plain match table by its skeleton columns (§IV-A)."""
    cover = tuple(sorted(cover))
    vset = set(pattern.vertices)
    skel_cols = tuple(c for c in sorted(cover) if c in vset)
    comp_cols = tuple(c for c in sorted(pattern.vertices) if c not in skel_cols)
    col_of = {c: i for i, c in enumerate(cols)}
    skel = table[:, [col_of[c] for c in skel_cols]] if table.shape[0] else np.empty((0, len(skel_cols)), np.int64)
    if table.shape[0] == 0:
        return CompressedTable(
            pattern=pattern, cover=cover, skeleton_cols=skel_cols,
            skeleton=skel,
            comp={c: Ragged(np.zeros(1, np.int64), np.empty(0, np.int64)) for c in comp_cols},
        )
    uniq, inv = np.unique(skel, axis=0, return_inverse=True)
    comp = {}
    for c in comp_cols:
        vals = table[:, col_of[c]]
        # dedup (group, value) pairs
        fused = (inv.astype(np.int64) << np.int64(32)) | vals
        fu = np.unique(fused)
        g = fu >> np.int64(32)
        vv = fu & np.int64(0xFFFFFFFF)
        comp[c] = Ragged.from_group_ids(g, vv, uniq.shape[0])
    return CompressedTable(pattern=pattern, cover=cover, skeleton_cols=skel_cols, skeleton=uniq, comp=comp)


def concat_tables(tables: List[CompressedTable]) -> CompressedTable:
    """Union of compressed tables of the *same* pattern (e.g. per-partition
    ``M_ac`` shards, which are disjoint by Lemma 3.1)."""
    assert tables, "need at least one table"
    t0 = tables[0]
    if len(tables) == 1:
        return t0
    skel = np.concatenate([t.skeleton for t in tables], axis=0)
    comp: Dict[int, Ragged] = {}
    offset = 0
    parts: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {v: [] for v in t0.comp}
    for t in tables:
        for v, r in t.comp.items():
            gids = np.repeat(np.arange(r.n_groups, dtype=np.int64), r.counts()) + offset
            parts[v].append((gids, r.values))
        offset += t.n_groups
    for v, chunks in parts.items():
        g = np.concatenate([c[0] for c in chunks]) if chunks else np.empty(0, np.int64)
        vv = np.concatenate([c[1] for c in chunks]) if chunks else np.empty(0, np.int64)
        comp[v] = Ragged.from_group_ids(g, vv, skel.shape[0])
    return CompressedTable(pattern=t0.pattern, cover=t0.cover, skeleton_cols=t0.skeleton_cols, skeleton=skel, comp=comp)


# ---------------------------------------------------------------------------
# CC-join (Alg. 2)
# ---------------------------------------------------------------------------

def _key_ids(k1: np.ndarray, k2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dense integer ids for multi-column join keys across both sides."""
    both = np.concatenate([k1, k2], axis=0)
    _, inv = np.unique(both, axis=0, return_inverse=True)
    return inv[: k1.shape[0]].astype(np.int64), inv[k1.shape[0] :].astype(np.int64)


def _apply_value_checks(
    vals: np.ndarray,
    pair_rows: np.ndarray,
    s3: np.ndarray,
    checks,
) -> np.ndarray:
    """Per-value validity vs the new skeleton columns (plan-IR checks)."""
    mask = np.ones(vals.shape[0], dtype=bool)
    for col_idx, mode in checks:
        col = s3[pair_rows, col_idx]
        if mode == plan_ir.NEQ:
            mask &= vals != col
        elif mode == plan_ir.LT:
            mask &= vals < col
        else:
            mask &= vals > col
    return mask


def cc_join(
    t1: CompressedTable,
    t2: CompressedTable,
    ord_: Sequence[Tuple[int, int]] = (),
    plan: "plan_ir.JoinPlan | None" = None,
) -> CompressedTable:
    """Join two consistently-compressed tables (paper Alg. 2).

    The join structure (key columns, output skeleton, cross-side masks,
    per-compressed-vertex value checks) comes from the shared
    :class:`repro_torch.core.plan.JoinPlan` IR — the same plan the device
    engine (``repro_torch.engine.ccjoin_local``) executes.
    """
    assert t1.cover == t2.cover, "CC-join requires a shared global cover"
    if plan is None:
        plan = plan_ir.JoinPlan.make(t1.pattern, t2.pattern, t1.cover, ord_)
    assert plan.left_skel == t1.skeleton_cols and plan.right_skel == t2.skeleton_cols
    s3_cols = plan.skel_out

    k1 = t1.skeleton[:, list(plan.key_left_idx)]
    k2 = t2.skeleton[:, list(plan.key_right_idx)]
    id1, id2 = _key_ids(k1, k2)

    # Sort side-2 groups by key id and pair every side-1 group with the
    # matching contiguous run (repeat/gather — the MapReduce shuffle analog).
    order2 = np.argsort(id2, kind="stable")
    id2s = id2[order2]
    starts = np.searchsorted(id2s, id1, side="left")
    ends = np.searchsorted(id2s, id1, side="right")
    rep1, pos2 = ragged_expand(starts, ends - starts, order2)
    # rep1: row into t1.skeleton; pos2: row into t2.skeleton

    # --- assemble the joined skeleton ----------------------------------------
    s3 = np.empty((rep1.shape[0], len(s3_cols)), dtype=np.int64)
    for out_j, left_j in plan.out_from_left:
        s3[:, out_j] = t1.skeleton[rep1, left_j]
    for out_j, right_j in plan.out_from_right:
        s3[:, out_j] = t2.skeleton[pos2, right_j]

    # injectivity across the two skeleton halves + cross-side ord pairs
    mask = np.ones(s3.shape[0], dtype=bool)
    for ja, jb in plan.pair_neq:
        mask &= s3[:, ja] != s3[:, jb]
    for ja, jb in plan.pair_ord:
        mask &= s3[:, ja] < s3[:, jb]
    rep1, pos2, s3 = rep1[mask], pos2[mask], s3[mask]
    n_pairs = s3.shape[0]

    # --- compressed vertices --------------------------------------------------
    comp: Dict[int, Ragged] = {}
    for cp in plan.comp:
        v = cp.vertex
        if cp.source == "both":
            r1, r2 = t1.comp[v], t2.comp[v]
            st = r1.offsets[rep1]
            ct = r1.offsets[rep1 + 1] - st
            prow, vals = ragged_expand(st, ct, r1.values)
            # membership in side-2 set of the paired group
            fused_set = (np.repeat(np.arange(r2.n_groups, dtype=np.int64), r2.counts()) << np.int64(32)) | r2.values
            q = (pos2[prow] << np.int64(32)) | vals
            pos = np.clip(np.searchsorted(fused_set, q), 0, max(fused_set.shape[0] - 1, 0))
            keep = fused_set[pos] == q if fused_set.size else np.zeros(q.shape, bool)
            prow, vals = prow[keep], vals[keep]
        elif cp.source == "left":
            r1 = t1.comp[v]
            st = r1.offsets[rep1]
            ct = r1.offsets[rep1 + 1] - st
            prow, vals = ragged_expand(st, ct, r1.values)
        else:
            r2 = t2.comp[v]
            st = r2.offsets[pos2]
            ct = r2.offsets[pos2 + 1] - st
            prow, vals = ragged_expand(st, ct, r2.values)
        keep = _apply_value_checks(vals, prow, s3, cp.checks)
        comp[v] = Ragged.from_group_ids(prow[keep], vals[keep], n_pairs)

    out = CompressedTable(pattern=plan.pattern, cover=t1.cover, skeleton_cols=s3_cols, skeleton=s3, comp=comp)
    return _drop_empty_groups(out)


def _drop_empty_groups(t: CompressedTable) -> CompressedTable:
    """Remove skeleton rows where any compressed vertex has an empty set."""
    if not t.comp or t.n_groups == 0:
        return t
    alive = np.ones(t.n_groups, dtype=bool)
    for r in t.comp.values():
        alive &= r.counts() > 0
    if alive.all():
        return t
    keep = np.nonzero(alive)[0]
    remap = -np.ones(t.n_groups, dtype=np.int64)
    remap[keep] = np.arange(keep.shape[0])
    comp = {}
    for v, r in t.comp.items():
        gids = np.repeat(np.arange(r.n_groups, dtype=np.int64), r.counts())
        sel = alive[gids]
        comp[v] = Ragged.from_group_ids(remap[gids[sel]], r.values[sel], keep.shape[0])
    return CompressedTable(
        pattern=t.pattern, cover=t.cover, skeleton_cols=t.skeleton_cols,
        skeleton=t.skeleton[keep], comp=comp,
    )


# ---------------------------------------------------------------------------
# Compression-ratio lower bound (Thm. 4.1)
# ---------------------------------------------------------------------------

def r_lower(n_pattern: int, n_cover: int, m_pattern: float, m_cover: float) -> float:
    """``R_lower`` from Thm. 4.1 given |V(p)|, |V_c(p)|, |M(p,d)|, |M(p[V_c],d)|."""
    num = n_pattern * m_pattern
    den = n_pattern * m_pattern + n_cover * max(m_cover - m_pattern, 0.0)
    return float(num / den) if den > 0 else 1.0
