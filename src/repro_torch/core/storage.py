"""Neighbor-Preserved (NP) storage ``Φ(d)`` — paper §III-B and Alg. 4.

Host copy (NumPy only) of ``repro/core/storage.py``: :class:`PartitionFn`,
:class:`Partition`, :class:`NPStorage`, :func:`build_np_storage`, and the
host batch update :func:`update_np_storage` with its
:class:`UpdateCostReport`. Partition ``j`` stores every edge ``(a, b)`` with
``h(a) = j ∨ h(b) = j ∨ ∃ z ∈ CN(a, b) : h(z) = j``. The update implements
Alg. 4 cases C1–C3 with batch semantics (candidate membership changes
validated against ``d'``), so its result equals a rebuild of ``Φ(d')``; the
streaming service's host backend and the host ``DDSL`` run it, the device
backend runs :mod:`repro_torch.sharded`'s twin.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .graph import Graph, GraphUpdate, decode_edges, edge_codes

__all__ = ["PartitionFn", "Partition", "NPStorage", "build_np_storage", "update_np_storage",
           "UpdateCostReport"]


class PartitionFn:
    """Copy of ``repro.core.storage.PartitionFn``: vertex id → partition id (``id % m``)."""

    def __init__(self, m: int, table: np.ndarray | None = None):
        self.m = int(m)
        self.table = None if table is None else np.asarray(table, dtype=np.int64)

    def __call__(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        if self.table is None:
            return ids % self.m
        out = np.where(ids < self.table.shape[0],
                       self.table[np.minimum(ids, self.table.shape[0] - 1)], ids % self.m)
        return out.astype(np.int64)

    def rebalanced(self, new_assignment: Dict[int, int]) -> "PartitionFn":
        """Return a copy with explicit overrides (straggler rebalancing)."""
        size = max(new_assignment.keys(), default=-1) + 1
        base = self.table if self.table is not None else np.arange(size, dtype=np.int64) % self.m
        if base.shape[0] < size:
            ext = np.arange(base.shape[0], size, dtype=np.int64) % self.m
            base = np.concatenate([base, ext])
        tab = base.copy()
        for k, v in new_assignment.items():
            tab[k] = v
        return PartitionFn(self.m, tab)


@dataclasses.dataclass
class Partition:
    """Copy of ``repro.core.storage.Partition``: one part ``d_j`` as a local CSR,
    with the views the host listing engine reads (centers, local ids,
    degrees, edge membership)."""

    pid: int
    vertices: np.ndarray      # sorted global ids appearing in this part
    center_mask: np.ndarray   # bool per local vertex: h(v) == pid
    indptr: np.ndarray        # local CSR row pointers
    indices: np.ndarray       # neighbor GLOBAL ids, sorted per row
    codes: np.ndarray         # sorted edge codes of E_j

    @property
    def num_edges(self) -> int:
        return int(self.codes.shape[0])

    def center_vertices(self) -> np.ndarray:
        return self.vertices[self.center_mask]

    def local_ids(self, global_ids: np.ndarray) -> np.ndarray:
        """Map global → local ids (must be present)."""
        return np.searchsorted(self.vertices, global_ids)

    def contains(self, global_ids: np.ndarray) -> np.ndarray:
        g = np.asarray(global_ids, dtype=np.int64)
        if self.vertices.size == 0:
            return np.zeros(g.shape, bool)
        pos = np.clip(np.searchsorted(self.vertices, g), 0, self.vertices.shape[0] - 1)
        return self.vertices[pos] == g

    def neighbors(self, u: int) -> np.ndarray:
        lid = int(np.searchsorted(self.vertices, u))
        if lid >= self.vertices.shape[0] or self.vertices[lid] != u:
            return self.indices[:0]
        return self.indices[self.indptr[lid]: self.indptr[lid + 1]]

    def degrees_of(self, global_ids: np.ndarray) -> np.ndarray:
        lids = self.local_ids(global_ids)
        return (self.indptr[lids + 1] - self.indptr[lids]).astype(np.int64)

    def has_edges(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        q = (np.minimum(u, v) << np.int64(32)) | np.maximum(u, v)
        if not self.codes.size:
            return np.zeros(q.shape, bool)
        pos = np.clip(np.searchsorted(self.codes, q), 0, self.codes.shape[0] - 1)
        return self.codes[pos] == q

    @staticmethod
    def from_codes(pid: int, codes: np.ndarray, centers: np.ndarray) -> "Partition":
        und = decode_edges(np.sort(codes))
        verts = np.unique(np.concatenate([und.reshape(-1), centers.astype(np.int64)]))
        src = np.concatenate([und[:, 0], und[:, 1]])
        dst = np.concatenate([und[:, 1], und[:, 0]])
        lsrc = np.searchsorted(verts, src)
        order = np.lexsort((dst, lsrc))
        lsrc, dst = lsrc[order], dst[order]
        indptr = np.zeros(verts.shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, lsrc + 1, 1)
        indptr = np.cumsum(indptr)
        cmask = np.zeros(verts.shape[0], dtype=bool)
        cmask[np.searchsorted(verts, centers)] = True if centers.size else False
        return Partition(pid=pid, vertices=verts, center_mask=cmask, indptr=indptr,
                         indices=dst, codes=np.sort(codes))


@dataclasses.dataclass
class NPStorage:
    """Copy of ``repro.core.storage.NPStorage``: ``Φ(d)`` plus the partition function."""

    graph: Graph
    h: PartitionFn
    parts: List[Partition]

    @property
    def m(self) -> int:
        return self.h.m

    def total_stored_edges(self) -> int:
        return int(sum(p.num_edges for p in self.parts))

    def updated(self, update: GraphUpdate) -> Tuple["NPStorage", "UpdateCostReport"]:
        """Apply one batch update → ``(Φ(d'), cost)`` (Alg. 4): the
        streaming scheduler's shared-delta entry point, called once per
        micro-batch."""
        return update_np_storage(self, update)

    def space_report(self) -> Dict[str, int]:
        e = self.graph.num_edges
        tri = self.graph.triangle_count()
        stored = self.total_stored_edges()
        return {
            "edges": e,
            "triangles": tri,
            "stored_edges": stored,
            "bound": int(min(2 * e + 3 * tri, self.m * e)),
            "overhead_ratio_x1000": int(0 if e == 0 else stored * 1000 // e),
        }


def _edge_part_memberships(graph: Graph, h: PartitionFn, chunk: int = 1 << 18):
    """Copy of ``repro.core.storage._edge_part_memberships``: (edge code, part)
    pairs for every edge, triangle copies included."""
    und = graph.edges()
    if und.shape[0] == 0:
        return np.empty((0,), np.int64), np.empty((0,), np.int64)
    deg = graph.degrees
    swap = deg[und[:, 0]] > deg[und[:, 1]]
    a = np.where(swap, und[:, 1], und[:, 0])
    b = np.where(swap, und[:, 0], und[:, 1])
    codes = graph.codes
    mem_codes = [codes, codes]  # endpoint copies
    mem_parts = [h(und[:, 0]), h(und[:, 1])]
    dega = deg[a]
    starts = graph.indptr[a]
    begin = 0
    m_edges = und.shape[0]
    while begin < m_edges:
        end = min(m_edges, begin + chunk)
        da = dega[begin:end]
        rep = np.repeat(np.arange(begin, end), da)
        offs = np.arange(da.sum()) - np.repeat(np.cumsum(da) - da, da)
        w = graph.indices[np.repeat(starts[begin:end], da) + offs]
        bb = b[rep]
        ok = (w != bb) & graph.has_edges(w, bb)
        rep, w = rep[ok], w[ok]
        mem_codes.append(codes[rep])
        mem_parts.append(h(w))
        begin = end
    return np.concatenate(mem_codes), np.concatenate(mem_parts)


def build_np_storage(graph: Graph, m: int, h: PartitionFn | None = None) -> NPStorage:
    """Copy of ``repro.core.storage.build_np_storage``: ``Φ(d)`` over ``m`` parts."""
    h = h if h is not None else PartitionFn(m)
    assert h.m == m
    mem_codes, mem_parts = _edge_part_memberships(graph, h)
    if mem_codes.size:
        combo = np.unique(np.stack([mem_parts, mem_codes], axis=1), axis=0)
        mem_parts, mem_codes = combo[:, 0], combo[:, 1]
    all_ids = np.arange(graph.n, dtype=np.int64)
    hv = h(all_ids)
    parts = []
    for j in range(m):
        pc = mem_codes[mem_parts == j]
        centers = all_ids[hv == j]
        parts.append(Partition.from_codes(j, pc, centers))
    return NPStorage(graph=graph, h=h, parts=parts)


@dataclasses.dataclass
class UpdateCostReport:
    """Copy of ``repro.core.storage.UpdateCostReport``: the instrumented
    analogue of the paper's Alg.-4 cost formula."""

    shuffled_neighbor_ints: int = 0   # Σ |N_{d'}(u_i)| messages (map → reduce)
    edges_removed: int = 0
    edges_added: int = 0
    # Partitions whose stored edge set E_j actually changed under this
    # batch — the exact invalidation set for anything derived from a
    # single partition (per-partition unit-match tables cache on this:
    # equal edge sets ⇒ identical Φ(d')_j ⇒ identical listings).
    dirty_parts: Tuple[int, ...] = ()


def update_np_storage(storage: NPStorage, update: GraphUpdate) -> Tuple[NPStorage, UpdateCostReport]:
    """Copy of ``repro.core.storage.update_np_storage``: a batch update of
    ``Φ(d)``; returns ``Φ(d')`` (equal to a rebuild) and the cost report."""
    g = storage.graph
    h = storage.h
    m = storage.m
    d_codes = update.delete_codes()
    a_codes = update.add_codes()
    if np.intersect1d(d_codes, a_codes).size:
        raise ValueError("E_d(U) and E_a(U) must be disjoint")
    missing = ~np.isin(d_codes, g.codes)
    if missing.any():
        raise ValueError(f"deleting non-existent edges: {decode_edges(d_codes[missing])[:4]}")
    already = np.isin(a_codes, g.codes)
    if already.any():
        raise ValueError(f"inserting existing edges: {decode_edges(a_codes[already])[:4]}")

    g2 = g.apply_update(update)
    report = UpdateCostReport()

    # --- candidate additions per part: (code, part) pairs -------------------
    add_codes: List[np.ndarray] = []
    add_parts: List[np.ndarray] = []
    for code in a_codes:
        ab = decode_edges(np.array([code]))[0]
        a_, b_ = int(ab[0]), int(ab[1])
        ha, hb = int(h(np.array([a_]))[0]), int(h(np.array([b_]))[0])
        z = g2.common_neighbors(a_, b_)
        hz = h(z)
        # (a,b) goes to h(a), h(b), h(z)∀z
        tgt = np.concatenate([[ha, hb], hz])
        add_codes.append(np.full(tgt.shape, code, np.int64))
        add_parts.append(tgt.astype(np.int64))
        # triangle closure: (b,z) -> h(a), (a,z) -> h(b)
        if z.size:
            bz = edge_codes(np.stack([np.full(z.shape, b_), z], axis=1))
            az = edge_codes(np.stack([np.full(z.shape, a_), z], axis=1))
            add_codes.extend([bz, az])
            add_parts.extend([np.full(z.shape, ha, np.int64), np.full(z.shape, hb, np.int64)])
        # cost model: cross-partition inserts ship N_{d'} of each endpoint
        if ha != hb:
            report.shuffled_neighbor_ints += int(g2.degrees[a_] + g2.degrees[b_])

    # --- candidate removals per part ----------------------------------------
    rm_codes: List[np.ndarray] = []
    rm_parts: List[np.ndarray] = []
    for code in d_codes:
        ab = decode_edges(np.array([code]))[0]
        a_, b_ = int(ab[0]), int(ab[1])
        ha, hb = int(h(np.array([a_]))[0]), int(h(np.array([b_]))[0])
        z = g.common_neighbors(a_, b_)  # triangles in d (pre-update)
        hz = h(z)
        # (a,b) leaves every part it was in.
        tgt = np.concatenate([[ha, hb], hz])
        rm_codes.append(np.full(tgt.shape, code, np.int64))
        rm_parts.append(tgt.astype(np.int64))
        # broken triangle closures: (b,z) may leave h(a); (a,z) may leave h(b)
        if z.size:
            bz = edge_codes(np.stack([np.full(z.shape, b_), z], axis=1))
            az = edge_codes(np.stack([np.full(z.shape, a_), z], axis=1))
            rm_codes.extend([bz, az])
            rm_parts.extend([np.full(z.shape, ha, np.int64), np.full(z.shape, hb, np.int64)])

    def _validate(codes: np.ndarray, parts_: np.ndarray) -> np.ndarray:
        """True where edge `codes[i]` belongs to part `parts_[i]` in d'."""
        if codes.size == 0:
            return np.zeros((0,), bool)
        exists = np.isin(codes, g2.codes)
        und = decode_edges(codes)
        keep = exists & ((h(und[:, 0]) == parts_) | (h(und[:, 1]) == parts_))
        # common-neighbor reason (only needed where not yet kept)
        todo = np.nonzero(exists & ~keep)[0]
        for i in todo:
            z = g2.common_neighbors(int(und[i, 0]), int(und[i, 1]))
            if z.size and np.any(h(z) == parts_[i]):
                keep[i] = True
        return keep

    def _pairs(codes_l: List[np.ndarray], parts_l: List[np.ndarray]):
        if not codes_l:
            return np.empty((0,), np.int64), np.empty((0,), np.int64)
        c = np.concatenate(codes_l)
        p = np.concatenate(parts_l)
        combo = np.unique(np.stack([p, c], axis=1), axis=0)
        return combo[:, 1], combo[:, 0]

    acand, apart = _pairs(add_codes, add_parts)
    rcand, rpart = _pairs(rm_codes, rm_parts)
    a_ok = _validate(acand, apart) if acand.size else np.zeros((0,), bool)
    r_keep = _validate(rcand, rpart) if rcand.size else np.zeros((0,), bool)

    all_ids = np.arange(g2.n, dtype=np.int64)
    hv = h(all_ids)
    new_parts: List[Partition] = []
    dirty: List[int] = []
    for j in range(m):
        old = storage.parts[j].codes
        rm_j = rcand[(rpart == j) & ~r_keep]
        ad_j = acand[(apart == j) & a_ok]
        kept = old[~np.isin(old, rm_j)] if rm_j.size else old
        codes_j = np.unique(np.concatenate([kept, ad_j])) if ad_j.size else kept
        centers = all_ids[hv == j]
        new_parts.append(Partition.from_codes(j, codes_j, centers))
        removed_j = int(old.size - kept.size)
        added_j = int(codes_j.size - kept.size)
        report.edges_removed += removed_j
        report.edges_added += added_j
        if removed_j or added_j:
            dirty.append(j)
    report.dirty_parts = tuple(dirty)

    return NPStorage(graph=g2, h=h, parts=new_parts), report
