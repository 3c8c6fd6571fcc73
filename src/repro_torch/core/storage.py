"""Neighbor-Preserved (NP) storage ``Φ(d)`` — paper §III-B.

Host copy (NumPy only) of the build half of ``repro/core/storage.py``:
:class:`PartitionFn`, :class:`Partition`, :class:`NPStorage` and
:func:`build_np_storage`. Partition ``j`` stores every edge ``(a, b)`` with
``h(a) = j ∨ h(b) = j ∨ ∃ z ∈ CN(a, b) : h(z) = j``. The batch update runs
on the device (:mod:`repro_torch.sharded`).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .graph import Graph, decode_edges

__all__ = ["PartitionFn", "Partition", "NPStorage", "build_np_storage"]


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
