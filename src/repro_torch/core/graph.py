"""Undirected data graph in CSR form with sorted int64 edge codes.

Host copy (NumPy only) of the parts of ``repro/core/graph.py`` the port
uses: :class:`Graph`, :class:`GraphUpdate`, :func:`edge_codes`,
:func:`decode_edges` and :meth:`Graph.apply_update`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = ["Graph", "GraphUpdate", "edge_codes", "decode_edges"]

_SHIFT = np.int64(32)


def edge_codes(edges: np.ndarray) -> np.ndarray:
    """Copy of ``repro.core.graph.edge_codes``: ``[m, 2]`` edges → ``(min << 32) | max``."""
    edges = np.asarray(edges, dtype=np.int64)
    if edges.size == 0:
        return np.empty((0,), dtype=np.int64)
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    return (lo << _SHIFT) | hi


def decode_edges(codes: np.ndarray) -> np.ndarray:
    """Copy of ``repro.core.graph.decode_edges``: codes → ``[m, 2]``, min in column 0."""
    codes = np.asarray(codes, dtype=np.int64)
    lo = codes >> _SHIFT
    hi = codes & np.int64(0xFFFFFFFF)
    return np.stack([lo, hi], axis=1)


@dataclasses.dataclass(frozen=True)
class GraphUpdate:
    """Copy of ``repro.core.graph.GraphUpdate``: a batch ``(E_d, E_a)``."""

    delete: np.ndarray  # [k, 2] int64
    add: np.ndarray  # [l, 2] int64

    @staticmethod
    def make(delete: Iterable[Sequence[int]] = (), add: Iterable[Sequence[int]] = ()) -> "GraphUpdate":
        d = np.asarray(list(delete), dtype=np.int64).reshape(-1, 2)
        a = np.asarray(list(add), dtype=np.int64).reshape(-1, 2)
        return GraphUpdate(delete=d, add=a)

    def delete_codes(self) -> np.ndarray:
        return np.sort(edge_codes(self.delete))

    def add_codes(self) -> np.ndarray:
        return np.sort(edge_codes(self.add))


class Graph:
    """Copy of ``repro.core.graph.Graph``: immutable CSR over int64 ids."""

    __slots__ = ("n", "indptr", "indices", "codes", "_degrees")

    def __init__(self, n: int, indptr: np.ndarray, indices: np.ndarray, codes: np.ndarray):
        self.n = int(n)
        self.indptr = indptr
        self.indices = indices
        self.codes = codes
        self._degrees = np.diff(indptr)

    @staticmethod
    def from_edges(edges: np.ndarray | Iterable[Sequence[int]], n: int | None = None) -> "Graph":
        edges = np.asarray(list(edges) if not isinstance(edges, np.ndarray) else edges, dtype=np.int64)
        edges = edges.reshape(-1, 2)
        edges = edges[edges[:, 0] != edges[:, 1]]
        codes = np.unique(edge_codes(edges)) if edges.size else np.empty((0,), np.int64)
        und = decode_edges(codes)
        if n is None:
            n = int(und.max()) + 1 if und.size else 0
        return Graph._from_codes(int(n), codes)

    @staticmethod
    def _from_codes(n: int, codes: np.ndarray) -> "Graph":
        und = decode_edges(codes)
        src = np.concatenate([und[:, 0], und[:, 1]])
        dst = np.concatenate([und[:, 1], und[:, 0]])
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return Graph(n, indptr, dst, codes)

    @property
    def num_edges(self) -> int:
        return int(self.codes.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return self._degrees

    def edges(self) -> np.ndarray:
        return decode_edges(self.codes)

    def has_edges(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Vectorized edge membership for aligned id arrays."""
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        q = (np.minimum(u, v) << _SHIFT) | np.maximum(u, v)
        if not self.codes.size:
            return np.zeros(q.shape, dtype=bool)
        pos = np.clip(np.searchsorted(self.codes, q), 0, self.codes.shape[0] - 1)
        return self.codes[pos] == q

    def degree_histogram(self) -> np.ndarray:
        """``hist[w]`` = #vertices with degree ``w`` (the estimator's input)."""
        if self.n == 0:
            return np.zeros(1, dtype=np.int64)
        return np.bincount(self._degrees)

    def apply_update(self, update: GraphUpdate) -> "Graph":
        """Return ``d' = d ⊖ E_d ⊕ E_a`` (ids may grow ``n``)."""
        del_codes = update.delete_codes()
        add_codes = update.add_codes()
        keep = self.codes[~np.isin(self.codes, del_codes)] if del_codes.size else self.codes
        merged = np.unique(np.concatenate([keep, add_codes])) if add_codes.size else keep
        n = self.n
        if update.add.size:
            n = max(n, int(update.add.max()) + 1)
        return Graph._from_codes(n, merged)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Graph(n={self.n}, m={self.num_edges})"
