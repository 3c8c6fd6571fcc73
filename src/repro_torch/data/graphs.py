"""R-MAT graphs and batch updates.

Host copy (NumPy only) of ``rmat_graph`` and ``sample_update`` from
``repro/data/graphs.py``. Both draw from ``numpy.random.default_rng(seed)``
exactly as the originals do, so a seed gives the same graph and the same
batch in both packages.
"""

from __future__ import annotations

import numpy as np

from ..core.graph import Graph, GraphUpdate

__all__ = ["rmat_graph", "sample_update"]


def rmat_graph(n_log2: int, n_edges: int, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19) -> Graph:
    """Copy of ``repro.data.graphs.rmat_graph``: R-MAT power-law graph."""
    rng = np.random.default_rng(seed)
    n = 1 << n_log2
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    for bit in range(n_log2):
        r = rng.random(n_edges)
        src_bit = (r >= a + b) & (r < a + b + c) | (r >= a + b + c)
        dst_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    mask = src != dst
    return Graph.from_edges(np.stack([src[mask], dst[mask]], 1), n=n)


def sample_update(graph: Graph, n_delete: int, n_add: int, seed: int = 0) -> GraphUpdate:
    """Copy of ``repro.data.graphs.sample_update``: random existing deletions
    + random fresh inserts (paper §VII-C)."""
    rng = np.random.default_rng(seed)
    edges = graph.edges()
    didx = rng.choice(edges.shape[0], size=min(n_delete, edges.shape[0]), replace=False)
    dele = edges[didx]
    codes = set(graph.codes.tolist())
    add = []
    while len(add) < n_add:
        a_, b_ = rng.integers(graph.n, size=2)
        if a_ == b_:
            continue
        code = (min(int(a_), int(b_)) << 32) | max(int(a_), int(b_))
        if code in codes:
            continue
        codes.add(code)
        add.append((min(int(a_), int(b_)), max(int(a_), int(b_))))
    return GraphUpdate(delete=dele, add=np.asarray(add, np.int64).reshape(-1, 2))
