"""R-MAT graphs, batch updates and padded GNN graphs.

Host copy (NumPy only) of ``rmat_graph``, ``sample_update`` and
``build_graph_data`` from ``repro/data/graphs.py``. Each draws from
``numpy.random.default_rng(seed)`` exactly as the original does, so a seed
gives the same arrays in both packages.
"""

from __future__ import annotations

import numpy as np

from ..core.graph import Graph, GraphUpdate

__all__ = ["rmat_graph", "sample_update", "build_graph_data"]


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


def build_graph_data(n_nodes: int, n_edges: int, d_feat: int, d_edge: int = 0,
                     seed: int = 0, pad_nodes: int | None = None,
                     pad_edges: int | None = None, geometric: bool = False):
    """Copy of ``repro.data.graphs.build_graph_data``: padded GraphData
    arrays (NumPy) for the GNN models, uniform random edges."""
    rng = np.random.default_rng(seed)
    pn = pad_nodes or n_nodes
    pe = pad_edges or n_edges
    x = np.zeros((pn, d_feat), np.float32)
    x[:n_nodes] = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    src = np.full(pe, pn - 1, np.int32)
    dst = np.full(pe, pn - 1, np.int32)
    src[:n_edges] = rng.integers(0, n_nodes, n_edges)
    dst[:n_edges] = rng.integers(0, n_nodes, n_edges)
    ea = np.zeros((pe, max(d_edge, 1)), np.float32)
    if d_edge:
        ea[:n_edges] = rng.normal(size=(n_edges, d_edge)).astype(np.float32)
    nm = np.zeros(pn, bool)
    nm[:n_nodes] = True
    em = np.zeros(pe, bool)
    em[:n_edges] = True
    pos = np.zeros((pn, 3), np.float32)
    if geometric:
        pos[:n_nodes] = rng.normal(size=(n_nodes, 3)).astype(np.float32)
    return dict(x=x, src=src, dst=dst, edge_attr=ea, node_mask=nm, edge_mask=em, positions=pos)
