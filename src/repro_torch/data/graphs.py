"""R-MAT and planted near-clique graphs, batch updates and padded GNN graphs.

Host copy (NumPy only) of ``rmat_graph``, ``sample_update``,
``build_graph_data`` and ``NeighborSampler`` from ``repro/data/graphs.py``,
and of ``planted_graph``
from ``benchmarks/bench_wcoj.py``. Each draws from
``numpy.random.default_rng(seed)`` exactly as the original does, so a seed
gives the same arrays in both packages.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.graph import Graph, GraphUpdate

__all__ = ["rmat_graph", "planted_graph", "sample_update", "build_graph_data",
           "NeighborSampler"]

# The planted near-clique graph: a uniform background of PLANTED_M_BG edges
# over PLANTED_N vertices and an Erdős–Rényi core of PLANTED_CORE_K vertices
# with edge probability PLANTED_CORE_P, which holds the cliques.
PLANTED_N, PLANTED_M_BG, PLANTED_CORE_K, PLANTED_CORE_P = 4096, 12000, 32, 0.8


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


def planted_graph(seed: int = 0) -> Graph:
    """Copy of ``benchmarks.bench_wcoj.planted_graph``: the near-clique graph
    on which the generic join beats join trees (K4/K5 counts in the
    thousands, almost all in the core)."""
    rng = np.random.default_rng(seed)
    edges = set()
    while len(edges) < PLANTED_M_BG:
        a, b = int(rng.integers(PLANTED_N)), int(rng.integers(PLANTED_N))
        if a != b:
            edges.add((min(a, b), max(a, b)))
    core = rng.choice(PLANTED_N, size=PLANTED_CORE_K, replace=False)
    for i in range(PLANTED_CORE_K):
        for j in range(i + 1, PLANTED_CORE_K):
            if rng.random() < PLANTED_CORE_P:
                a, b = int(core[i]), int(core[j])
                edges.add((min(a, b), max(a, b)))
    return Graph.from_edges(np.array(sorted(edges), np.int64), n=PLANTED_N)


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


class NeighborSampler:
    """Copy of ``repro.data.graphs.NeighborSampler``: uniform k-hop neighbour
    sampling over the graph's CSR (GraphSAGE ``minibatch_lg``), fixed
    fanouts with replacement, so every frontier has a static shape; an
    isolated vertex samples itself."""

    def __init__(self, graph: Graph, features: np.ndarray, fanouts: Tuple[int, ...],
                 seed: int = 0):
        self.g = graph
        self.features = features
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray):
        """The feature rows of each frontier, seeds first: ``[B · f1 ⋯ fk,
        d_feat]`` for layer k."""
        frontiers = [seeds.astype(np.int64)]
        for f in self.fanouts:
            cur = frontiers[-1]
            starts = self.g.indptr[cur]
            degs = np.maximum(self.g.degrees[cur], 1)
            offs = self.rng.integers(0, 1 << 62, size=(cur.shape[0], f)) % degs[:, None]
            nbrs = self.g.indices[np.minimum(starts[:, None] + offs,
                                             self.g.indptr[cur + 1][:, None] - 1)]
            isolated = self.g.degrees[cur] == 0
            nbrs[isolated] = cur[isolated, None]  # self-loop fallback
            frontiers.append(nbrs.reshape(-1))
        return [self.features[f] for f in frontiers]
