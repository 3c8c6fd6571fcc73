"""Host copies of the graph generators the port needs."""

from .graphs import build_graph_data, planted_graph, rmat_graph, sample_update

__all__ = ["rmat_graph", "planted_graph", "sample_update", "build_graph_data"]
