"""Host copies of the graph generators the port needs."""

from .graphs import build_graph_data, rmat_graph, sample_update

__all__ = ["rmat_graph", "sample_update", "build_graph_data"]
