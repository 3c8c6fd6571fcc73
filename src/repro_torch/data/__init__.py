"""Host copies of the graph generators the port needs."""

from .graphs import rmat_graph, sample_update

__all__ = ["rmat_graph", "sample_update"]
