"""Host copies of the data generators the port needs: graphs, click logs,
token streams and the prefetcher."""

from .graphs import NeighborSampler, build_graph_data, planted_graph, rmat_graph, sample_update
from .pipeline import prefetch
from .recsys import click_batches
from .tokens import token_batches

__all__ = ["rmat_graph", "planted_graph", "sample_update", "build_graph_data", "NeighborSampler",
           "click_batches", "token_batches", "prefetch"]
