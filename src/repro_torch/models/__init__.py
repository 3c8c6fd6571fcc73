"""Model ports of ``repro/models``: GNN full-graph inference."""

from . import gnn

__all__ = ["gnn"]
