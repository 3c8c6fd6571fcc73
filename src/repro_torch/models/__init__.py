"""Model ports of ``repro/models``: GNN full-graph inference and
transformer serving."""

from . import gnn, transformer

__all__ = ["gnn", "transformer"]
