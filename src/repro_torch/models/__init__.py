"""Model ports of ``repro/models``: GNN full-graph inference, transformer
serving and DLRM serving."""

from . import dlrm, gnn, transformer

__all__ = ["dlrm", "gnn", "transformer"]
