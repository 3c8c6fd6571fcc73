"""Copies of the JAX package's GNN and LM configurations (``repro/configs``)."""

from .registry import GNN_SHAPES, LM_SHAPES, ArchSpec, ShapeSpec, all_archs, get_arch

__all__ = ["ShapeSpec", "ArchSpec", "LM_SHAPES", "GNN_SHAPES", "get_arch", "all_archs"]
