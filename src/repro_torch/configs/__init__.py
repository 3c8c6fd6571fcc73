"""Copies of the JAX package's GNN configurations (``repro/configs``)."""

from .registry import GNN_SHAPES, ArchSpec, ShapeSpec, all_archs, get_arch

__all__ = ["ShapeSpec", "ArchSpec", "GNN_SHAPES", "get_arch", "all_archs"]
