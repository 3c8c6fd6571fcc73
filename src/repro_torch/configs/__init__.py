"""Copies of the JAX package's GNN, LM and recsys configurations (``repro/configs``)."""

from .registry import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, ArchSpec, ShapeSpec, all_archs,
                       get_arch)

__all__ = ["ShapeSpec", "ArchSpec", "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "get_arch",
           "all_archs"]
