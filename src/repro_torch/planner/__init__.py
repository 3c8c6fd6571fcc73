"""Host copies of the ``repro.planner`` pieces the port needs."""

from .compiler import choose_cover, r_lower
from .lowering import TreeNode, TreeProgram, build_tree_program
from .sizing import StoreCaps, match_caps, quantize_store_caps, unit_table_caps

__all__ = ["choose_cover", "r_lower", "TreeNode", "TreeProgram", "build_tree_program",
           "StoreCaps", "match_caps", "quantize_store_caps", "unit_table_caps"]
