"""Host copies of the ``repro.planner`` pieces the port needs."""

from .compiler import choose_cover, choose_executor, r_lower
from .lowering import TreeNode, TreeProgram, build_tree_program
from .sizing import (StoreCaps, calibrate_wcoj_caps, match_caps, quantize_store_caps,
                     unit_table_caps, wcoj_level_caps, wcoj_prefix_estimates)

__all__ = ["choose_cover", "choose_executor", "r_lower", "TreeNode", "TreeProgram",
           "build_tree_program", "StoreCaps", "calibrate_wcoj_caps", "match_caps",
           "quantize_store_caps", "unit_table_caps", "wcoj_level_caps",
           "wcoj_prefix_estimates"]
