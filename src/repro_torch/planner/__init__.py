"""Host copy of ``repro.planner``: the staged plan compiler, its lowering
to the plan IR and the cap sizing, exported as ``repro/planner/__init__.py``
exports them (plus the executor pass and the WCOJ cap helpers the port's
steps use)."""

from .compiler import (CompileContext, CompiledPlan, ExecutorChoice, PassReport,
                       candidate_covers, choose_cover, choose_executor, compile_plan, r_lower,
                       tree_key)
from .lowering import TreeNode, TreeProgram, build_tree_program
from .sizing import (ShardingSpec, StoreCaps, calibrate_wcoj_caps, match_caps,
                     quantize_store_caps, unit_table_caps, wcoj_level_caps,
                     wcoj_prefix_estimates)

__all__ = ["CompileContext", "CompiledPlan", "PassReport", "candidate_covers", "choose_cover",
           "compile_plan", "tree_key", "TreeNode", "TreeProgram", "build_tree_program",
           "ShardingSpec", "StoreCaps", "match_caps", "unit_table_caps", "ExecutorChoice",
           "choose_executor", "r_lower", "calibrate_wcoj_caps", "quantize_store_caps",
           "wcoj_level_caps", "wcoj_prefix_estimates"]
