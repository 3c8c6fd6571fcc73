"""Host copies (NumPy only) of the ``repro.core`` pieces the port needs."""

from .estimator import GraphStats, match_size_estimate, skeleton_size_estimate
from .graph import Graph, GraphUpdate, decode_edges, edge_codes
from .join_tree import JoinTree, minimum_unit_decomposition, optimal_join_tree
from .pattern import PATTERN_LIBRARY, Pattern, R1Unit, symmetry_break
from .plan import LT, NEQ, JoinPlan, UnitPlan, WcojPlan, build_unit_plan, build_wcoj_plan
from .storage import NPStorage, Partition, PartitionFn, build_np_storage

__all__ = [
    "GraphStats", "match_size_estimate", "skeleton_size_estimate",
    "Graph", "GraphUpdate", "decode_edges", "edge_codes",
    "JoinTree", "minimum_unit_decomposition", "optimal_join_tree",
    "PATTERN_LIBRARY", "Pattern", "R1Unit", "symmetry_break",
    "LT", "NEQ", "JoinPlan", "UnitPlan", "WcojPlan", "build_unit_plan", "build_wcoj_plan",
    "NPStorage", "Partition", "PartitionFn", "build_np_storage",
]
