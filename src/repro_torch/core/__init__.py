"""Host copies (NumPy only) of ``repro.core``: the data graph, patterns, the
NP storage and its Alg. 4 update, listing, joins, incremental maintenance
and the :class:`DDSL` facade. Exports what ``repro/core/__init__.py``
exports, plus the plan IR and the estimator helpers the port's steps use."""

from .ddsl import DDSL, choose_cover
from .estimator import GraphStats, match_size_estimate, skeleton_size_estimate
from .graph import Graph, GraphUpdate, decode_edges, edge_codes
from .join_tree import JoinTree, minimum_unit_decomposition, optimal_join_tree
from .pattern import PATTERN_LIBRARY, Pattern, R1Unit, enumerate_r1_units, symmetry_break
from .plan import LT, NEQ, JoinPlan, UnitPlan, WcojPlan, build_unit_plan, build_wcoj_plan
from .storage import NPStorage, Partition, PartitionFn, build_np_storage, update_np_storage
from .unit_cache import ListingProvider, PartitionUnitCache
from .vcbc import CompressedTable, cc_join, compress_table

__all__ = [
    "DDSL", "choose_cover",
    "GraphStats", "match_size_estimate", "skeleton_size_estimate",
    "Graph", "GraphUpdate", "decode_edges", "edge_codes",
    "JoinTree", "minimum_unit_decomposition", "optimal_join_tree",
    "PATTERN_LIBRARY", "Pattern", "R1Unit", "enumerate_r1_units", "symmetry_break",
    "LT", "NEQ", "JoinPlan", "UnitPlan", "WcojPlan", "build_unit_plan", "build_wcoj_plan",
    "NPStorage", "Partition", "PartitionFn", "build_np_storage", "update_np_storage",
    "ListingProvider", "PartitionUnitCache",
    "CompressedTable", "cc_join", "compress_table",
]
