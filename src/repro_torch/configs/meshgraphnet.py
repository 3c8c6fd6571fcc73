"""meshgraphnet [arXiv:2010.03409]: 15 processor steps, d=128, sum agg.

Copy of ``repro/configs/meshgraphnet.py``.
"""

from ..models.gnn import GNNConfig
from .registry import GNN_SHAPES, ArchSpec

_FULL = GNNConfig(
    name="meshgraphnet", arch="meshgraphnet",
    n_layers=15, d_hidden=128, d_in=12, d_out=3, d_edge_in=4,
    aggregator="sum", mlp_layers=2, dtype="bfloat16",
)

_SMOKE = GNNConfig(
    name="meshgraphnet-smoke", arch="meshgraphnet",
    n_layers=3, d_hidden=16, d_in=8, d_out=3, d_edge_in=4, mlp_layers=2,
)

SPEC = ArchSpec(
    name="meshgraphnet", family="gnn",
    config=_FULL, smoke=_SMOKE, shapes=GNN_SHAPES,
    notes="Edge features updated every step (encode-process-decode).",
)
