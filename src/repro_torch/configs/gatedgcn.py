"""gatedgcn [arXiv:2003.00982 benchmarking-gnns]: 16L d_hidden=70 gated agg.

Copy of ``repro/configs/gatedgcn.py``.
"""

from ..models.gnn import GNNConfig
from .registry import GNN_SHAPES, ArchSpec

_FULL = GNNConfig(
    name="gatedgcn", arch="gatedgcn",
    n_layers=16, d_hidden=70, d_in=128, d_out=40, aggregator="gated",
    dtype="bfloat16",
)

_SMOKE = GNNConfig(
    name="gatedgcn-smoke", arch="gatedgcn",
    n_layers=3, d_hidden=16, d_in=8, d_out=4, aggregator="gated",
)

SPEC = ArchSpec(
    name="gatedgcn", family="gnn",
    config=_FULL, smoke=_SMOKE, shapes=GNN_SHAPES,
    notes="d_in is overridden per shape (d_feat); edge gates need two segment sums.",
)
