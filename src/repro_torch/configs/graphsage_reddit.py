"""graphsage-reddit [arXiv:1706.02216]: 2L d_hidden=128 mean agg, fanout 25-10.

Copy of ``repro/configs/graphsage_reddit.py``.
"""

from ..models.gnn import GNNConfig
from .registry import GNN_SHAPES, ArchSpec

_FULL = GNNConfig(
    name="graphsage-reddit", arch="graphsage",
    n_layers=2, d_hidden=128, d_in=602, d_out=41, aggregator="mean",
    fanouts=(25, 10),
)

_SMOKE = GNNConfig(
    name="graphsage-smoke", arch="graphsage",
    n_layers=2, d_hidden=16, d_in=8, d_out=4, aggregator="mean", fanouts=(5, 3),
)

SPEC = ArchSpec(
    name="graphsage-reddit", family="gnn",
    config=_FULL, smoke=_SMOKE, shapes=GNN_SHAPES,
    notes="minibatch_lg uses the real NeighborSampler (fanout 25-10 per paper config).",
)
