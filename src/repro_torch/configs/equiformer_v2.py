"""equiformer-v2 [arXiv:2306.12059]: 12L d=128 l_max=6 m_max=2 8 heads, eSCN.

Copy of ``repro/configs/equiformer_v2.py``.
"""

from ..models.gnn import GNNConfig
from .registry import GNN_SHAPES, ArchSpec

_FULL = GNNConfig(
    name="equiformer-v2", arch="equiformer_v2",
    n_layers=12, d_hidden=128, d_in=16, d_out=1,
    l_max=6, m_max=2, n_heads=8, dtype="bfloat16",
)

_SMOKE = GNNConfig(
    name="equiformer-v2-smoke", arch="equiformer_v2",
    n_layers=2, d_hidden=8, d_in=6, d_out=1, l_max=2, m_max=1, n_heads=2,
)

SPEC = ArchSpec(
    name="equiformer-v2", family="gnn",
    config=_FULL, smoke=_SMOKE, shapes=GNN_SHAPES,
    notes="Wigner-D edge rotations + SO(2) per-m mixing; positions synthesized "
          "for non-geometric shapes (backbone exercise only).",
)
