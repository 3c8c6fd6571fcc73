"""dlrm-rm2 [arXiv:1906.00091]: 13 dense + 26 sparse, dot interaction.

Copy of ``repro/configs/dlrm_rm2.py``.
"""

from ..models.dlrm import DLRMConfig
from .registry import RECSYS_SHAPES, ArchSpec

_FULL = DLRMConfig(
    name="dlrm-rm2",
    n_dense=13, n_sparse=26, embed_dim=64,
    rows_per_table=1_000_000,
    bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1),
)

_SMOKE = DLRMConfig(
    name="dlrm-smoke",
    n_dense=13, n_sparse=4, embed_dim=8, rows_per_table=128,
    bot_mlp=(16, 8), top_mlp=(16, 1),
)

SPEC = ArchSpec(
    name="dlrm-rm2", family="recsys",
    config=_FULL, smoke=_SMOKE, shapes=RECSYS_SHAPES,
    notes="Tables model-sharded on rows; lookup = take + segment_sum (EmbeddingBag built here).",
)
