"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-3b-a800m-base].

32L d_model=1536 24H (GQA kv=8) d_expert=512 vocab=49155, MoE 40e top-8.
40 experts top-8, as the 3b-a800m checkpoint has (the 1b-a400m variant has 32).
Copy of ``repro/configs/granite_moe_3b_a800m.py``.
"""

from ..models.transformer import TransformerConfig
from .registry import LM_SHAPES, ArchSpec

_FULL = TransformerConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab=49155,
    attn="gqa",
    moe=True,
    n_experts=40,
    top_k=8,
    n_shared=0,
    d_expert=512,
    first_dense=0,
    rope_theta=1e4,
)

_SMOKE = TransformerConfig(
    name="granite-moe-smoke",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, d_head=8, d_ff=64,
    vocab=256, attn="gqa", moe=True, n_experts=5, top_k=2, n_shared=0,
    d_expert=32, first_dense=0, remat=False, dtype="float32",
)

SPEC = ArchSpec(
    name="granite-moe-3b-a800m", family="lm",
    config=_FULL, smoke=_SMOKE, shapes=LM_SHAPES,
    notes="All-MoE layers; 40 experts over EP=16 → 2.5/shard (padded grouping).",
)
