"""phi4-mini-3.8b [arXiv:2412.08905; hf] — dense GQA, RoPE + SwiGLU.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
Copy of ``repro/configs/phi4_mini_3_8b.py``.
"""

from ..models.transformer import TransformerConfig
from .registry import LM_SHAPES, ArchSpec

_FULL = TransformerConfig(
    name="phi4-mini-3.8b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=200064,
    attn="gqa",
    rope_theta=1e4,
)

_SMOKE = TransformerConfig(
    name="phi4-mini-smoke",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, d_head=8, d_ff=96,
    vocab=512, attn="gqa", remat=False, dtype="float32",
)

SPEC = ArchSpec(
    name="phi4-mini-3.8b", family="lm",
    config=_FULL, smoke=_SMOKE, shapes=LM_SHAPES,
    notes="Vocab (200k) dominates the embedding/logit shards.",
)
