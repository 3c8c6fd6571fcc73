"""minicpm3-4b [hf:openbmb/MiniCPM3-4B] — dense MLA.

62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64.
Copy of ``repro/configs/minicpm3_4b.py``.
"""

from ..models.transformer import TransformerConfig
from .registry import LM_SHAPES, ArchSpec

_FULL = TransformerConfig(
    name="minicpm3-4b",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=96,  # qk_nope + qk_rope
    d_ff=6400,
    vocab=73448,
    attn="mla",
    q_lora=768,
    kv_lora=256,
    qk_nope=64,
    qk_rope=32,
    v_head=64,
    rope_theta=1e4,
)

_SMOKE = TransformerConfig(
    name="minicpm3-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=24, d_ff=128,
    vocab=512, attn="mla", q_lora=48, kv_lora=32, qk_nope=16, qk_rope=8,
    v_head=16, remat=False, dtype="float32",
)

SPEC = ArchSpec(
    name="minicpm3-4b", family="lm",
    config=_FULL, smoke=_SMOKE, shapes=LM_SHAPES,
    notes="Dense MLA with q-lora; deepest assigned LM (62 layers → scan is load-bearing).",
)
