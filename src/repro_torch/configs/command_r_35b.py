"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01] — dense GQA, no bias.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
Copy of ``repro/configs/command_r_35b.py``.
"""

from ..models.transformer import TransformerConfig
from .registry import LM_SHAPES, ArchSpec

_FULL = TransformerConfig(
    name="command-r-35b",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22528,
    vocab=256000,
    attn="gqa",
    rope_theta=1e4,
)

_SMOKE = TransformerConfig(
    name="command-r-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8, d_ff=160,
    vocab=512, attn="gqa", remat=False, dtype="float32",
)

SPEC = ArchSpec(
    name="command-r-35b", family="lm",
    config=_FULL, smoke=_SMOKE, shapes=LM_SHAPES,
    notes="Largest assigned LM (35B); ZeRO-1 optimizer sharding is required to fit.",
)
