"""deepseek-v2-lite-16b [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff(dense)=10944→d_expert=1408 vocab=102400.
MLA: kv_lora=512, qk_nope=128, qk_rope=64, v_head=128 (no q-lora in Lite).
MoE: 64 routed top-6 + 2 shared experts, first layer dense.
64 routed experts, as the HF V2-Lite checkpoint has (160 belongs to the full V2).
Copy of ``repro/configs/deepseek_v2_lite_16b.py``.
"""

from ..models.transformer import TransformerConfig
from .registry import LM_SHAPES, ArchSpec

_FULL = TransformerConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=192,  # qk_nope + qk_rope
    d_ff=10944,
    vocab=102400,
    attn="mla",
    q_lora=0,
    kv_lora=512,
    qk_nope=128,
    qk_rope=64,
    v_head=128,
    moe=True,
    n_experts=64,
    top_k=6,
    n_shared=2,
    d_expert=1408,
    first_dense=1,
    rope_theta=1e4,
)

_SMOKE = TransformerConfig(
    name="deepseek-v2-lite-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=24, d_ff=128,
    vocab=512, attn="mla", q_lora=0, kv_lora=32, qk_nope=16, qk_rope=8,
    v_head=16, moe=True, n_experts=8, top_k=2, n_shared=2, d_expert=32,
    first_dense=1, remat=False, dtype="float32",
)

SPEC = ArchSpec(
    name="deepseek-v2-lite-16b", family="lm",
    config=_FULL, smoke=_SMOKE, shapes=LM_SHAPES,
    notes="MLA latent KV cache; MoE EP over 'model'; absorbed decode is a §Perf lever.",
)
