"""MLA's attention at its own widths, on the CPU: V at ``v_head`` columns
under queries and keys of ``qk_nope + qk_rope``, no zero-padded V.

The port's plain attention (``ref.flash_attention_ref``) and the
tensor-core kernel's arithmetic (``ref.flash_attention_hilo_ref``) at the
(Dqk, Dv) pairs (24, 16), (96, 64) (minicpm3-4b) and (192, 128)
(deepseek-v2-lite-16b), with NumPy-seeded inputs, against JAX's model
reference (the ``attn_backend="ref"`` branch of
``repro.models.transformer._attention``, which takes ``dv = v.shape[-1]``)
and against the Pallas kernel in interpret mode on V zero-padded to Dqk,
its first Dv columns; the route the wrapper takes at each pair; the
wrapper's refusals, which it makes before it touches a card; and the
port's MLA prefill, chunked prefill and decode of the smoke
configurations against JAX's, with every attention call taking V at
``v_head`` columns.

Tolerances, as max |port − JAX| over the largest |JAX| value (at least 1):
float32 2e-5 (the same float32 arithmetic in another order), bf16 2e-2
(both round the same float32 values, bf16 has 8 significant bits), as in
``test_torch_mla_moe.py``; the kernel's arithmetic also element by element
within the card's limit (``ref.flash_attention_limits``): 1e-5 ·
Σⱼ pⱼ|vⱼ| of the float32 reference, one bf16 rounding (2⁻⁸ · |want|) more
in bf16. The model runs: float32 1e-5, bf16 2e-2.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.registry import get_arch as j_get_arch
from repro.kernels import ops as jops
from repro.models import transformer as jtf
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import TC_WIDTHS, flash_attention_cuda, route
from repro_torch.models import transformer as tf
from test_torch_flash_split import _within_limit
from test_torch_mla_moe import _close, _configs, _jit, _np_params

# (Dqk, Dv): a small pair, minicpm3-4b's and deepseek-v2-lite-16b's
WIDTHS = ((24, 16), (96, 64), (192, 128))
# name: (b, hq, hkv, lq, lk, q_offset, causal)
CASES = {
    "prefill_g1": (2, 3, 3, 40, 40, 0, True),
    "chunk_g2": (1, 4, 2, 24, 56, 32, True),        # q_offset + lq = lk
    "offset_short_g1": (2, 2, 2, 17, 50, 20, True),  # keys past the last query masked
    "noncausal_g2": (1, 4, 2, 20, 64, 0, False),
}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MLA_ARCHS = ("minicpm3-4b", "deepseek-v2-lite-16b")
B, S, GEN = 2, 16, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, dqk, dv, dtype):
    """q, k, v as the port's tensors (``dtype``) and as float32 NumPy
    arrays, drawn from a seed of the shape."""
    b, hq, hkv, lq, lk, off, causal = CASES[case]
    rng = np.random.default_rng([b, hq, hkv, lq, lk, dqk, dv])
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, hq, lq, dqk), (b, hkv, lk, dqk), (b, hkv, lk, dv))]
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs], arrs


def _jax_refs(arrs, case, dtype):
    """JAX's model reference on V at its own width, and the Pallas kernel
    in interpret mode on V zero-padded to Dqk, its first Dv columns."""
    *_, off, causal = CASES[case]
    q, k, v = arrs
    dv = v.shape[-1]
    jd = jnp.dtype(dtype)
    jcfg = dataclasses.replace(j_get_arch("minicpm3-4b").smoke, dtype=dtype, attn_backend="ref")
    want = _jit(lambda q, k, v: jtf._attention(q, k, v, jcfg, q_offset=off, causal=causal))(
        *(a.astype(jd) for a in (q, k, v)))
    vpad = np.concatenate([v, np.zeros(v.shape[:3] + (q.shape[-1] - dv,), np.float32)], -1)
    pallas = _jit(lambda q, k, v: jops.flash_attention(
        q, k, v, causal=causal, q_offset=off, backend="pallas_interpret", tile_q=8, tile_k=8))(
        *(a.astype(jd) for a in (q, k, vpad)))
    return want, pallas[..., :dv]


# ---------------------------------------------------------------------------
# the plain attention and the tensor-core kernel's arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dqk,dv", WIDTHS)
def test_plain_attention_at_own_v_width_matches_jax(dqk, dv, case, dtype):
    """``flash_attention_ref`` (and ``ops.flash_attention`` without kernels)
    on V of Dv columns returns ``[…, Dv]`` and agrees with JAX's reference
    and with the Pallas kernel on the padded V."""
    (q, k, v), arrs = _inputs(case, dqk, dv, dtype)
    *_, off, causal = CASES[case]
    got = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=off)
    assert got.dtype == q.dtype and got.shape == q.shape[:3] + (dv,)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal, q_offset=off,
                                                use_kernels=False))
    want, pallas = _jax_refs(arrs, case, dtype)
    _close(got, want, TOL[dtype], "vs JAX reference")
    _close(got, pallas, TOL[dtype], "vs Pallas, padded V")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dqk,dv", WIDTHS)
def test_hilo_arithmetic_at_own_v_width(dqk, dv, case, dtype):
    """The tensor-core kernel's arithmetic (P split into bf16 hi + lo, both
    products over V's Dv columns) within the card's limit of the float32
    reference, element by element, and close to JAX's reference and the
    Pallas kernel."""
    (q, k, v), arrs = _inputs(case, dqk, dv, dtype)
    *_, off, causal = CASES[case]
    got = ref.flash_attention_hilo_ref(q, k, v, causal=causal, q_offset=off)
    assert got.dtype == q.dtype and got.shape == q.shape[:3] + (dv,)
    assert _within_limit(got, q, k, v, causal, off) <= 1.0
    want, pallas = _jax_refs(arrs, case, dtype)
    _close(got, want, TOL[dtype], "vs JAX reference")
    _close(got, pallas, TOL[dtype], "vs Pallas, padded V")


# ---------------------------------------------------------------------------
# the route and the wrapper's refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lq,dtype,dqk,dv,want", [
    (17, torch.bfloat16, 96, 64, "tc"), (4096, torch.bfloat16, 96, 64, "tc"),
    (4096, torch.bfloat16, 192, 128, "tc"), (300, torch.bfloat16, 64, 64, "tc"),
    (300, torch.bfloat16, 128, None, "tc"),
    (300, torch.bfloat16, 96, 96, "simt"), (300, torch.bfloat16, 192, 192, "simt"),
    (300, torch.bfloat16, 128, 64, "simt"), (300, torch.bfloat16, 96, 32, "simt"),
    (300, torch.float32, 96, 64, "simt"), (300, torch.float32, 192, 128, "simt"),
    (1, torch.bfloat16, 96, 64, "decode"), (16, torch.bfloat16, 192, 128, "decode"),
    (16, torch.float32, 96, 64, "decode"),
])
def test_route_at_mla_widths(lq, dtype, dqk, dv, want):
    assert route(lq, dtype, dqk, dv) == want


def test_tc_widths():
    """The tensor-core kernel's instantiations: the two square widths and
    MLA's two, V never wider than Q and K."""
    assert set(TC_WIDTHS) == {(64, 64), (128, 128), (96, 64), (192, 128)}
    for m in MLA_ARCHS:
        c = get_arch(m).config
        assert (c.qk_nope + c.qk_rope, c.v_head) in TC_WIDTHS


@pytest.mark.parametrize("shapes,match", [
    (((1, 2, 20, 96), (1, 2, 30, 96), (1, 2, 30, 128)), "Dv <= Dh"),
    (((1, 2, 20, 96), (1, 2, 30, 96), (1, 2, 29, 64)), r"v \[B, Hkv, Lk, Dv\]"),
    (((1, 2, 20, 96), (1, 1, 30, 96), (1, 2, 30, 64)), r"v \[B, Hkv, Lk, Dv\]"),
    (((1, 2, 20, 96), (1, 2, 30, 96), (1, 2, 30, 20)), "16-byte"),
    (((1, 2, 20, 96), (1, 2, 30, 96), (1, 2, 30, 64)), "CUDA tensor"),
])
def test_wrapper_refuses(shapes, match):
    """The wrapper's checks at Dv ≠ Dqk, made before any launch: V wider
    than Q and K, V's batch, heads or keys not K's, a bf16 Dv that is not a
    whole number of 16-byte chunks, and, on shapes it takes, a CPU tensor."""
    q, k, v = (torch.zeros(s, dtype=torch.bfloat16) for s in shapes)
    with pytest.raises(ValueError, match=match):
        flash_attention_cuda(q, k, v, causal=True, q_offset=0)
    if match == "CUDA tensor":
        with pytest.raises(ValueError, match="CUDA"):
            ops.flash_attention(q, k, v, use_kernels=True)


# ---------------------------------------------------------------------------
# the port's MLA serving against JAX
# ---------------------------------------------------------------------------

@pytest.fixture
def attention_calls(monkeypatch):
    """Every ``ops.flash_attention`` call the model makes: the widths of q,
    k and v and of the output."""
    calls, inner = [], ops.flash_attention

    def spy(q, k, v, **kw):
        out = inner(q, k, v, **kw)
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1], out.shape[-1]))
        return out

    monkeypatch.setattr(tf.ops, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("arch,dtype", [("minicpm3-4b", "float32"), ("minicpm3-4b", "bfloat16"),
                                        ("deepseek-v2-lite-16b", "float32")])
def test_mla_chunked_prefill_and_decode_match_jax(arch, dtype, attention_calls):
    """MLA's ``prefill_chunked`` (chunk 8 over 16 prompt tokens: the second
    chunk at offset 8), then three ``decode_step`` s, against JAX's on the
    same parameters: logits and caches; the chunked prefill against the
    whole ``prefill``. Every attention call takes V at ``v_head`` columns
    under Q and K of ``qk_nope + qk_rope`` and returns ``v_head`` columns."""
    cfg, jcfg = _configs(arch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    jparams, params = _np_params(cfg, 5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (B, S + GEN)).astype(np.int32)
    cache = tf.init_cache(cfg, B, S + GEN, "cpu")
    logs = [tf.prefill_chunked(params, torch.from_numpy(toks[:, :S]), cache, cfg, chunk=8,
                               use_kernels=False)[0]]
    for i in range(GEN):
        logs.append(tf.decode_step(params, torch.from_numpy(toks[:, S + i:S + i + 1]), cache,
                                   S + i, cfg, use_kernels=False)[0])
    width = cfg.qk_nope + cfg.qk_rope
    assert attention_calls and set(attention_calls) == {(width, width, cfg.v_head, cfg.v_head)}
    assert len(attention_calls) == cfg.n_layers * (2 + GEN)

    pre = _jit(lambda p, t, c: jtf.prefill_chunked(p, t, c, jcfg, chunk=8))
    dec = _jit(lambda p, t, c, pos: jtf.decode_step(p, t, c, pos, jcfg))
    jl, jcache = pre(jparams, jnp.asarray(toks[:, :S]), jtf.init_cache(jcfg, B, S + GEN))
    jlogs = [jl]
    for i in range(GEN):
        jl, jcache = dec(jparams, jnp.asarray(toks[:, S + i:S + i + 1]), jcache, S + i)
        jlogs.append(jl)
    for i, (a, b) in enumerate(zip(logs, jlogs, strict=True)):
        _close(a, b, tol, f"step {i} logits")
    assert sorted(cache) == sorted(jcache)
    for g in cache:
        for i in range(2):
            _close(cache[g][i], jcache[g][i], tol, f"cache {g}/{i}")
    whole = tf.init_cache(cfg, B, S + GEN, "cpu")
    log1, _ = tf.prefill(params, torch.from_numpy(toks[:, :S]), whole, cfg, use_kernels=False)
    _close(logs[0], log1, tol, "chunked vs whole prefill")
