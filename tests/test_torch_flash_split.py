"""The attention kernels' algebra and planning, on the CPU.

The tensor-core prefill kernel splits the float32 probabilities P into
bf16 ``hi + lo`` before ``P·V``; the decode kernel splits the keys over
blocks and merges their float32 ``(m, l, acc)`` states. Their plain
mirrors in ``kernels/ref.py`` are held here against the port's float32
reference and against the JAX kernel in Pallas interpret mode, with
NumPy-seeded inputs. Tolerances: each output element within the limit the
card's checks use (``ref.flash_attention_limits``): 1e-5 ·
Σⱼ pⱼ|vⱼ| of the float32 reference, and one bf16 rounding (2⁻⁸ · |want|)
more for a bf16 output; against the Pallas kernel, max |mirror − JAX| ≤
2e-5 (float32) or 2e-2 (bf16) of the largest |JAX| value, as in
``test_torch_transformer.py``. The route and the split planner are pure
functions of their arguments and are tested as such.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (DECODE_BLOCK_ROWS, DECODE_MIN_KEYS,
                                                 decode_rows, plan_splits, route)

# resident decode blocks of an H100 at phi4-mini's shape: 132 SMs x 2
H100_SLOTS = 264
# the decode kernel's cap on splits (``flash_decode_max_splits``)
MAX_SPLITS = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, hq, hkv, lq, lk, dh, dtype, seed):
    rng = np.random.default_rng([b, hq, hkv, lq, lk, dh, seed])
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, hq, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh))]
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs], arrs


def _within_limit(got, q, k, v, causal, off):
    """max |got - float32 reference| / limit, element by element."""
    want, limit = ref.flash_attention_limits(q, k, v, causal=causal, q_offset=off)
    return float(((got.float() - want).abs() / limit).max())


def _pallas(arrs, dtype, causal, off, tile_q, tile_k):
    jq, jk, jv = (jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs)
    out = jops.flash_attention(jq, jk, jv, causal=causal, q_offset=off,
                               backend="pallas_interpret", tile_q=tile_q, tile_k=tile_k)
    return np.asarray(out.astype(jnp.float32))


def _close_to_jax(got, want, dtype):
    tol = 2e-5 if dtype == "float32" else 2e-2
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


# ---------------------------------------------------------------------------
# the split of P
# ---------------------------------------------------------------------------

def test_split_p_bound():
    """hi + lo is p within 2⁻¹⁶·p (hi alone within 2⁻⁸·p), over eight
    binades of probabilities and the values 0 and 1."""
    rng = np.random.default_rng(0)
    p = torch.from_numpy(np.concatenate([2.0 ** rng.uniform(-8, 0, 100_000), [0.0, 1.0]])
                         .astype(np.float32))
    hi, lo = ref.split_p(p)
    assert hi.dtype == lo.dtype == torch.bfloat16
    pd = p.double()
    assert bool(((hi.double() - pd).abs() <= 2.0**-8 * pd).all())
    assert bool(((hi.double() + lo.double() - pd).abs() <= 2.0**-16 * pd).all())
    assert float(hi[-2]) == 0.0 and float(lo[-2]) == 0.0 and float(hi[-1]) == 1.0


# b, hq, hkv, lq, lk, dh, q_offset, causal
HILO_CASES = {
    "prefill_g3": (1, 6, 2, 150, 150, 32, 0, True),
    "chunk_lk_not_tile": (2, 6, 2, 40, 131, 16, 91, True),
    "mha": (1, 4, 4, 70, 70, 16, 0, True),
    "group8": (1, 8, 1, 33, 100, 16, 67, True),
    "noncausal": (1, 4, 2, 20, 128, 16, 0, False),
    "one_row": (1, 6, 2, 1, 200, 32, 199, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(HILO_CASES))
def test_hilo_mirror_matches_reference_and_pallas(case, dtype):
    b, hq, hkv, lq, lk, dh, off, causal = HILO_CASES[case]
    (q, k, v), arrs = _inputs(b, hq, hkv, lq, lk, dh, dtype, 1)
    got = ref.flash_attention_hilo_ref(q, k, v, causal=causal, q_offset=off)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert _within_limit(got, q, k, v, causal, off) <= 1.0
    _close_to_jax(got, _pallas(arrs, dtype, causal, off, 16, 32), dtype)


def test_single_bf16_p_breaks_the_limit():
    """P rounded once to bf16, as the split avoids, fails the same limit
    on a bf16 prefill with a few hundred keys a row; the split passes."""
    (q, k, v), _ = _inputs(1, 4, 2, 256, 256, 64, "bfloat16", 2)
    once = ref.flash_attention_hilo_ref(q, k, v, causal=True, split=False)
    split = ref.flash_attention_hilo_ref(q, k, v, causal=True)
    assert _within_limit(once, q, k, v, True, 0) > 2.0
    assert _within_limit(split, q, k, v, True, 0) <= 1.0


# ---------------------------------------------------------------------------
# split-K decode: partials and merge
# ---------------------------------------------------------------------------

# b, hq, hkv, lq, lk, dh, q_offset, causal, splits, kps (None: the planner's)
SPLIT_CASES = {
    "decode_g3_planned": (2, 6, 2, 1, 300, 32, 299, True, None, None),
    "decode_g1": (1, 3, 3, 1, 257, 16, 200, True, 4, 64),
    "decode_g8": (1, 16, 2, 1, 150, 16, 149, True, 5, 30),
    "lq2_g3": (1, 6, 2, 2, 140, 16, 100, True, 3, 40),
    # kend of the rows inside the last split
    "lq7_kend_inside": (2, 6, 2, 7, 90, 16, 80, True, 3, 32),
    # rows 0..14 see no key of the last split (one key)
    "lq16_split_past_kend": (1, 3, 1, 16, 200, 16, 161, True, 6, 35),
    # most splits admit no key of any row
    "most_splits_empty": (1, 4, 2, 4, 64, 16, 4, True, 40, 1),
    "lq16_noncausal": (1, 2, 2, 16, 128, 16, 0, False, 4, 32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_k_mirror_matches_reference_and_pallas(case, dtype):
    b, hq, hkv, lq, lk, dh, off, causal, splits, kps = SPLIT_CASES[case]
    admitted = min(lk, off + lq) if causal else lk
    if splits is None:
        chunks = decode_rows(hq, hkv, lq)[1]
        splits, kps = plan_splits(b * hkv * chunks, admitted, H100_SLOTS, MAX_SPLITS)
    (q, k, v), arrs = _inputs(b, hq, hkv, lq, lk, dh, dtype, 3)
    m, l, acc = ref.split_k_partials(q, k, v, causal, off, splits, kps)
    assert m.shape[-1] == l.shape[-1] == acc.shape[-2] == splits
    empty = (l == 0) & (m == -np.inf)
    if case in ("lq16_split_past_kend", "most_splits_empty"):
        assert bool(empty.any())
    assert bool((acc[empty] == 0).all())
    got = ref.merge_split_k(m, l, acc, q.shape, q.dtype)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert _within_limit(got, q, k, v, causal, off) <= 1.0
    _close_to_jax(got, _pallas(arrs, dtype, causal, off, 16, 16 if lk % 16 == 0 else 128),
                  dtype)


def test_split_k_merge_of_rows_without_keys():
    """A row no split admits a key of merges to 0, not NaN."""
    m = torch.full((1, 1, 2, 3), -np.inf)
    l = torch.zeros((1, 1, 2, 3))
    acc = torch.zeros((1, 1, 2, 3, 4))
    m[0, 0, 1, 1], l[0, 0, 1, 1], acc[0, 0, 1, 1] = 0.5, 2.0, 3.0
    out = ref.merge_split_k(m, l, acc, (1, 1, 2, 4), torch.float32)
    assert torch.equal(out[0, 0, 0], torch.zeros(4))
    assert torch.equal(out[0, 0, 1], torch.full((4,), 1.5))


# ---------------------------------------------------------------------------
# route and planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lq,dtype,dh,want", [
    (1, torch.bfloat16, 128, "decode"), (16, torch.float32, 8, "decode"),
    (16, torch.bfloat16, 128, "decode"), (17, torch.bfloat16, 128, "tc"),
    (8192, torch.bfloat16, 128, "tc"), (300, torch.bfloat16, 64, "tc"),
    (300, torch.float32, 128, "simt"), (300, torch.bfloat16, 8, "simt"),
    (300, torch.bfloat16, 24, "simt"), (300, torch.bfloat16, 256, "simt"),
])
def test_route(lq, dtype, dh, want):
    assert route(lq, dtype, dh) == want


@pytest.mark.parametrize("heads,admitted,slots,cap", [
    (32, 8193, 264, 64), (32, 8207, 264, 64), (32, 8193, 132, 64), (64, 8193, 264, 64),
    (8, 32_769, 264, 64), (1, 1, 264, 64), (96, 17, 264, 64), (2, 1000, 264, 64),
    (4, 300, 264, 64), (1, 10**6, 264, 64), (600, 8193, 132, 64), (1, 10**6, 264, 5),
])
def test_plan_splits_covers_every_key_once(heads, admitted, slots, cap):
    splits, kps = plan_splits(heads, admitted, slots, cap)
    assert 1 <= splits <= cap
    ranges = [(s * kps, min((s + 1) * kps, admitted)) for s in range(splits)]
    assert all(hi > lo for lo, hi in ranges), ranges          # no split is empty
    assert ranges[0][0] == 0 and ranges[-1][1] == admitted
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert splits == 1 or kps >= min(DECODE_MIN_KEYS, admitted) // 2
    assert splits == 1 or heads * splits <= slots   # no second wave


def test_phi4_mini_decode_plan_fills_the_card():
    """phi4-mini decode at position 8,192 on an H100 (two blocks an SM):
    3 query rows a block (the whole group of a KV head), 32 KV heads x 8
    splits of 1,025 keys: 256 blocks, one wave of the card's 264, none
    empty."""
    assert decode_rows(24, 8, 1) == (3, 1, 3)
    splits, kps = plan_splits(4 * 8, 8193, H100_SLOTS, MAX_SPLITS)
    assert (splits, kps) == (8, 1025)
    assert H100_SLOTS - 32 < 32 * splits <= H100_SLOTS


@pytest.mark.parametrize("hq,hkv,lq,rows,chunks", [
    (24, 8, 1, 3, 1), (64, 8, 1, 8, 1), (8, 8, 1, 1, 1), (24, 8, 16, 8, 6), (4, 4, 16, 8, 2),
    (16, 2, 16, 8, 16), (6, 2, 3, 5, 2),
])
def test_decode_rows(hq, hkv, lq, rows, chunks):
    got_rows, got_chunks, rtile = decode_rows(hq, hkv, lq)
    assert (got_rows, got_chunks) == (rows, chunks)
    assert rows <= DECODE_BLOCK_ROWS and rows * chunks >= hq // hkv * lq
    assert rtile == (rows if rows <= 4 else 8)
