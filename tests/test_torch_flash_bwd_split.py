"""The tensor-core attention backward's algebra, on the CPU.

``csrc/flash_attention_bwd_tc.cu`` takes P from the forward kernel's
log-sum-exp (log2 domain), splits P into bf16 ``hi + lo`` for ``dV = Pᵀ
dO`` and rounds dS once to bf16 for ``dQ`` and ``dK``. Its plain mirror,
``ref.flash_attention_bwd_tc_ref``, is held here to the limits the card's
checks use (``ref.flash_attention_bwd_limits``: each element of dQ, dK and
dV within its bound, derived in that docstring), on bf16 inputs made from a
NumPy seed, with O and the LSE from the forward kernel's mirror
(``ref.flash_attention_hilo_ref``). P rounded once to bf16 is shown to
break dV's limit. The plain log-sum-exp, ``ref.flash_attention_lse_ref``,
is held to ``torch.logsumexp`` of the masked scores (within 2e-6 of
max(1, |lse|)) and to the forward mirror's ``m + log2 l`` (within 1e-5).
:func:`bwd_route` is a pure function of the type and Dh.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import bwd_route


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, hq, hkv, l, dh, seed):
    """bf16 q, k, v and dO, from a NumPy seed."""
    rng = np.random.default_rng([b, hq, hkv, l, dh, seed])
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
            for s in ((b, hq, l, dh), (b, hkv, l, dh), (b, hkv, l, dh), (b, hq, l, dh))]


def _over_limit(got, q, k, v, dout):
    """max |got - float32 plain| / limit for each of dq, dk, dv."""
    want, limit = ref.flash_attention_bwd_limits(q, k, v, dout)
    return [float(((g.float() - w).abs() / lim).max()) for g, w, lim in zip(got, want, limit)]


# b, hq, hkv, l, dh: groups 1-3, Dh 64 and 128, L up to 4,095
TC_CASES = {
    "l1_g3": (2, 6, 2, 1, 128),
    "l17_g3": (2, 6, 2, 17, 128),
    "l130_g2_dh64": (1, 4, 2, 130, 64),
    "l300_g1_dh128": (1, 2, 2, 300, 128),
    "l1000_g3_dh128": (1, 3, 1, 1000, 128),
    "l4095_g1_dh64": (1, 1, 1, 4095, 64),
}


@pytest.mark.parametrize("case", list(TC_CASES))
def test_tc_mirror_within_limits(case):
    b, hq, hkv, l, dh = TC_CASES[case]
    q, k, v, dout = _inputs(b, hq, hkv, l, dh, 0)
    out, lse = ref.flash_attention_hilo_ref(q, k, v, causal=True, return_lse=True)
    got = ref.flash_attention_bwd_tc_ref(q, k, v, out, dout, lse)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    worst = _over_limit(got, q, k, v, dout)
    assert max(worst) <= 1.0, worst


def test_single_bf16_p_breaks_dv_limit():
    """P rounded once to bf16 for dV fails dV's limit on a few hundred keys
    a row; the split passes. dQ and dK do not depend on it."""
    q, k, v, dout = _inputs(1, 4, 2, 256, 64, 2)
    out, lse = ref.flash_attention_hilo_ref(q, k, v, causal=True, return_lse=True)
    once = _over_limit(ref.flash_attention_bwd_tc_ref(q, k, v, out, dout, lse, split=False),
                       q, k, v, dout)
    split = _over_limit(ref.flash_attention_bwd_tc_ref(q, k, v, out, dout, lse), q, k, v, dout)
    assert once[2] > 2.0
    assert max(split) <= 1.0
    assert once[:2] == split[:2]


# b, hq, hkv, lq, lk, dh, q_offset, causal
LSE_CASES = {
    "causal_g3": (1, 6, 2, 150, 150, 32, 0, True),
    "offset": (2, 4, 2, 40, 131, 16, 91, True),
    "noncausal": (1, 4, 2, 20, 128, 16, 0, False),
    "one_row": (1, 3, 1, 1, 70, 64, 69, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(LSE_CASES))
def test_lse_matches_logsumexp_and_forward_mirror(case, dtype):
    b, hq, hkv, lq, lk, dh, off, causal = LSE_CASES[case]
    rng = np.random.default_rng([b, hq, lq, lk, dh, off])
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
               for s in ((b, hq, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh)))
    got = ref.flash_attention_lse_ref(q, k, causal=causal, q_offset=off)
    assert got.shape == (b, hq, lq) and got.dtype == torch.float32
    kg = k.float().repeat_interleave(hq // hkv, dim=1)
    s = torch.matmul(q.float(), kg.transpose(-1, -2)) / math.sqrt(dh)
    if causal:
        s = s.masked_fill(torch.arange(lk)[None, :] > torch.arange(lq)[:, None] + off, -math.inf)
    want = torch.logsumexp(s.double(), -1) / math.log(2.0)
    assert float(((got.double() - want).abs() / want.abs().clamp(min=1.0)).max()) <= 2e-6
    _, mirror = ref.flash_attention_hilo_ref(q, k, v, causal=causal, q_offset=off,
                                             return_lse=True)
    assert float((mirror - got).abs().max()) <= 1e-5 * max(1.0, float(got.abs().max()))


def test_lse_of_a_row_without_keys_is_inf():
    """A row that admits no key has lse = +inf (P = 2^(s - inf) = 0)."""
    q, k = torch.ones(1, 1, 2, 8), torch.ones(1, 1, 3, 8)
    # q_offset -1: row 0 sees no key (only the plain functions allow it)
    lse = ref.flash_attention_lse_ref(q, k, causal=True, q_offset=-1)
    assert math.isinf(float(lse[0, 0, 0])) and float(lse[0, 0, 0]) > 0
    assert math.isfinite(float(lse[0, 0, 1]))
    _, mirror = ref.flash_attention_hilo_ref(q, k, k, causal=True, q_offset=-1, return_lse=True)
    assert torch.equal(mirror, lse)


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 96, None), (torch.float32, 192, None), (torch.float16, 128, None),
])
def test_bwd_route(dtype, dh, want):
    assert bwd_route(dtype, dh) == want
