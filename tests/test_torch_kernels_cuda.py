"""The CUDA kernels against their plain versions, on a GPU (exact
equality for the integer kernels; segment_sum's float64 sums within 1e-5
of the largest, exact for integer sums; embedding_bag's float32 bag sums
within n_b · 2⁻²³ · Σ|rows| of the float64 sum (one bfloat16 rounding more
in bfloat16), one-row bags equal; flash_attention element by
element within 1e-5 of sum_j p_j |v_j| of the float32 plain version in
float32, and within one bfloat16 rounding of that in bfloat16, on each of
its three kernels). Imports no
JAX, so it runs on the machine with the card:

    python -m pytest -q tests/test_torch_kernels_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.member_probe import member_probe_cuda
from repro_torch.kernels.set_intersect import set_intersect_cuda


def _probe_inputs(seed, n, n_rows, n_pad):
    """Lex-sorted unique (hi, lo) table with a pad tail; random, drawn and
    pad queries."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 40, n_rows)
    t = np.unique(np.stack([hi, hi + 1 + rng.integers(0, 40, n_rows)], 1), axis=0)
    t = np.concatenate([t, np.full((n_pad, 2), -1)]).astype(np.int32)
    q = rng.integers(-1, 40, (n, 2)).astype(np.int32)
    q[: n // 2] = t[rng.integers(0, t.shape[0], n // 2)]
    q[::5] = -1
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in (q[:, 0], q[:, 1], t[:, 0], t[:, 1])]


def _set_inputs(seed, g, ca, cb, sorted_rows):
    rng = np.random.default_rng(seed)
    a = rng.integers(-1, 12, (g, ca)).astype(np.int32)
    b = rng.integers(-1, 12, (g, cb)).astype(np.int32)
    if sorted_rows:
        a = np.sort(np.where(a < 0, 99, a), axis=1)
        b = np.sort(np.where(b < 0, 99, b), axis=1)
        a[a == 99] = -1
        b[b == 99] = -1
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,n_rows,n_pad", [(0, 100_000, 9000, 64), (1, 5000, 100, 0)])
def test_member_probe_kernel_matches_plain(cuda_device, seed, n, n_rows, n_pad):
    args = [t.to(cuda_device) for t in _probe_inputs(seed, n, n_rows, n_pad)]
    assert torch.equal(member_probe_cuda(*args), ref.member_probe_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,g,ca,cb,sorted_rows", [(0, 4096, 512, 512, True),
                                                      (1, 7, 5000, 9000, False)])
def test_set_intersect_kernel_matches_plain(cuda_device, seed, g, ca, cb, sorted_rows):
    a, b = (t.to(cuda_device) for t in _set_inputs(seed, g, ca, cb, sorted_rows))
    assert torch.equal(set_intersect_cuda(a, b, -1), ref.set_intersect_ref(a, b, -1))


def _segment_inputs(seed, e, d, n, dtype, device):
    """Rows and unsorted ids with duplicates, id n and id -1 mixed in."""
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(device, dtype)
    ids = rng.integers(0, n, e)
    ids[rng.random(e) < 0.05] = n
    ids[rng.random(e) < 0.05] = -1
    return data, torch.from_numpy(ids.astype(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,d,n", [(100_000, 70, 3000), (50_000, 1, 700), (20_000, 128, 40),
                                   (3000, 1433, 500), (1, 3, 1)])
def test_segment_sum_kernel_matches_plain(cuda_device, e, d, n, dtype):
    """float64 sums in another order: within 1e-5 of the largest sum."""
    from repro_torch.kernels.segment_sum import segment_sum_cuda

    data, ids = _segment_inputs(e + d, e, d, n, dtype, cuda_device)
    zeros = lambda: torch.zeros((n, d), dtype=ref.ACC_DTYPE, device=cuda_device)  # noqa: E731
    got = segment_sum_cuda(data, ids, zeros())
    want = ref.segment_sum_ref(data, ids, n, zeros())
    assert (got - want).abs().max() <= 1e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_segment_sum_kernel_counts_exactly_and_accumulates(cuda_device):
    """Integer sums of a ones column are exact; an accumulator passed in
    across two calls equals one call over all rows."""
    from repro_torch.kernels import ops

    _, ids = _segment_inputs(9, 200_000, 1, 5000, torch.float32, cuda_device)
    ones = torch.ones((200_000, 1), dtype=torch.bfloat16, device=cuda_device)
    assert torch.equal(ops.segment_sum(ones, ids, 5000, use_kernels=True),
                       ops.segment_sum(ones, ids, 5000, use_kernels=False))
    data, ids = _segment_inputs(10, 80_000, 70, 900, torch.bfloat16, cuda_device)
    acc = torch.zeros((900, 70), dtype=ref.ACC_DTYPE, device=cuda_device)
    for s in (slice(0, 30_000), slice(30_000, None)):
        ops.segment_sum(data[s], ids[s], 900, use_kernels=True, acc=acc)
    want = ref.segment_sum_ref(data, ids, 900, torch.zeros_like(acc))
    assert (acc - want).abs().max() <= 1e-5 * float(want.abs().max())
    assert not ops.segment_sum(data, torch.full_like(ids, -1), 900, use_kernels=True).any()


def _bag_inputs(seed, v, d, n, nb, dtype, device):
    """A table, row indices and unsorted bag ids with empty bags, ids nb
    and -1 mixed in, and two row indices out of range (v and -1)."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(device, dtype)
    idx = rng.integers(0, v, n)
    idx[[n // 3, n // 2]] = [v, -1]
    bag = rng.integers(0, nb // 2, n) * 2          # odd bags empty
    bag[rng.random(n) < 0.05] = nb
    bag[rng.random(n) < 0.05] = -1
    return table, *(torch.from_numpy(a.astype(np.int32)).to(device) for a in (idx, bag))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4, 8, 13, 64])
def test_embedding_bag_kernel_matches_plain(cuda_device, d, dtype):
    """Against the float64 sums: within n_b · 2⁻²³ · Σ|rows| in float32,
    one bfloat16 rounding (2⁻⁸ of the sum) more in bfloat16; NaN exactly in
    the bags of the out-of-range rows; empty bags zero."""
    from repro_torch.kernels import ops

    v, n, nb = 5000, 40_000, 3001
    table, idx, bag = _bag_inputs(d, v, d, n, nb, dtype, cuda_device)
    got = ops.embedding_bag(table, idx, bag, nb, use_kernels=True).float()
    want = ops.embedding_bag(table, idx, bag, nb, use_kernels=False).float()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = (bag >= 0) & (bag < nb)
    b, i = bag[keep].long(), idx[keep].long()
    ok = (i >= 0) & (i < v)
    rows = table.double()[i.clamp(0, v - 1)]
    s = torch.zeros((nb, d), dtype=torch.float64, device=cuda_device).index_add_(0, b, rows)
    a = torch.zeros_like(s).index_add_(0, b, rows.abs())
    cnt = torch.bincount(b, minlength=nb)[:, None].double()
    limit = cnt * 2.0**-23 * a
    if dtype == torch.bfloat16:
        limit = 2.0**-8 * s.abs() + (1 + 2.0**-8) * limit
    bad = torch.zeros(nb, dtype=torch.bool, device=cuda_device)
    bad[b[~ok]] = True
    assert torch.isnan(got[bad]).all() and not torch.isnan(got[~bad]).any()
    assert bool(((got[~bad].double() - s[~bad]).abs() <= limit[~bad]).all())
    assert not got[1::2].any()                      # odd bags have no rows


@pytest.mark.cuda
def test_embedding_bag_kernel_one_row_bags_copy_and_sizes(cuda_device):
    """One-row bags are copies, bit for bit; N = 0 and num_bags = 0 are
    answered without a launch; the wrapper refuses int64 ids."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda

    table = torch.randn((100_000, 64), device=cuda_device)
    idx = torch.randint(0, 100_000, (50_000,), dtype=torch.int32, device=cuda_device)
    bag = torch.arange(50_000, dtype=torch.int32, device=cuda_device)
    ops.reset_launch_counts()
    assert torch.equal(ops.embedding_bag(table, idx, bag, 50_000, use_kernels=True),
                       table[idx.long()])
    assert ops.launch_counts()["embedding_bag"] == 1
    e = idx[:0]
    assert not embedding_bag_cuda(table, e, e, 7).any()
    assert embedding_bag_cuda(table, idx, bag, 0).shape == (0, 64)
    assert ops.launch_counts()["embedding_bag"] == 1
    with pytest.raises(ValueError, match="int32"):
        embedding_bag_cuda(table, idx.long(), bag, 50_000)


def _attn_inputs(seed, b, hq, hkv, lq, lk, dh, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, dtype)
            for s in ((b, hq, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,lq,lk,dh,off,causal", [
    (2, 6, 2, 300, 300, 128, 0, True),     # prefill, group 3
    (2, 6, 2, 100, 357, 128, 200, True),   # a later chunk; lk not a tile multiple
    (2, 6, 2, 1, 357, 128, 300, True),     # decode
    (1, 4, 4, 77, 77, 64, 0, True),        # MHA, Dh 64
    (1, 2, 1, 33, 256, 8, 0, False),       # non-causal, Dh 8
    (1, 2, 2, 5, 40, 256, 35, True),       # Dh 256, q_offset + lq == lk
    (2, 4, 2, 50, 77, 24, 27, True),       # Dh 24: a partial column block
    (2, 4, 2, 3, 77, 24, 74, True),        # Dh 24 with one-row tiles
    (1, 3, 3, 16, 640, 64, 0, False),      # Lq 16, non-causal
    (1, 3, 1, 17, 40, 128, 23, True),      # Lq 17: the smallest 64-row tile
    # bf16 on the tensor cores: Dh 128 and 64, the last tile crossing lk
    (1, 4, 2, 150, 333, 128, 183, True),
    (1, 4, 4, 200, 333, 64, 133, True),
    (2, 6, 2, 128, 400, 128, 256, True),   # a second chunk
    # split-K decode: group 3 and 8, Lq 2..16 with a causal end per row
    (2, 6, 2, 1, 2000, 128, 1500, True),
    (1, 16, 2, 1, 3000, 128, 2999, True),
    (1, 6, 2, 2, 900, 128, 898, True),
    (1, 6, 2, 7, 900, 128, 893, True),
    (1, 6, 2, 16, 900, 128, 884, True),
])
def test_flash_attention_kernel_matches_plain(cuda_device, b, hq, hkv, lq, lk, dh, off, causal,
                                              dtype):
    """Each element against the plain version on the inputs in float32: a
    float32 evaluation of sum_j p_j v_j errs by some roundings of
    sum_j p_j |v_j| (limit 1e-5 of that), and a bfloat16 output is one
    rounding of such a value (at most 2**-8 of its size more)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = _attn_inputs(lq + lk + dh, b, hq, hkv, lq, lk, dh, dtype, cuda_device)
    got = flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
    assert got.dtype == dtype and got.shape == q.shape
    q, k, v = q.float(), k.float(), v.float()
    want = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=off)
    limit = 1e-5 * ref.flash_attention_ref(q, k, v.abs(), causal=causal, q_offset=off)
    if dtype == torch.bfloat16:
        limit = 2.0**-8 * want.abs() + (1 + 2.0**-8) * limit
    worst = float(((got.float() - want).abs() / limit).max())
    assert worst <= 1.0, worst


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_with_empty_splits(cuda_device, dtype, monkeypatch):
    """40 splits of one key over the 24 admitted keys of a 4-row chunk at
    offset 20: splits 24..39 admit no key of any row, split 21..23 none of
    row 0; they merge with weight 0. Same limits as above; a second call
    (tickets reset by the first) gives the same output."""
    import importlib

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    monkeypatch.setattr(fa, "plan_splits", lambda heads, admitted, slots, cap: (40, 1))
    q, k, v = _attn_inputs(7, 2, 6, 2, 4, 900, 128, dtype, cuda_device)
    got = fa.flash_attention_cuda(q, k, v, causal=True, q_offset=20)
    assert torch.equal(got, fa.flash_attention_cuda(q, k, v, causal=True, q_offset=20))
    q, k, v = q.float(), k.float(), v.float()
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=20)
    limit = 1e-5 * ref.flash_attention_ref(q, k, v.abs(), causal=True, q_offset=20)
    if dtype == torch.bfloat16:
        limit = 2.0**-8 * want.abs() + (1 + 2.0**-8) * limit
    assert float(((got.float() - want).abs() / limit).max()) <= 1.0


@pytest.mark.cuda
def test_flash_decode_kernel_on_two_streams(cuda_device):
    """Decode calls of two problems at phi4-mini's decode shape, issued in
    turns on two side streams so their launches overlap: each stream has
    its own tickets and workspace, so every output equals the same call's
    output alone on the default stream, bit for bit."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    probs = [_attn_inputs(20 + i, 4, 24, 8, 1, 8193, 128, torch.bfloat16, cuda_device)
             for i in range(2)]
    alone = [flash_attention_cuda(*p, causal=True, q_offset=8192) for p in probs]
    streams = [torch.cuda.Stream(cuda_device) for _ in probs]
    outs = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    for _ in range(16):
        for i, (s, p) in enumerate(zip(streams, probs)):
            with torch.cuda.stream(s):
                outs[i].append(flash_attention_cuda(*p, causal=True, q_offset=8192))
    torch.cuda.synchronize(cuda_device)
    for i in range(2):
        assert all(torch.equal(o, alone[i]) for o in outs[i]), i


@pytest.mark.cuda
def test_flash_attention_kernel_dispatch_and_contracts(cuda_device):
    from repro_torch.kernels import ops

    q, k, v = _attn_inputs(0, 1, 4, 2, 16, 200, 32, torch.bfloat16, cuda_device)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, q_offset=184, use_kernels=True)  # Lq 16: one-row kernel
    assert ops.launch_counts()["flash_decode"] == 1
    assert torch.equal(out, ops.flash_attention(q, k, v, q_offset=184, use_kernels=True))
    ops.flash_attention(q[:, :, :15], k, v, q_offset=0, use_kernels=True)
    ops.flash_attention(torch.cat([q, q[:, :, :1]], 2), k, v, q_offset=0, use_kernels=True)
    assert ops.launch_counts()["flash_decode"] == 3
    assert ops.launch_counts()["flash_attention"] == 1  # Lq 17: the 64-row kernel
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    assert flash_attention_cuda.tc_launches == 0          # bf16 Dh 32: CUDA cores
    for dtype, dh, tc in ((torch.bfloat16, 128, 1), (torch.float32, 128, 0),
                          (torch.bfloat16, 8, 0)):
        a, b2, c = _attn_inputs(1, 1, 4, 2, 17, 40, dh, dtype, cuda_device)
        before = flash_attention_cuda.tc_launches
        ops.flash_attention(a, b2, c, q_offset=23, use_kernels=True)
        assert flash_attention_cuda.tc_launches - before == tc, (dtype, dh)
    assert ops.launch_counts()["flash_attention"] == 4
    ops.reset_launch_counts()
    assert flash_attention_cuda.tc_launches == 0
    q, k, v = _attn_inputs(0, 1, 4, 2, 16, 200, 32, torch.bfloat16, cuda_device)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, v, causal=False, use_kernels=True)
    with pytest.raises(ValueError, match="past the last"):
        ops.flash_attention(q, k, v, q_offset=185, use_kernels=True)
    with pytest.raises(ValueError, match="type"):
        ops.flash_attention(q.float(), k, v, q_offset=184, use_kernels=True)
    with pytest.raises(ValueError, match="16-byte"):   # Dh 20 in bf16
        ops.flash_attention(q[..., :20], k[..., :20], v[..., :20], use_kernels=True)
    shifted = torch.zeros(k.numel() + 1, dtype=k.dtype, device=cuda_device)[1:].view_as(k)
    with pytest.raises(ValueError, match="aligned"):   # contiguous, 2 bytes off
        ops.flash_attention(q, shifted, v, q_offset=184, use_kernels=True)
    assert ops.launch_counts()["flash_decode"] == 0
    assert ops.launch_counts()["flash_attention"] == 0
