"""The CUDA kernels against their plain versions, on a GPU (exact
equality for the integer kernels, set_intersect on each of its paths and
on rows in and out of the layout it searches; segment_sum's float64 sums within 1e-5
of the largest, exact for integer sums, bitwise repeatable, and leaving
the accumulator rows outside a plan's range untouched; embedding_bag's float32 bag sums
within n_b · 2⁻²³ · Σ|rows| of the float64 sum (one bfloat16 rounding more
in bfloat16), one-row bags equal; member_probe and embedding_bag on offset
(misaligned) views and bitwise repeatable; flash_attention element by
element within 1e-5 of sum_j p_j |v_j| of the float32 plain version in
float32, and within one bfloat16 rounding of that in bfloat16, on each of
its three kernels, at MLA's widths too (V of 64 / 128 columns under Q and
K of 96 / 192: the tensor-core kernel at V's own width, the others on V
padded by the wrapper); flash_attention_bwd's dQ, dK and dV element by element
within ref.flash_attention_bwd_limits on both routes (bf16 on the tensor
cores from the forward's log-sum-exp, at minicpm3's MLA widths (96, 64)
too; float32 on the CUDA cores), repeatable, and through autograd; the
forward's log-sum-exp within 1e-5 of torch.logsumexp, at (96, 64) too, its
output bitwise unchanged by it; a float32 MLA gradient raising). Imports no
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


def _sized_table(seed, m, n_pad):
    """Exactly m rows: m - n_pad unique lex-sorted (hi, lo) pairs, then pads."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 20, 2 * m)
    codes = np.unique(hi * (1 << 32) + hi + 1 + rng.integers(0, 4096, 2 * m))
    codes = np.sort(rng.choice(codes, m - n_pad, replace=False))
    t = np.concatenate([np.stack([codes >> 32, codes & 0xFFFFFFFF], 1), np.full((n_pad, 2), -1)])
    return t.astype(np.int32)


def _view(t, offset):
    """t as a contiguous view ``offset`` elements into a larger buffer:
    misaligned for the kernel's 16-byte loads unless offset % 4 == 0."""
    buf = torch.full((t.shape[0] + offset,), -5, dtype=t.dtype, device=t.device)
    buf[offset:] = t
    return buf[offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,n_rows,n_pad,m,offset", [
    (0, 100_000, 9000, 64, None, 0), (1, 5000, 100, 0, None, 0),
    # the shared-memory table's limit, n % 4 != 0, misaligned queries
    (2, 100_003, 0, 0, 8191, 0), (3, 100_001, 0, 5, 8192, 1), (4, 99_999, 0, 0, 8193, 3),
    # strides 4 (4,097 and 8,192 fences) and 8; the DDSL drop table (stride 16)
    (5, 50_002, 0, 0, 16_385, 2), (6, 50_001, 0, 3, 32_768, 0), (7, 50_000, 0, 0, 32_769, 1),
    (8, 1_000_003, 0, 64, 116_669, 1), (9, 1_000_000, 0, 64, 116_669, 0),
    # fewer queries than rows: one search in global memory
    (10, 8195, 0, 64, 116_669, 1), (11, 100_000, 0, 0, 116_669, 0)])
def test_member_probe_kernel_matches_plain(cuda_device, seed, n, n_rows, n_pad, m, offset):
    """Equal to the plain version, on queries drawn from the table, random
    and pad; queries that are offset views of a buffer; two launches give
    the same bits."""
    from repro_torch.kernels.member_probe import probe_stride

    if m is None:
        args = [t.to(cuda_device) for t in _probe_inputs(seed, n, n_rows, n_pad)]
    else:
        t = torch.from_numpy(_sized_table(seed, m, n_pad)).to(cuda_device)
        rng = np.random.default_rng(seed)
        q = torch.from_numpy(rng.integers(-1, 1 << 20, (n, 2)).astype(np.int32)).to(cuda_device)
        q[: n // 2] = t[torch.from_numpy(rng.integers(0, m, n // 2)).to(cuda_device)]
        q[::5] = -1
        assert probe_stride(m, n) == (1 if n < m else {8191: 1, 8192: 1, 8193: 2, 16_385: 4,
                                                       32_768: 4, 32_769: 8, 116_669: 16}[m])
        args = [_view(q[:, 0].contiguous(), offset), _view(q[:, 1].contiguous(), offset),
                t[:, 0].contiguous(), t[:, 1].contiguous()]
    got = member_probe_cuda(*args)
    assert torch.equal(got, ref.member_probe_ref(*args))
    assert torch.equal(got, member_probe_cuda(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,g,ca,cb,sorted_rows", [(0, 4096, 512, 512, True),
                                                      (1, 7, 5000, 9000, False)])
def test_set_intersect_kernel_matches_plain(cuda_device, seed, g, ca, cb, sorted_rows):
    a, b = (t.to(cuda_device) for t in _set_inputs(seed, g, ca, cb, sorted_rows))
    assert torch.equal(set_intersect_cuda(a, b, -1), ref.set_intersect_ref(a, b, -1))


def _set_rows(rng, g, c, pad, v_max, kinds):
    """Rows in the CompTensors layout (ascending, then a pad tail of random
    length), then each row turned into ``kinds[row % len(kinds)]``."""
    vals = np.sort(rng.integers(0, v_max, (g, c)), axis=1)
    vals[np.arange(c)[None, :] >= rng.integers(0, c + 1, (g, 1))] = pad
    for i in range(g):
        kind = kinds[i % len(kinds)]
        if kind == "unsorted":
            vals[i] = rng.integers(0, v_max, c)
            vals[i, rng.random(c) < 0.2] = pad
        elif kind == "mid_pad" and c > 2:
            vals[i, :] = np.sort(rng.integers(0, v_max, c))
            vals[i, rng.integers(0, c - 1)] = pad
        elif kind == "after_tail" and c > 2:
            vals[i, c // 2:] = pad
            vals[i, -1] = 0
        elif kind == "extremes":
            vals[i, :] = np.sort(rng.integers(0, v_max, c))
            vals[i, 0], vals[i, -1] = -2**31, 2**31 - 1
        elif kind == "all_pad":
            vals[i, :] = pad
    return vals.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case,g,ca,cb,pad,kinds,offset,route", [
    # widths not a multiple of 4, and views 1 and 3 values into a buffer
    ("odd_widths", 1000, 511, 509, -1, ("layout",), 0, "warp"),
    ("narrow", 70, 1, 3, -1, ("layout", "unsorted"), 0, "warp"),
    ("misaligned", 1000, 512, 512, -1, ("layout",), 1, "warp"),
    # a pad in the middle, a value after the tail, pad = 7 amid the values
    ("mid_pad", 2000, 300, 300, -1, ("mid_pad", "after_tail", "layout"), 0, "warp"),
    ("pad_7", 2000, 64, 64, 7, ("layout", "mid_pad", "unsorted"), 0, "warp"),
    ("extremes", 2000, 64, 64, -1, ("extremes", "layout"), 0, "warp"),
    # rows in and out of layout, and all-pad rows, in one launch
    ("mixed", 4000, 512, 512, -1, ("layout", "unsorted", "layout", "all_pad", "mid_pad"), 0,
     "warp"),
    # wide rows: a block a row in shared memory, and past its limit in
    # global memory
    ("wide", 6, 5000, 9000, -1, ("layout", "unsorted", "mid_pad"), 0, "shared"),
    ("past_shared", 3, 5000, 60_000, -1, ("layout", "unsorted", "after_tail"), 0, "global")])
def test_set_intersect_kernel_paths(cuda_device, case, g, ca, cb, pad, kinds, offset, route):
    """Every path and layout of ``b``, each equal to the plain version and
    bitwise repeatable; ``a``'s values partly drawn from its ``b`` row."""
    from repro_torch.kernels.set_intersect import set_intersect_route

    rng = np.random.default_rng(ca + cb)
    b = _set_rows(rng, g, cb, pad, 4 * max(ca, cb), kinds)
    a = _set_rows(rng, g, ca, pad, 4 * max(ca, cb), ("layout",))
    take = rng.random((g, ca)) < 0.3
    a[take] = b[np.arange(g)[:, None], rng.integers(0, cb, (g, ca))][take]
    a, b = (_view(torch.from_numpy(t).reshape(-1).to(cuda_device), offset).view(t.shape)
            for t in (a, b))
    assert set_intersect_route(cb, cuda_device) == route
    got = set_intersect_cuda(a, b, pad)
    assert torch.equal(got, ref.set_intersect_ref(a, b, pad))
    assert torch.equal(got, set_intersect_cuda(a, b, pad))
    assert got.any()


@pytest.mark.cuda
def test_set_intersect_kernel_empty_inputs(cuda_device):
    """No launch for G = 0, CA = 0 or CB = 0; CB = 0 is all false."""
    before = set_intersect_cuda.launches
    for g, ca, cb in ((0, 4, 4), (3, 0, 5), (3, 4, 0)):
        a = torch.zeros((g, ca), dtype=torch.int32, device=cuda_device)
        b = torch.zeros((g, cb), dtype=torch.int32, device=cuda_device)
        out = set_intersect_cuda(a, b, -1)
        assert out.shape == (g, ca) and not out.any()
    assert set_intersect_cuda.launches == before


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
    """float64 sums in another order: within 1e-5 of the largest sum, for
    the ids as drawn (through the plan's order) and sorted (none)."""
    from repro_torch.kernels.segment_sum import segment_plan, segment_sum_cuda

    data, ids = _segment_inputs(e + d, e, d, n, dtype, cuda_device)
    zeros = lambda: torch.zeros((n, d), dtype=ref.ACC_DTYPE, device=cuda_device)  # noqa: E731
    for seg in (ids, torch.sort(ids).values):
        plan = segment_plan(seg, n)
        assert (plan.order is None) == bool((seg[1:] >= seg[:-1]).all())
        got = segment_sum_cuda(data, plan, zeros())
        want = ref.segment_sum_ref(data, seg, n, zeros())
        assert (got - want).abs().max() <= 1e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_segment_sum_kernel_counts_exactly_and_accumulates(cuda_device):
    """Integer sums of a ones column are exact; an accumulator passed in
    across two calls, each with its plan, equals one call over all rows;
    a plan is built once and launched on twice; no valid id, no launch."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_sum import segment_plan

    _, ids = _segment_inputs(9, 200_000, 1, 5000, torch.float32, cuda_device)
    ones = torch.ones((200_000, 1), dtype=torch.bfloat16, device=cuda_device)
    assert torch.equal(ops.segment_sum(ones, ids, 5000, use_kernels=True),
                       ops.segment_sum(ones, ids, 5000, use_kernels=False))
    data, ids = _segment_inputs(10, 80_000, 70, 900, torch.bfloat16, cuda_device)
    acc = torch.zeros((900, 70), dtype=ref.ACC_DTYPE, device=cuda_device)
    ops.reset_launch_counts()
    for s in (slice(0, 30_000), slice(30_000, None)):
        plan = segment_plan(ids[s], 900)
        ops.segment_sum(data[s], ids[s], 900, use_kernels=True, acc=acc, plan=plan)
    assert ops.launch_counts()["segment_sum"] == 2
    want = ref.segment_sum_ref(data, ids, 900, torch.zeros_like(acc))
    assert (acc - want).abs().max() <= 1e-5 * float(want.abs().max())
    assert not ops.segment_sum(data, torch.full_like(ids, -1), 900, use_kernels=True).any()
    assert ops.launch_counts()["segment_sum"] == 2


def _heavy_ids(seed, e, n, device, sort):
    """Half the rows in one id, three more hubs of 5,000, the rest spread."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, e)
    ids[rng.random(e) < 0.5] = n // 2
    ids[rng.choice(e, 15_000, replace=False)] = np.repeat([1, 7, n - 1], 5000)
    if sort:
        ids = np.sort(ids)
    return torch.from_numpy(ids.astype(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 70), (torch.float32, 3)])
def test_segment_sum_kernel_heavy_segment(cuda_device, dtype, d, sort):
    """Half the rows in one id: the hub is summed in parts and combined,
    within 1e-5 of the largest sum; and not serialised: five launches take
    at most 3x (+ 0.05 ms) those on the same rows spread over all ids."""
    from repro_torch.kernels.segment_sum import segment_plan, segment_sum_cuda

    e, n = 1 << 21, 20_000
    rng = np.random.default_rng(d)
    data = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(cuda_device, dtype)
    ids = _heavy_ids(d, e, n, cuda_device, sort)
    plan = segment_plan(ids, n)
    assert n // 2 in plan.heavy.tolist() and plan.n_parts > 1000
    got = segment_sum_cuda(data, plan, torch.zeros((n, d), dtype=ref.ACC_DTYPE,
                                                   device=cuda_device))
    want = ref.segment_sum_ref(data, ids, n, torch.zeros_like(got))
    assert (got - want).abs().max() <= 1e-5 * float(want.abs().max())

    spread_ids = torch.randint(0, n, (e,), dtype=torch.int32, device=cuda_device)
    spread = segment_plan(torch.sort(spread_ids).values if sort else spread_ids, n)

    def ms(p):
        acc = torch.zeros_like(got)
        segment_sum_cuda(data, p, acc)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            segment_sum_cuda(data, p, acc)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    assert ms(plan) <= 3 * ms(spread) + 0.05


@pytest.mark.cuda
def test_segment_sum_kernel_range_leaves_other_rows(cuda_device):
    """A launch over a sorted slice writes only the rows [lo, hi) of acc:
    every other row keeps its bits; the rows it does write equal acc plus
    the slice's sums."""
    from repro_torch.kernels.segment_sum import segment_plan, segment_sum_cuda

    n, d = 50_000, 70
    rng = np.random.default_rng(21)
    ids = torch.from_numpy(np.sort(rng.integers(0, n, 400_000)).astype(np.int32))
    data = torch.from_numpy(rng.normal(size=(400_000, d)).astype(np.float32))
    sl = slice(150_000, 250_000)
    data, ids = data[sl].to(cuda_device, torch.bfloat16), ids[sl].to(cuda_device)
    plan = segment_plan(ids, n)
    assert plan.order is None and 0 < plan.lo < plan.hi < n
    acc = torch.randn((n, d), dtype=ref.ACC_DTYPE, device=cuda_device)
    before = acc.clone()
    segment_sum_cuda(data, plan, acc)
    outside = torch.ones(n, dtype=torch.bool, device=cuda_device)
    outside[plan.lo:plan.hi] = False
    assert torch.equal(acc[outside], before[outside])
    want = ref.segment_sum_ref(data, ids, n, before.clone())
    assert (acc - want).abs().max() <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("heavy", [False, True])
def test_segment_sum_kernel_repeats_bitwise(cuda_device, heavy):
    """No atomics: two launches on the same plan give the same bits."""
    from repro_torch.kernels.segment_sum import segment_plan, segment_sum_cuda

    e, n, d = 1 << 20, 30_000, 70
    data = torch.randn((e, d), device=cuda_device)
    ids = (_heavy_ids(5, e, n, cuda_device, False) if heavy
           else torch.randint(-5, n + 5, (e,), dtype=torch.int32, device=cuda_device))
    plan = segment_plan(ids, n)
    assert (plan.n_parts > 0) == heavy
    one = segment_sum_cuda(data, plan, torch.zeros((n, d), dtype=ref.ACC_DTYPE,
                                                   device=cuda_device))
    two = segment_sum_cuda(data, plan, torch.zeros_like(one))
    assert torch.equal(one, two)


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


def _mixed_bags(seed, v, d, nb, dtype, device):
    """Sorted bags of 0, 1, 2, 31, 32, 33 or 100 rows, so that one-row and
    100-row bags share a 32-row window, bags cross windows and empty bags
    sit at window edges."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(device, dtype)
    sizes = rng.choice([0, 0, 1, 1, 1, 1, 2, 31, 32, 33, 100], nb)
    bag = np.repeat(np.arange(nb), sizes)
    idx = rng.integers(0, v, bag.shape[0])
    return table, *(torch.from_numpy(a.astype(np.int32)).to(device) for a in (idx, bag))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,layout", [(4, "uniform"), (8, "uniform"), (13, "uniform"),
                                      (64, "uniform"), (64, "mixed"), (64, "views"),
                                      (13, "mixed"), (160, "mixed")])
def test_embedding_bag_kernel_matches_plain(cuda_device, d, layout, dtype):
    """Against the float64 sums: within n_b · 2⁻²³ · Σ|rows| in float32,
    one bfloat16 rounding (2⁻⁸ of the sum) more in bfloat16; NaN exactly in
    the bags of the out-of-range rows; empty bags zero; one-row bags equal
    to the plain version; two launches bitwise equal. ``uniform``: unsorted
    ids with empty bags and out-of-range ids; ``mixed``: one-row and
    100-row bags in one window, bags crossing windows, empty bags at their
    edges; ``views``: sorted ids passed as misaligned offset views."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda

    v, n, nb = 5000, 40_000, 3001
    if layout == "mixed":
        table, idx, bag = _mixed_bags(d, v, d, nb, dtype, cuda_device)
    else:
        table, idx, bag = _bag_inputs(d, v, d, n, nb, dtype, cuda_device)
    idx, bag = ops.sort_by_bag(idx, bag)
    if layout == "views":
        idx, bag = _view(idx, 1), _view(bag, 3)
    got = embedding_bag_cuda(table, idx, bag, nb)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32   # NaN bags compare too
    assert torch.equal(got.view(bits), embedding_bag_cuda(table, idx, bag, nb).view(bits))
    want = ops.embedding_bag(table, idx, bag, nb, use_kernels=False)
    got, want = got.float(), want.float()
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
    assert not got[cnt[:, 0] == 0].any()            # empty bags are zero
    one = (cnt[:, 0] == 1) & ~bad
    assert torch.equal(got[one], want[one])


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


def _attn_inputs(seed, b, hq, hkv, lq, lk, dh, dtype, device, dv=None):
    """q [b, hq, lq, dh], k [b, hkv, lk, dh] and v [b, hkv, lk, dv] (dv
    defaults to dh)."""
    rng = np.random.default_rng(seed)
    dv = dh if dv is None else dv
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, dtype)
            for s in ((b, hq, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dv))]


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
    want, limit = ref.flash_attention_limits(q, k, v, causal=causal, q_offset=off)
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
    want, limit = ref.flash_attention_limits(q, k, v, causal=True, q_offset=20)
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


# MLA's widths: (Dqk, Dv) of minicpm3-4b and deepseek-v2-lite-16b
MLA_WIDTHS = [(96, 64), (192, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv", MLA_WIDTHS)
@pytest.mark.parametrize("b,hq,hkv,lq,lk,off,causal", [
    (2, 4, 4, 300, 300, 0, True),        # group 1; Lq not a multiple of 192; keys cross tiles
    (1, 6, 2, 150, 333, 183, True),      # group 3, q_offset > 0, the last tile crossing lk
    (1, 6, 2, 17, 40, 23, True),         # Lq 17, the smallest tensor-core call
    (1, 2, 2, 200, 4112, 3912, True),    # a later chunk over MLA's 4,112 keys (not 64k)
    (2, 6, 2, 100, 256, 0, False),       # non-causal, Lk a multiple of 128, group 3
])
def test_flash_attention_tc_at_mla_widths_matches_plain(cuda_device, b, hq, hkv, lq, lk, off,
                                                        causal, dqk, dv):
    """The tensor-core kernel at MLA's widths, V at its own Dv columns:
    the tensor-core route, one launch, ``[…, Dv]`` out, each element within
    the limits of ``test_flash_attention_kernel_matches_plain``."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, route

    q, k, v = _attn_inputs(lq + lk + dqk, b, hq, hkv, lq, lk, dqk, torch.bfloat16,
                           cuda_device, dv)
    assert route(lq, q.dtype, dqk, dv) == "tc"
    before = flash_attention_cuda.tc_launches
    got = flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
    assert flash_attention_cuda.tc_launches - before == 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, hq, lq, dv)
    want, limit = ref.flash_attention_limits(q, k, v, causal=causal, q_offset=off)
    assert float(((got.float() - want).abs() / limit).max()) <= 1.0
    assert torch.equal(got, flash_attention_cuda(q, k, v, causal=causal, q_offset=off))


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv", MLA_WIDTHS)
@pytest.mark.parametrize("dtype,lq,off,kind", [
    (torch.bfloat16, 1, 300, "decode_launches"),    # MLA decode at group 1
    (torch.float32, 1, 300, "decode_launches"),
    (torch.float32, 90, 211, "launches"),            # the float32 gates' prefill (CUDA cores)
])
def test_flash_attention_padded_routes_at_mla_widths(cuda_device, dqk, dv, dtype, lq, off, kind):
    """The one-width kernels at MLA's widths: V zero-padded to Dqk inside
    the wrapper, the output ``[…, Dv]`` within the same limits, no
    tensor-core launch."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = _attn_inputs(dqk + lq, 2, 4, 4, lq, 301, dqk, dtype, cuda_device, dv)
    before = getattr(flash_attention_cuda, kind), flash_attention_cuda.tc_launches
    got = flash_attention_cuda(q, k, v, causal=True, q_offset=off)
    assert getattr(flash_attention_cuda, kind) - before[0] == 1
    assert flash_attention_cuda.tc_launches == before[1]
    assert got.dtype == dtype and got.shape == (2, 4, lq, dv)
    want, limit = ref.flash_attention_limits(q, k, v, causal=True, q_offset=off)
    assert float(((got.float() - want).abs() / limit).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv", MLA_WIDTHS)
@pytest.mark.parametrize("dtype,lq,off", [
    (torch.bfloat16, 1, 300),     # decode: the wrapper pads the view
    (torch.float32, 90, 211),     # CUDA cores: the wrapper pads the view
    (torch.bfloat16, 90, 211),    # tensor cores: the wrapper copies the view
])
def test_flash_attention_takes_a_strided_v(cuda_device, dqk, dv, dtype, lq, off):
    """V as MLA's model hands it over, a head-major view of a ``[B, Lk,
    H·Dv]`` product, gives the contiguous V's output bit for bit."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = _attn_inputs(dqk + lq + 1, 2, 4, 4, lq, 301, dqk, dtype, cuda_device, dv)
    view = v.transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous()
    assert torch.equal(flash_attention_cuda(q, k, view, causal=True, q_offset=off),
                       flash_attention_cuda(q, k, v, causal=True, q_offset=off))


@pytest.mark.cuda
def test_flash_attention_refuses_at_mla_widths(cuda_device):
    """V wider than Q and K, V's leading dimensions not K's, a bf16 Dv that
    is not a whole number of 16-byte chunks, and the log-sum-exp at MLA's
    widths in float32 (it comes from the bf16 tensor-core kernel) all
    raise, and launch nothing."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = _attn_inputs(9, 1, 4, 4, 40, 40, 96, torch.bfloat16, cuda_device, 64)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="Dv <= Dh"):
        flash_attention_cuda(q, k, torch.cat([v, v, v], -1))
    with pytest.raises(ValueError, match="v \\[B, Hkv, Lk, Dv\\]"):
        flash_attention_cuda(q, k, v[:, :, :39].contiguous())
    with pytest.raises(ValueError, match="v \\[B, Hkv, Lk, Dv\\]"):
        flash_attention_cuda(q, k, v[:, :2].contiguous())
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q, k, v[..., :20].contiguous())
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_cuda(q.float(), k.float(), v.float(), return_lse=True)
    assert not any(ops.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,l,dh", [
    (2, 6, 2, 37, 64),      # group 3, a partial tile
    (1, 8, 8, 1, 128),      # L 1, MHA
    (1, 4, 1, 200, 128),    # group 4, tiles past the diagonal skipped
    (2, 16, 2, 65, 64),     # group 8, one row past a tile
    (1, 3, 3, 128, 128),    # whole tiles
    (2, 6, 2, 17, 128),     # group 3, one partial tile of 17 rows
])
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, b, hq, hkv, l, dh, dtype):
    """dQ, dK and dV element by element against the plain backward on the
    inputs in float32, within ``ref.flash_attention_bwd_limits`` (its
    docstring derives them); two launches bitwise equal (no atomics). bf16
    takes the tensor cores from the forward's log-sum-exp, float32 the
    CUDA cores."""
    from repro_torch.kernels.flash_attention import bwd_route, flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

    q, k, v = _attn_inputs(l + dh, b, hq, hkv, l, l, dh, dtype, cuda_device)
    (dout,) = _attn_inputs(l + dh + 1, b, hq, hkv, l, l, dh, dtype, cuda_device)[:1]
    if bwd_route(dtype, dh) == "tc":
        out, lse = flash_attention_cuda(q, k, v, causal=True, q_offset=0, return_lse=True)
    else:
        out, lse = flash_attention_cuda(q, k, v, causal=True, q_offset=0), None
    before = flash_attention_bwd_cuda.tc_launches
    got = flash_attention_bwd_cuda(q, k, v, out, dout, lse)
    assert flash_attention_bwd_cuda.tc_launches - before == int(dtype == torch.bfloat16)
    assert [g.dtype for g in got] == [dtype] * 3
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    want, limit = ref.flash_attention_bwd_limits(q, k, v, dout)
    for g, w, lim in zip(got, want, limit):
        assert float(((g.float() - w).abs() / lim).max()) <= 1.0
    again = flash_attention_bwd_cuda(q, k, v, out, dout, lse)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("l,dh", [(17, 128), (300, 64), (1000, 128)])
def test_flash_attention_forward_lse(cuda_device, l, dh):
    """The tensor-core forward's log-sum-exp: each row's log2-domain
    ``log2 Σⱼ 2^(sⱼ/√Dh · log2 e)`` within 1e-5 of max(1, |lse|) of
    ``torch.logsumexp`` of the masked scores; the output bitwise the same
    as without it; its rows a multiple of 64 floats apart."""
    import math

    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = _attn_inputs(l, 2, 6, 2, l, l, dh, torch.bfloat16, cuda_device)
    out, lse = flash_attention_cuda(q, k, v, causal=True, q_offset=0, return_lse=True)
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal=True, q_offset=0))
    assert lse.shape == (2, 6, l) and lse.dtype == torch.float32 and lse.stride(1) % 64 == 0
    s = torch.matmul(q.float(), k.float().repeat_interleave(3, dim=1).transpose(-1, -2))
    s = (s / math.sqrt(dh)).masked_fill(
        torch.ones(l, l, dtype=torch.bool, device=cuda_device).triu(1), -math.inf)
    want = torch.logsumexp(s, -1) / math.log(2.0)
    assert float(((lse - want).abs() / want.abs().clamp(min=1.0)).max()) <= 1e-5


@pytest.mark.cuda
def test_flash_attention_bwd_kernel_through_autograd(cuda_device):
    """``ops.flash_attention`` with grad: the forward keeps the log-sum-exp,
    the backward launches the tensor-core kernels once and gives their
    gradients; serving (no grad) launches it never."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

    q, k, v = _attn_inputs(3, 1, 6, 2, 90, 90, 128, torch.bfloat16, cuda_device)
    (dout,) = _attn_inputs(4, 1, 6, 2, 90, 90, 128, torch.bfloat16, cuda_device)[:1]
    ops.reset_launch_counts()
    with torch.inference_mode():
        ops.flash_attention(q, k, v, use_kernels=True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, use_kernels=True)
    out.backward(dout)
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_tc"]) == (2, 2)
    assert (counts["flash_attention_bwd"], counts["flash_attention_bwd_tc"]) == (1, 1)
    _, lse = flash_attention_cuda(q, k, v, causal=True, q_offset=0, return_lse=True)
    want = flash_attention_bwd_cuda(q, k, v, out.detach(), dout, lse)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,l", [
    (1, 40, 40, 300),    # minicpm3's heads, MHA
    (2, 6, 2, 37),       # group 3, a partial tile
    (1, 4, 4, 1000),     # the last tile crossing l
    (1, 8, 1, 129),      # group 8, one row past two tiles
])
def test_flash_attention_bwd_kernel_at_mla_widths(cuda_device, b, hq, hkv, l):
    """bf16 at (Dqk, Dv) = (96, 64), V and dO at their own width, on the
    tensor cores from the forward's log-sum-exp: dQ, dK and dV element by
    element within ``ref.flash_attention_bwd_limits``, two launches bitwise
    equal."""
    from repro_torch.kernels.flash_attention import bwd_route, flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

    bf16 = torch.bfloat16
    assert bwd_route(bf16, 96, 64) == "tc"
    q, k, v = _attn_inputs(l + 7, b, hq, hkv, l, l, 96, bf16, cuda_device, 64)
    (dout,) = _attn_inputs(l + 8, b, hq, hkv, l, l, 64, bf16, cuda_device)[:1]
    out, lse = flash_attention_cuda(q, k, v, causal=True, q_offset=0, return_lse=True)
    before = flash_attention_bwd_cuda.tc_launches
    got = flash_attention_bwd_cuda(q, k, v, out, dout, lse)
    assert flash_attention_bwd_cuda.tc_launches - before == 1
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    want, limit = ref.flash_attention_bwd_limits(q, k, v, dout)
    for g, w, lim in zip(got, want, limit):
        assert float(((g.float() - w).abs() / lim).max()) <= 1.0
    again = flash_attention_bwd_cuda(q, k, v, out, dout, lse)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("l", [17, 300, 1000])
def test_flash_attention_forward_lse_at_mla_widths(cuda_device, l):
    """The tensor-core forward's log-sum-exp at (96, 64) within 1e-5 of
    max(1, |lse|) of ``torch.logsumexp`` of the masked scores (scaled by
    1/√96); the output bitwise the same as without it."""
    import math

    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = _attn_inputs(l + 3, 2, 6, 2, l, l, 96, torch.bfloat16, cuda_device, 64)
    out, lse = flash_attention_cuda(q, k, v, causal=True, q_offset=0, return_lse=True)
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal=True, q_offset=0))
    assert lse.shape == (2, 6, l) and lse.stride(1) % 64 == 0
    s = torch.matmul(q.float(), k.float().repeat_interleave(3, dim=1).transpose(-1, -2))
    s = (s / math.sqrt(96)).masked_fill(
        torch.ones(l, l, dtype=torch.bool, device=cuda_device).triu(1), -math.inf)
    want = torch.logsumexp(s, -1) / math.log(2.0)
    assert float(((lse - want).abs() / want.abs().clamp(min=1.0)).max()) <= 1e-5


@pytest.mark.cuda
def test_flash_attention_autograd_takes_tc_at_mla_widths(cuda_device):
    """``ops.flash_attention`` with grad at (96, 64) in bf16, V a
    head-major view as MLA makes it: the forward keeps the log-sum-exp
    (the tensor-core route), the backward launches the tensor-core kernels
    once, with the kernel's gradients; in float32 the backward raises (no
    kernel takes a float32 MLA gradient) instead of falling back."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

    q, k, v = _attn_inputs(21, 1, 8, 8, 150, 150, 96, torch.bfloat16, cuda_device, 64)
    (dout,) = _attn_inputs(22, 1, 8, 8, 150, 150, 64, torch.bfloat16, cuda_device)[:1]
    view = v.transpose(1, 2).contiguous().transpose(1, 2)   # [b, h, l, 64], head-major
    ops.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, view)]
    out = ops.flash_attention(*leaves, use_kernels=True)
    out.backward(dout)
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_tc"]) == (1, 1)
    assert (counts["flash_attention_bwd"], counts["flash_attention_bwd_tc"]) == (1, 1)
    o, lse = flash_attention_cuda(q, k, v, causal=True, q_offset=0, return_lse=True)
    assert torch.equal(out.detach(), o)
    want = flash_attention_bwd_cuda(q, k, v, o, dout, lse)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(*leaves, use_kernels=True).backward(dout.float())


@pytest.mark.cuda
def test_flash_attention_bwd_kernel_refuses(cuda_device):
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

    q, k, v = _attn_inputs(5, 1, 4, 2, 40, 40, 96, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="Dh"):
        flash_attention_bwd_cuda(q, k, v, q, q)
    q, k, v = _attn_inputs(5, 1, 4, 2, 40, 48, 64, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="length"):
        flash_attention_bwd_cuda(q, k, v, q, q)
    q, k, v = _attn_inputs(5, 1, 4, 2, 40, 40, 64, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="type"):
        flash_attention_bwd_cuda(q, k, v.float(), q, q)
    # the bf16 route needs the forward's log-sum-exp, in its padded rows
    out, lse = flash_attention_cuda(q, k, v, causal=True, q_offset=0, return_lse=True)
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_bwd_cuda(q, k, v, out, out)
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_bwd_cuda(q, k, v, out, out, lse.contiguous())
    # the float32 route recomputes it and takes none; the forward keeps none in float32
    qf, kf, vf = q.float(), k.float(), v.float()
    with pytest.raises(ValueError, match="lse must be None"):
        flash_attention_bwd_cuda(qf, kf, vf, qf, qf, lse)
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_cuda(qf, kf, vf, causal=True, q_offset=0, return_lse=True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with pytest.raises(NotImplementedError, match="offset 0"):
        ops.flash_attention(*leaves, causal=False, use_kernels=True).sum().backward()
