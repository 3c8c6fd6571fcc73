"""The CUDA kernels against their plain versions, on a GPU (exact
equality for the integer kernels; segment_sum's float64 sums within 1e-5
of the largest, exact for integer sums). Imports no JAX, so it runs on the machine with the card:

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
