"""The CUDA kernels against their plain versions, on a GPU (exact
equality). Imports no JAX, so it runs on the machine with the card:

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
