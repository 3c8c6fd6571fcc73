"""The port's two kernels: plain versions vs the JAX references and the
Pallas kernels (interpret mode), and the dispatch rules. Exact equality
throughout: the data are integers. The CUDA kernels themselves are
checked in ``test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.member_probe import member_probe_pallas
from repro.kernels.set_intersect import set_intersect_pallas
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.member_probe import member_probe_cuda
from repro_torch.kernels.set_intersect import set_intersect_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(rng, n_rows, n_pad, hi_max):
    """Lex-sorted unique (hi, lo) rows with a (-1, -1) tail."""
    hi = rng.integers(0, hi_max, n_rows)
    lo = hi + 1 + rng.integers(0, hi_max, n_rows)
    rows = np.unique(np.stack([hi, lo], 1), axis=0)
    return np.concatenate([rows, np.full((n_pad, 2), -1)]).astype(np.int32)


def _queries(rng, n, table, hi_max):
    """Random, table-drawn (with duplicates) and pad queries."""
    q = rng.integers(-1, hi_max, (n, 2)).astype(np.int32)
    if table.shape[0]:
        take = rng.integers(0, table.shape[0], n // 2)
        q[: n // 2] = table[take]
    q[::5] = -1
    return q


def _probe_inputs(seed, n, n_rows, n_pad):
    rng = np.random.default_rng(seed)
    t = _table(rng, n_rows, n_pad, 40)
    q = _queries(rng, n, t, 40)
    return q[:, 0].copy(), q[:, 1].copy(), t[:, 0].copy(), t[:, 1].copy()


def _torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("seed,n,n_rows,n_pad", [
    (0, 300, 50, 6), (1, 1, 1, 0), (2, 257, 200, 0), (3, 64, 0, 4), (4, 100, 30, 30)])
def test_member_probe_plain_matches_jax_ref_and_pallas(seed, n, n_rows, n_pad):
    args = _probe_inputs(seed, n, n_rows, n_pad)
    got = ops.member_probe(*_torch(*args), use_kernels=False).numpy()
    want = np.asarray(jref.member_probe_ref(*map(jnp.asarray, args)))
    pallas = np.asarray(member_probe_pallas(*map(jnp.asarray, args), tile_q=128,
                                            tile_t=64, interpret=True))
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("n,m", [(0, 5), (7, 0), (0, 0)])
def test_member_probe_plain_empty(n, m):
    rng = np.random.default_rng(n + m)
    q = rng.integers(0, 9, (n, 2)).astype(np.int32)
    t = _table(rng, m, 0, 9)[:m] if m else np.zeros((0, 2), np.int32)
    args = (q[:, 0].copy(), q[:, 1].copy(), t[:, 0].copy(), t[:, 1].copy())
    got = ops.member_probe(*_torch(*args), use_kernels=False).numpy()
    want = np.asarray(jref.member_probe_ref(*map(jnp.asarray, args)))
    assert got.shape == (n,)
    np.testing.assert_array_equal(got, want)


def _set_inputs(seed, g, ca, cb, sorted_rows):
    rng = np.random.default_rng(seed)
    a = rng.integers(-1, 12, (g, ca)).astype(np.int32)
    b = rng.integers(-1, 12, (g, cb)).astype(np.int32)
    if sorted_rows:   # the CompTensors layout: ascending values, PAD tail
        a = np.sort(np.where(a < 0, 99, a), axis=1)
        b = np.sort(np.where(b < 0, 99, b), axis=1)
        a[a == 99] = -1
        b[b == 99] = -1
    if g:
        a[0] = -1     # an empty row
    return a, b


@pytest.mark.parametrize("seed,g,ca,cb,sorted_rows", [
    (0, 16, 8, 8, True), (1, 5, 3, 9, False), (2, 33, 1, 1, False), (3, 9, 16, 4, True)])
def test_set_intersect_plain_matches_jax_ref_and_pallas(seed, g, ca, cb, sorted_rows):
    a, b = _set_inputs(seed, g, ca, cb, sorted_rows)
    got = ops.set_intersect(*_torch(a, b), pad=-1, use_kernels=False).numpy()
    want = np.asarray(jref.set_intersect_ref(jnp.asarray(a), jnp.asarray(b), -1))
    pallas = np.asarray(set_intersect_pallas(jnp.asarray(a), jnp.asarray(b), pad=-1,
                                             tile_g=8, interpret=True))
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("g,ca,cb", [(0, 4, 4), (3, 0, 2), (3, 2, 0)])
def test_set_intersect_plain_empty(g, ca, cb):
    a = np.zeros((g, ca), np.int32)
    b = np.zeros((g, cb), np.int32)
    got = ops.set_intersect(*_torch(a, b), pad=-1, use_kernels=False).numpy()
    want = np.asarray(jref.set_intersect_ref(jnp.asarray(a), jnp.asarray(b), -1))
    assert got.shape == (g, ca)
    np.testing.assert_array_equal(got, want)


def test_member_probe_plain_slices_queries(monkeypatch):
    """The plain probe searches its queries a slice at a time; the result
    cannot depend on the slice."""
    args = _torch(*_probe_inputs(8, 300, 50, 6))
    whole = ops.member_probe(*args, use_kernels=False)
    monkeypatch.setattr(ref, "_PROBE_SLICE", 7)
    sliced = ops.member_probe(*args, use_kernels=False)
    assert torch.equal(whole, sliced)


@pytest.mark.parametrize("value,fits", [
    (0, True), (2**31 - 1, True), (-2**31, True), (-1, True),
    (2**31, False), (707_067_904 * 4, False), (-2**31 - 1, False)])
def test_int32_kernel_args_raise_instead_of_truncating(value, fits):
    """A size handed to a launcher as a C int raises where it would wrap."""
    if fits:
        assert build.int32_arg("k", "n", value) == value
    else:
        with pytest.raises(ValueError, match="int32"):
            build.int32_arg("k", "n", value)


def test_set_intersect_plain_slices_rows(monkeypatch):
    """The plain version slices its row axis; the result cannot depend on it."""
    a, b = _set_inputs(7, 40, 6, 5, False)
    whole = ops.set_intersect(*_torch(a, b), pad=-1, use_kernels=False)
    monkeypatch.setattr(ref, "_SLICE_CELLS", 64)
    sliced = ops.set_intersect(*_torch(a, b), pad=-1, use_kernels=False)
    assert torch.equal(whole, sliced)


def test_use_kernels_on_cpu_tensors_raises():
    a, b = _set_inputs(0, 4, 3, 3, True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.set_intersect(*_torch(a, b), pad=-1, use_kernels=True)
    args = _torch(*_probe_inputs(0, 10, 5, 1))
    with pytest.raises(ValueError, match="CUDA"):
        ops.member_probe(*args, use_kernels=True)


def test_kernel_wrappers_reject_cpu_tensors_without_launching():
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        member_probe_cuda(*_torch(*_probe_inputs(1, 10, 5, 1)))
    with pytest.raises(ValueError):
        set_intersect_cuda(*_torch(*_set_inputs(1, 4, 3, 3, True)), -1)
    assert ops.launch_counts() == before
