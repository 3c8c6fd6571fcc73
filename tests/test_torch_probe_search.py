"""The member_probe kernel's search, mirrored step for step in plain
PyTorch (``ref.member_probe_two_level_ref``: 64-bit keys, the fixed-trip
search, fences and windows), against the JAX reference and the Pallas
kernel in interpret mode, and the port's plain version. Exact equality
throughout: the data are integers.

One query differs between the two JAX functions: ``(INT32_MAX,
INT32_MAX)`` against a table with pads. ``member_probe_ref`` maps pads to
``(INT32_MAX, INT32_MAX)`` and finds it; the Pallas kernel skips pad rows.
The port follows ``member_probe_ref`` (the kernel's pad key INT64_MAX is
that query's key), so that query is held to it alone
(``test_two_level_search_max_max_query``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.member_probe import member_probe_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.member_probe import MAX_FENCES, SMEM_KEYS, probe_stride

I32_MIN, I32_MAX = -2**31, 2**31 - 1
# lane values: the extremes, the pad value and a few small ids
_VALUES = np.array([I32_MIN, I32_MIN + 1, -7, -1, 0, 1, 2, 3, 5, 8, 13, I32_MAX - 1, I32_MAX])
_STRIDES = (1, 2, 4, 16)
# the JAX functions' query and table lengths (one compile for all cases)
_PALLAS_Q, _PALLAS_T = 256, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(rng, m, n_pad):
    """``m`` rows: unique (hi, lo) pairs of ``_VALUES`` in signed
    lexicographic order (no (-1, -1) among them), then ``n_pad`` pads."""
    pairs = np.stack(np.meshgrid(_VALUES, _VALUES, indexing="ij"), -1).reshape(-1, 2)
    pairs = pairs[~((pairs[:, 0] == -1) & (pairs[:, 1] == -1))]
    rows = pairs[np.sort(rng.choice(len(pairs), m - n_pad, replace=False))]
    return np.concatenate([rows, np.full((n_pad, 2), -1)]).astype(np.int32)


def _queries(rng, table, n):
    """Every table row, random pairs of ``_VALUES`` (so (-1, x), (x, -1),
    (-1, -1) and the extreme lanes), and (INT32_MAX, INT32_MAX)."""
    rand = rng.choice(_VALUES, (n, 2))
    special = [[-1, -1], [-1, 4], [4, -1], [I32_MIN, I32_MIN], [I32_MAX, I32_MIN],
               [I32_MIN, I32_MAX], [I32_MAX, I32_MAX]]
    q = np.concatenate([table, rand, special]).astype(np.int32)
    return q[:, 0].copy(), q[:, 1].copy()


def _check_all(q_hi, q_lo, t_hi, t_lo, strides, padded=True):
    """The mirror at each stride against the port's plain version; both
    against the JAX reference and the Pallas kernel. With ``padded`` the
    JAX functions see the queries and the table padded with (-1, -1) to one
    shape for every case (one compile each), which changes no answer but
    (MAX, MAX)'s, so that query is left out of their comparison there."""
    args = (q_hi, q_lo, t_hi, t_lo)
    plain = ref.member_probe_ref(*map(torch.from_numpy, args)).numpy()
    for s in strides:
        mirror = ref.member_probe_two_level_ref(*map(torch.from_numpy, args), s).numpy()
        assert mirror.dtype == np.bool_ and mirror.shape == plain.shape
        np.testing.assert_array_equal(mirror, plain, err_msg=f"stride {s}")
    n = q_hi.shape[0]
    if not padded:
        np.testing.assert_array_equal(plain, np.asarray(jref.member_probe_ref(
            *map(jnp.asarray, args))))
        return
    fill = lambda x, k: jnp.asarray(np.pad(x, (0, k - x.shape[0]), constant_values=-1))  # noqa: E731
    wide = [fill(x, k) for x, k in zip(args, (_PALLAS_Q, _PALLAS_Q, _PALLAS_T, _PALLAS_T))]
    keep = ~((q_hi == I32_MAX) & (q_lo == I32_MAX))
    want = np.asarray(jref.member_probe_ref(*wide))[:n]
    pallas = np.asarray(member_probe_pallas(*wide, tile_q=128, tile_t=64, interpret=True))[:n]
    np.testing.assert_array_equal(plain[keep], want[keep])
    np.testing.assert_array_equal(plain[keep], pallas[keep])


@pytest.mark.parametrize("m,n_pad", [(1, 0), (2, 1), (3, 0), (4, 0), (5, 2), (15, 0), (16, 0),
                                     (17, 0), (31, 3), (32, 0), (33, 1), (48, 0), (49, 0),
                                     (64, 16), (65, 0)])
def test_two_level_search_matches_jax(m, n_pad):
    """m from 1 to a few windows of 16, on both sides of each fence
    boundary, with and without pads, at strides 1, 2, 4 and 16."""
    rng = np.random.default_rng(m * 31 + n_pad)
    t = _table(rng, m, n_pad)
    _check_all(*_queries(rng, t, 40), t[:, 0].copy(), t[:, 1].copy(), _STRIDES)


@pytest.mark.parametrize("m", [1, 5, 16, 17])
def test_two_level_search_all_pad_tables(m):
    """Nothing is found in an all-pad table but (MAX, MAX), as in
    ``member_probe_ref``; the Pallas kernel finds nothing at all."""
    rng = np.random.default_rng(m)
    t = np.full((m, 2), -1, np.int32)
    q_hi, q_lo = _queries(rng, np.zeros((0, 2), np.int32), 30)
    _check_all(q_hi, q_lo, t[:, 0].copy(), t[:, 1].copy(), _STRIDES)
    found = ref.member_probe_two_level_ref(*map(torch.from_numpy, (q_hi, q_lo, t[:, 0].copy(),
                                                                   t[:, 1].copy())), 16)
    assert found.numpy().tolist() == ((q_hi == I32_MAX) & (q_lo == I32_MAX)).tolist()


@pytest.mark.parametrize("n_pad", [0, 3])
def test_two_level_search_max_max_query(n_pad):
    """(MAX, MAX) and the other extreme lanes against the JAX reference
    unpadded: found against a padded table, as in ``member_probe_ref``;
    the Pallas kernel there says no."""
    t = np.array([[I32_MIN, 5], [3, I32_MAX], [I32_MAX, I32_MIN]] + [[-1, -1]] * n_pad, np.int32)
    q = np.array([[I32_MAX, I32_MAX], [I32_MIN, 5], [3, I32_MAX], [I32_MAX, I32_MIN],
                  [-1, -1], [-1, 3], [3, -1], [I32_MIN, I32_MIN], [I32_MAX, 0]], np.int32)
    args = (q[:, 0].copy(), q[:, 1].copy(), t[:, 0].copy(), t[:, 1].copy())
    _check_all(*args, _STRIDES, padded=False)
    got = ref.member_probe_two_level_ref(*map(torch.from_numpy, args), 2).numpy()
    assert got.tolist() == [n_pad > 0, True, True, True, False, False, False, False, False]
    pallas = np.asarray(member_probe_pallas(*map(jnp.asarray, args), interpret=True))
    assert not pallas[0] and pallas[1:].tolist() == got[1:].tolist()


def test_probe_key_keeps_signed_lexicographic_order():
    """int64 order of the keys is signed (hi, lo) order, pads aside."""
    pairs = np.stack(np.meshgrid(_VALUES, _VALUES, indexing="ij"), -1).reshape(-1, 2)
    keys = ref.probe_key(*map(torch.from_numpy, (pairs[:, 0].copy(), pairs[:, 1].copy())))
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    assert torch.equal(torch.argsort(keys), torch.from_numpy(order))
    assert int(keys.max()) == torch.iinfo(torch.int64).max     # (MAX, MAX): the pad key
    assert int(keys.min()) == torch.iinfo(torch.int64).min     # (MIN, MIN)


def test_probe_stride():
    """1 up to the shared-memory table or while the queries are fewer than
    the rows, then the least power of two that leaves at most MAX_FENCES
    fences."""
    big = 1 << 40
    assert probe_stride(1, big) == probe_stride(SMEM_KEYS, big) == 1
    assert probe_stride(SMEM_KEYS + 1, big) == 2 and probe_stride(SMEM_KEYS + 1, SMEM_KEYS) == 1
    assert probe_stride(2 * MAX_FENCES, big) == 2 and probe_stride(2 * MAX_FENCES + 1, big) == 4
    assert probe_stride(116_669, 8_388_608) == 16 and probe_stride(116_669, 8192) == 1
    for m in (8193, 50_000, 116_669, 1 << 20, 2**31 - 1):
        s = probe_stride(m, m)
        assert s & (s - 1) == 0 and -(-m // s) <= MAX_FENCES < -(-m // (s // 2))


@pytest.mark.parametrize("m", [SMEM_KEYS - 1, SMEM_KEYS, SMEM_KEYS + 1, 116_669])
def test_two_level_search_at_the_kernel_sizes(m):
    """Tables straddling the shared-memory limit and the DDSL drop table's
    116,669 rows, at the kernel's own stride (and at 1 and 16): equal to
    the JAX reference on table rows, random and pad queries."""
    rng = np.random.default_rng(m)
    hi = rng.integers(0, 1 << 20, 2 * m)
    codes = np.unique(hi * (1 << 32) + hi + 1 + rng.integers(0, 4096, 2 * m))[:m - 8]
    t = np.concatenate([np.stack([codes >> 32, codes & 0xFFFFFFFF], 1),
                        np.full((8, 2), -1)]).astype(np.int32)
    q = rng.integers(-1, 1 << 20, (3000, 2)).astype(np.int32)
    q[:1500] = t[rng.integers(0, m, 1500)]
    q[::7] = -1
    strides = sorted({1, 16, probe_stride(m, 1 << 40)})
    _check_all(q[:, 0].copy(), q[:, 1].copy(), t[:, 0].copy(), t[:, 1].copy(), strides,
               padded=False)
