"""The set_intersect kernel's per-row algorithm, mirrored in plain PyTorch
(``ref.set_intersect_search_ref``: all-pad ``a`` rows skipped, ``b``'s
layout check with its prefix length, the fixed-trip search on rows in
layout, the compacted scan on the others, and the wide rows in shared or
global memory), against the JAX reference, the Pallas kernel in interpret
mode and the port's plain version. Exact equality throughout: the data are
integers.

Each path is forced by shrinking the mirror's budgets (``warp_ints``,
``staged_ints``) below the row's width, so a 5-wide row takes the wide
paths as a 9,000- or 60,000-wide row does on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.set_intersect import set_intersect_pallas
from repro_torch.kernels import ref

I32_MIN, I32_MAX = -2**31, 2**31 - 1
_KINDS = ("layout", "full", "all_pad", "unsorted", "dups", "mid_pad", "after_tail", "descent",
          "extremes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _routes(cb):
    """(warp_ints, staged_ints) that send rows of ``cb`` values down each
    of the kernel's three paths."""
    return {"warp": (ref._SI_WARP_INTS, 1 << 20), "shared": (cb - 1, cb),
            "global": (cb - 1, cb - 1)}


def _row(rng, c, pad, kind):
    """One row of ``c`` values of ``kind``; non-pad values from a small pool
    around ``pad`` (so duplicates, and values on both sides of it)."""
    pool = np.array([v for v in range(-3, 13) if v != pad])
    n = int(rng.integers(0, c + 1))
    r = np.full(c, pad, np.int64)
    r[:n] = np.sort(rng.choice(pool, n))                       # ascending, then the pad tail
    if kind == "layout":
        return r
    if kind == "full":
        return np.sort(rng.choice(pool, c))
    if kind == "all_pad":
        return np.full(c, pad, np.int64)
    if kind == "unsorted":
        return rng.choice(np.append(pool, [pad, pad]), c)
    if kind == "dups":
        return np.sort(rng.choice(pool[:2], c))
    full = np.sort(rng.choice(pool, c))
    if kind == "mid_pad":                                      # a pad with values after it
        full[rng.integers(0, c)] = pad
        return full
    if kind == "after_tail":                                   # a value past the pad tail
        r[rng.integers(n, c) if n < c else c - 1] = rng.choice(pool)
        return r
    if kind == "descent":                                      # one pair out of order
        p = int(rng.integers(0, c - 1)) if c > 1 else 0
        if c > 1:
            full[p], full[p + 1] = pool[-1], pool[0]
        return full
    assert kind == "extremes"                                  # INT32_MIN / INT32_MAX values
    ext = np.array([v for v in (I32_MIN, I32_MIN + 1, I32_MAX - 1, I32_MAX) if v != pad])
    r[:n] = np.sort(rng.choice(np.concatenate([pool, ext]), n))
    return r


def _inputs(seed, ca, cb, pad):
    """Every kind of ``b`` row against every kind of ``a`` row; ``a``'s
    values partly drawn from its ``b`` row."""
    rng = np.random.default_rng(seed)
    a, b = [], []
    for kb in _KINDS:
        for ka in _KINDS:
            rb = _row(rng, cb, pad, kb)
            ra = _row(rng, ca, pad, ka)
            take = rng.random(ca) < 0.4
            ra[take] = rng.choice(rb, ca)[take]
            a.append(ra)
            b.append(rb)
    return np.array(a, np.int32), np.array(b, np.int32)


def _check(a, b, pad):
    """The mirror on every path against the plain version, the JAX reference
    and the Pallas kernel."""
    plain = ref.set_intersect_ref(torch.from_numpy(a), torch.from_numpy(b), pad).numpy()
    want = np.asarray(jref.set_intersect_ref(jnp.asarray(a), jnp.asarray(b), pad))
    pallas = np.asarray(set_intersect_pallas(jnp.asarray(a), jnp.asarray(b), pad=pad, tile_g=8,
                                             interpret=True))
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(plain, pallas)
    for route, (warp_ints, staged_ints) in _routes(b.shape[1]).items():
        got = ref.set_intersect_search_ref(torch.from_numpy(a), torch.from_numpy(b), pad,
                                           warp_ints, staged_ints).numpy()
        assert got.dtype == np.bool_ and got.shape == plain.shape
        np.testing.assert_array_equal(got, plain, err_msg=route)
    return plain


@pytest.mark.parametrize("ca,cb,pad", [
    (1, 1, -1), (1, 3, 7), (3, 5, -1), (5, 3, I32_MIN), (5, 5, 7), (5, 5, -5), (8, 4, I32_MAX),
    (3, 513, -1), (513, 5, 7), (129, 130, -1), (513, 513, -1), (513, 513, 7)])
def test_search_matches_jax(ca, cb, pad):
    """Widths 1, 3, 5 and 513 (and around a 128-value chunk), pads -1, 7
    (amid the values), -5 and INT32_MIN (below them) and INT32_MAX: rows in
    layout, full, all pad, unsorted, with duplicates, a pad in the middle, a
    value past the pad tail, a descent, and INT32_MIN / INT32_MAX values."""
    a, b = _inputs(ca * 1009 + cb * 7 + (pad & 0xFFFF), ca, cb, pad)
    plain = _check(a, b, pad)
    assert plain.any() and not plain.all()


def _layout_np(row, pad):
    """The definition: the first pad's position, and whether the non-pad
    values are a non-decreasing prefix with only pads after them."""
    is_pad = row == pad
    nb = int(np.argmax(is_pad)) if is_pad.any() else row.shape[0]
    ok = bool(is_pad[nb:].all()) and bool((np.diff(row[:nb].astype(np.int64)) >= 0).all())
    return nb, ok


@pytest.mark.parametrize("cb", [1, 3, 4, 5, 127, 128, 129, 300, 513])
@pytest.mark.parametrize("pad", [-1, I32_MIN, I32_MAX])
def test_layout_check_is_the_definition(cb, pad):
    """The warp path's check (pairs in a lane, across lanes, across 128-value
    chunks through a carry; the prefix length from the first lane holding a
    pad) and the wide path's equal the definition on rows with a descent or
    a pad at every lane and chunk edge, values past the tail, all pads and
    none, with the pad below, amid or above the values."""
    rng = np.random.default_rng(cb)
    vals = np.sort(rng.choice(np.array([I32_MIN + 1, -7, 0, 1, 2, 5, 9, I32_MAX - 1]), cb))
    rows = [vals, np.full(cb, pad)]
    edges = sorted({p for p in (0, 1, 2, 3, 4, 31, 32, 127, 128, 129, 255, 256, cb - 2, cb - 1)
                    if 0 <= p < cb})
    for p in edges:
        r = np.array(vals)
        r[p:] = pad                                            # nb = p, in layout
        rows.append(r)
        if p + 1 < cb:
            r = np.array(vals)
            r[p], r[p + 1] = 9, -7                             # a descent at (p, p + 1)
            rows.append(r)
            r = np.array(vals)
            r[p] = pad                                         # a pad amid the values
            rows.append(r)
            r = np.array(vals)
            r[p + 1:] = pad
            r[-1] = 5                                          # a value past the tail
            rows.append(r)
    b = np.array(rows, np.int64)
    b = np.where(b == pad, pad, np.clip(b, I32_MIN + 1, I32_MAX - 1)).astype(np.int32)
    want = [_layout_np(r, pad) for r in b]
    for warp in (True, False):
        nb, nonpad, layout = ref.set_intersect_layout_ref(torch.from_numpy(b), pad, warp)
        assert [(int(n), bool(ok)) for n, ok in zip(nb, layout)] == want, warp
        assert nonpad.tolist() == (b != pad).sum(1).tolist()
    assert any(ok for _, ok in want) and (cb == 1 or not all(ok for _, ok in want))


def test_all_pad_rows_of_a_are_false_and_b_unread():
    """An all-pad ``a`` row is false on every path whatever its ``b`` row
    (even one of pads and ``a``'s own values), as in the references."""
    pad = 7
    a = np.array([[7, 7, 7], [7, 3, 7], [3, 7, 3]], np.int32)
    b = np.array([[7, 3, 7, 2, 7], [3, 7, 7, 7, 7], [7, 7, 7, 7, 7]], np.int32)
    got = _check(a, b, pad)
    assert got.tolist() == [[False] * 3, [False, True, False], [False] * 3]


def test_mirror_constants_are_the_kernels():
    """The mirror's warp budget and chunk are the kernel's (``kWarpInts``,
    ``kChunk``)."""
    src = open(ref.__file__.replace("ref.py", "csrc/set_intersect.cu")).read()
    assert f"kWarpInts = {ref._SI_WARP_INTS};" in src
    assert f"kChunk = {ref._SI_CHUNK};" in src
