"""The segment plan of the port's segment sum, on the CPU.

``segment_plan`` against NumPy (``bincount`` / ``cumsum`` offsets, a
stable order, ids outside ``[0, n)`` outside ``[offsets[0], offsets[n])``,
``lo`` / ``hi``, the heavy segments' parts); ``segment_sum_plan_ref`` and
``ops.segment_sum(..., plan=...)`` against the JAX reference and the Pallas
kernel in interpret mode; the gatedgcn forward on a permuted edge list;
and the rejections. The inputs come from NumPy with a seed. Tolerance:
float32 sums taken in another order and precision (the port sums in
float64), 1e-5, as in ``tests/test_torch_gnn.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.registry import get_arch as j_get_arch
from repro.data.graphs import build_graph_data as j_build_graph_data
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import get_arch
from repro_torch.convert import graph_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.segment_sum import segment_plan, segment_sum_cuda
from repro_torch.models import gnn

# the module (the package exports a function of the same name)
ss = importlib.import_module("repro_torch.kernels.segment_sum")

KINDS = ["unsorted", "sorted", "out_of_range", "empty", "heavy"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(rng, kind, e, n):
    if kind == "sorted":          # ascending, padding id n at the tail
        ids = np.sort(rng.integers(0, n, e))
        ids[-e // 8:] = n
    elif kind == "unsorted":      # random order, many duplicates
        ids = rng.integers(0, n // 4, e)
    elif kind == "out_of_range":  # ids n, n + 3 and -1 mixed in
        ids = rng.integers(0, n, e)
        ids[rng.random(e) < 0.1] = n
        ids[rng.random(e) < 0.05] = n + 3
        ids[rng.random(e) < 0.1] = -1
    elif kind == "empty":         # no rows at all
        ids = np.zeros(0, np.int64)
    else:                         # half the rows in one id, the rest spread
        ids = rng.integers(0, n, e)
        ids[rng.random(e) < 0.5] = n // 3
    return ids.astype(np.int32)


def _numpy_plan(ids, n):
    """Offsets by bincount / cumsum; the stable order; lo and hi."""
    valid = ids[(ids >= 0) & (ids < n)]
    counts = np.bincount(valid, minlength=n)
    offsets = np.concatenate([[0], np.cumsum(counts)]) + np.count_nonzero(ids < 0)
    has = np.flatnonzero(counts)
    lo, hi = (int(has[0]), int(has[-1]) + 1) if has.size else (0, 0)
    return np.argsort(ids, kind="stable"), offsets, counts, lo, hi


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_segment_plan_matches_numpy(kind):
    rng = np.random.default_rng(len(kind))
    n = 50
    ids = _ids(rng, kind, 0 if kind == "empty" else 300, n)
    plan = segment_plan(torch.from_numpy(ids), n)
    order, offsets, counts, lo, hi = _numpy_plan(ids, n)
    assert plan.rows == ids.shape[0] and plan.n == n
    np.testing.assert_array_equal(plan.offsets.numpy(), offsets)
    assert plan.offsets.dtype == torch.int64
    assert (plan.lo, plan.hi) == (lo, hi)
    if kind in ("sorted", "empty"):
        assert plan.order is None
    else:
        assert plan.order.dtype == torch.int32
        np.testing.assert_array_equal(plan.order.numpy(), order)
    keys = ids[order]
    assert np.all(keys[:offsets[0]] < 0) and np.all(keys[offsets[n]:] >= n)
    assert np.all((keys[offsets[0]:offsets[n]] >= 0) & (keys[offsets[0]:offsets[n]] < n))
    heavy = np.flatnonzero(counts > ss.CHUNK_ROWS)
    np.testing.assert_array_equal(plan.heavy.numpy(), heavy)
    assert plan.n_parts == int(plan.parts[-1]) == 0   # 300 rows: no heavy segment here


def test_segment_plan_heavy_parts(monkeypatch):
    """Segments above CHUNK_ROWS are listed with ceil(len / CHUNK_ROWS)
    parts, at most MAX_PARTS; the prefix ends at n_parts."""
    monkeypatch.setattr(ss, "CHUNK_ROWS", 8)
    monkeypatch.setattr(ss, "MAX_PARTS", 5)
    ids = np.repeat(np.array([0, 2, 3, 7], np.int32), [9, 8, 100, 17])
    np.random.default_rng(0).shuffle(ids)
    plan = segment_plan(torch.from_numpy(ids), 9)
    assert plan.chunk == 8
    np.testing.assert_array_equal(plan.heavy.numpy(), [0, 3, 7])
    np.testing.assert_array_equal(plan.parts.numpy(), [0, 2, 7, 10])
    assert plan.n_parts == 10 and (plan.lo, plan.hi) == (0, 8)


def test_segment_plan_without_segments():
    plan = segment_plan(torch.tensor([-1, 0, 4], dtype=torch.int32), 0)
    assert (plan.lo, plan.hi, plan.n) == (0, 0, 0)
    np.testing.assert_array_equal(plan.offsets.numpy(), [1])


# ---------------------------------------------------------------------------
# sums by a plan against the JAX reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 5, 70])
@pytest.mark.parametrize("kind", KINDS)
def test_segment_sum_by_plan_matches_jax(kind, d):
    rng = np.random.default_rng([len(kind), d])
    e, n = (0 if kind == "empty" else 300), 50
    data = rng.normal(size=(e, d)).astype(np.float32)
    ids = _ids(rng, kind, e, n)
    want = np.asarray(jref.segment_sum_ref(jnp.asarray(data), jnp.asarray(ids), n))
    tdata, tids = torch.from_numpy(data), torch.from_numpy(ids)
    plan = segment_plan(tids, n)
    got_ref = ref.segment_sum_plan_ref(tdata, plan, n)
    got_ops = ops.segment_sum(tdata, tids, n, use_kernels=False, plan=plan)
    assert got_ref.dtype == got_ops.dtype == torch.float32
    assert got_ref.shape == got_ops.shape == (n, d)
    np.testing.assert_allclose(got_ref.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_ops.numpy(), want, atol=1e-5, rtol=1e-5)
    if e:
        pallas = np.asarray(jops.segment_sum(jnp.asarray(data), jnp.asarray(ids), n,
                                             backend="pallas_interpret"))
        np.testing.assert_allclose(got_ops.numpy(), pallas, atol=1e-5, rtol=1e-5)


def test_plan_sums_over_slices_touch_only_their_range():
    """Slices of a sorted id list share their boundary segments: each adds
    only into rows [lo, hi) of the accumulator, and together they equal
    one sum over all rows."""
    rng = np.random.default_rng(11)
    ids = torch.from_numpy(np.sort(rng.integers(0, 40, 400)).astype(np.int32))
    data = torch.from_numpy(rng.normal(size=(400, 6)).astype(np.float32))
    acc = torch.zeros((40, 6), dtype=ops.ACC_DTYPE)
    for s in range(0, 400, 96):
        plan = segment_plan(ids[s:s + 96], 40)
        before = acc.clone()
        ops.segment_sum(data[s:s + 96], ids[s:s + 96], 40, use_kernels=False, acc=acc,
                        plan=plan)
        outside = torch.ones(40, dtype=torch.bool)
        outside[plan.lo:plan.hi] = False
        assert torch.equal(acc[outside], before[outside])
        assert plan.lo == int(ids[s]) and plan.hi == int(ids[s:s + 96][-1]) + 1
    whole = ref.segment_sum_ref(data, ids, 40, torch.zeros_like(acc))
    np.testing.assert_allclose(acc.numpy(), whole.numpy(), atol=1e-12)


# ---------------------------------------------------------------------------
# the forward over a permuted edge list
# ---------------------------------------------------------------------------

def test_sort_edges_groups_by_destination():
    raw = j_build_graph_data(30, 100, 4, d_edge=3, seed=5, pad_nodes=32, pad_edges=120)
    g = graph_from_numpy(raw, "cpu")
    ed = gnn.sort_edges(g, 48, with_attr=True)
    seg = np.where(raw["edge_mask"], raw["dst"], 32)
    order = np.argsort(seg, kind="stable")
    np.testing.assert_array_equal(ed.seg.numpy(), seg[order])
    np.testing.assert_array_equal(ed.src.numpy(), np.clip(raw["src"], 0, 31)[order])
    np.testing.assert_array_equal(ed.dst.numpy(), np.clip(raw["dst"], 0, 31)[order])
    np.testing.assert_array_equal(ed.edge_attr.numpy(), raw["edge_attr"][order])
    assert len(ed.plans) == 3 and all(p.order is None for p in ed.plans)
    assert [p.rows for p in ed.plans] == [48, 48, 24]


@pytest.mark.parametrize("name", ["gatedgcn", "graphsage-reddit", "meshgraphnet"])
def test_forward_on_permuted_edges_matches(name, monkeypatch):
    """Node outputs do not depend on the order of the edge list (within
    the tolerance of test_gatedgcn_edge_slices_match_unsliced)."""
    jcfg = j_get_arch(name).smoke
    cfg = get_arch(name).smoke
    raw = j_build_graph_data(64, 240, jcfg.d_in, d_edge=jcfg.d_edge_in, seed=3,
                             pad_nodes=72, pad_edges=256)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    perm = np.random.default_rng(3).permutation(256)
    shuffled = dict(raw)
    for k in ("src", "dst", "edge_attr", "edge_mask"):
        shuffled[k] = raw[k][perm]
    monkeypatch.setattr(gnn, "EDGE_SLICE", 64)       # gatedgcn: 4 slices
    want = gnn.forward(params, graph_from_numpy(raw, "cpu"), cfg, use_kernels=False)
    got = gnn.forward(params, graph_from_numpy(shuffled, "cpu"), cfg, use_kernels=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# rejections
# ---------------------------------------------------------------------------

def test_wrong_plan_raises():
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, 10, 40).astype(np.int32))
    data = torch.ones((40, 3))
    plan = segment_plan(ids, 10)
    for bad_ids, bad_n in ((ids[:39], 10), (ids, 11)):
        with pytest.raises(ValueError, match="plan"):
            ops.segment_sum(data[:bad_ids.shape[0]], bad_ids, bad_n, use_kernels=False, plan=plan)
    with pytest.raises(ValueError, match="plan"):
        ref.segment_sum_plan_ref(data[:39], plan, 10)
    with pytest.raises(ValueError, match="plan"):
        ref.segment_sum_plan_ref(data, plan, 9)
    with pytest.raises(ValueError, match="ids"):
        segment_plan(ids.float(), 10)


def test_segment_sum_cuda_on_cpu_raises_without_launch():
    ids = torch.zeros(4, dtype=torch.int32)
    plan = segment_plan(ids, 3)
    before = ops.launch_counts()["segment_sum"]
    with pytest.raises(ValueError, match="CUDA"):
        segment_sum_cuda(torch.ones((4, 2)), plan, torch.zeros((3, 2), dtype=ops.ACC_DTYPE))
    with pytest.raises(ValueError, match="CUDA"):
        ops.segment_sum(torch.ones((4, 2)), ids, 3, use_kernels=True, plan=plan)
    assert ops.launch_counts()["segment_sum"] == before
