"""Every primitive of ``repro_torch.engine`` against ``repro.dist.jax_engine``
on the same padded inputs, compared tensor for tensor (exact: the data are
integers), overflow counters included. Inputs come from the JAX
``pad_partition`` on ``conftest.random_graph`` graphs and cross over
through ``repro_torch.convert``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import random_graph

from repro.core import build_np_storage, symmetry_break
from repro.core.ddsl import choose_cover
from repro.core.estimator import GraphStats
from repro.core.join_tree import minimum_unit_decomposition
from repro.core.pattern import PATTERN_LIBRARY
from repro.dist import jax_engine as jje
from repro_torch import convert
from repro_torch import engine as tje

CAPS = dict(v_cap=64, deg_cap=32, e_cap=512, match_cap=2048, group_cap=1024,
            set_cap=32, pair_cap=128)
TINY = dict(v_cap=64, deg_cap=32, e_cap=512, match_cap=4, group_cap=4, set_cap=2,
            pair_cap=2)


def _cpu_partitions(pt):
    return convert.partitions_from_numpy(pt, device="cpu")


def _cpu_comp(tc):
    return convert.comp_from_numpy(tc, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _caps(kind=CAPS, pallas=False):
    return (jje.EngineCaps(**kind, use_pallas=pallas),
            tje.EngineCaps(**kind, use_kernels=False))


def _np(x):
    """NumPy view of any JAX / torch result (dataclasses as dicts)."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k if isinstance(k, str) else int(k): _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    if isinstance(x, (int, bool, str)) or x is None:
        return x
    return np.asarray(x)


def assert_same(a, b, path="out"):
    a, b = _np(a), _np(b)
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, f"{path}: shape {a.shape} vs {b.shape}"
        if a.dtype == np.bool_ or b.dtype == np.bool_:
            assert a.dtype == b.dtype, f"{path}: dtype {a.dtype} vs {b.dtype}"
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                          err_msg=path)
    else:
        assert a == b, f"{path}: {a} vs {b}"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _setup(pname, seed=3, n=40, m_edges=100, parts=4):
    g = random_graph(n, m_edges, seed=seed)
    pat = PATTERN_LIBRARY[pname]
    ord_ = symmetry_break(pat)
    cover = choose_cover(pat, ord_, GraphStats.of(g))
    units = minimum_unit_decomposition(pat, cover)
    return g, pat, ord_, cover, units, build_np_storage(g, parts)


def _pads(part, kind=CAPS):
    jc, tc = _caps(kind)
    jpt = jje.pad_partition(part, jc)
    return jpt, _cpu_partitions(jpt)


# ---------------------------------------------------------------------------
# Padding and compaction
# ---------------------------------------------------------------------------

def test_pad_partition_matches_and_raises():
    _, _, _, _, _, storage = _setup("q2_triangle")
    jc, tc = _caps()
    for part in storage.parts:
        assert_same(jje.pad_partition(part, jc), tje.pad_partition(part, tc, "cpu"))
    small = dataclasses.replace(tc, deg_cap=1)
    with pytest.raises(ValueError, match="deg_cap"):
        tje.pad_partition(storage.parts[0], small, "cpu")


@pytest.mark.parametrize("fn", ["_compact_index", "_take_index"])
@pytest.mark.parametrize("cap", [1, 7, 40, 64])
def test_compaction_index(fn, cap):
    ok = np.random.default_rng(cap).random(50) < 0.4
    assert_same(getattr(jje, fn)(jnp.asarray(ok), cap), getattr(tje, fn)(_t(ok), cap))


@pytest.mark.parametrize("cap", [3, 30, 80])
def test_compact_rows_and_vec(cap):
    rng = np.random.default_rng(cap)
    rows = rng.integers(-1, 50, (60, 3)).astype(np.int32)
    ok = rng.random(60) < 0.5
    assert_same(jje._compact_rows(jnp.asarray(rows), jnp.asarray(ok), cap),
                tje._compact_rows(_t(rows), _t(ok), cap))
    assert_same(jje._compact_vec(jnp.asarray(rows[:, 0]), jnp.asarray(ok), cap, fill=-1),
                tje._compact_vec(_t(rows[:, 0]), _t(ok), cap, fill=-1))


# ---------------------------------------------------------------------------
# Listing and compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pname", ["q2_triangle", "q1_square", "q3_diamond"])
@pytest.mark.parametrize("kind", ["caps", "tiny"])
def test_unit_list_and_compress_plain(pname, kind):
    kind = CAPS if kind == "caps" else TINY
    _, _, ord_, cover, units, storage = _setup(pname)
    jc, tc = _caps(kind)
    ovf = 0
    for u in units:
        plan = jje.build_unit_plan(u.pattern, u.anchor_in(cover), ord_)
        for part in storage.parts[:2]:
            jpt, tpt = _pads(part, kind)
            jout = jje.unit_list(jpt, plan, jc)
            tout = tje.unit_list(tpt, plan, tc)
            assert_same(jout, tout)
            jcomp = jje.compress_plain(*jout[:2], plan.cols, cover, jc)
            tcomp = tje.compress_plain(*tout[:2], plan.cols, cover, tc)
            assert_same(jcomp, tcomp)
            ovf += int(tout[2]) + int(tcomp[2])
    if kind is TINY:
        assert ovf > 0   # undersized caps: drops are counted


def test_unit_list_require_edges_mask():
    g, _, ord_, cover, units, storage = _setup("q2_triangle")
    jc, tc = _caps()
    req = g.edges()[::7][:5].astype(np.int32)
    u = units[0]
    plan = jje.build_unit_plan(u.pattern, u.anchor_in(cover), ord_)
    jpt, tpt = _pads(storage.parts[1])
    assert_same(jje.unit_list(jpt, plan, jc, require_edges=jnp.asarray(req)),
                tje.unit_list(tpt, plan, tc, require_edges=_t(req)))


@pytest.mark.parametrize("n_groups,S", [(4, 2), (40, 2), (40, 3), (5, 0)])
def test_group_rows(n_groups, S):
    rng = np.random.default_rng(n_groups + S)
    rows = rng.integers(-1, 4, (30, S)).astype(np.int32)
    ok = rng.random(30) < 0.7
    assert_same(jje.group_rows(jnp.asarray(rows), jnp.asarray(ok), n_groups),
                tje.group_rows(_t(rows), _t(ok), n_groups))


@pytest.mark.parametrize("set_cap", [2, 8])
def test_scatter_grouped_values(set_cap):
    rng = np.random.default_rng(set_cap)
    g = rng.integers(0, 7, 80).astype(np.int32)     # 6 = dump index
    vals = rng.integers(-1, 12, 80).astype(np.int32)
    assert_same(jje.scatter_grouped_values(jnp.asarray(g), jnp.asarray(vals), 6, set_cap),
                tje.scatter_grouped_values(_t(g), _t(vals), 6, set_cap))


# ---------------------------------------------------------------------------
# CC-join
# ---------------------------------------------------------------------------

def _unit_comps(pname, kind, seed=3):
    """Compressed unit tables of two units on one partition (JAX-built)."""
    _, pat, ord_, cover, units, storage = _setup(pname, seed=seed)
    jc, _ = _caps(kind)
    jpt = jje.pad_partition(storage.parts[0], jc)
    out = []
    for u in units[:2]:
        plan = jje.build_unit_plan(u.pattern, u.anchor_in(cover), ord_)
        tbl, valid, _ = jje.unit_list(jpt, plan, jc)
        out.append(jje.compress_plain(tbl, valid, plan.cols, cover, jc)[0])
    jplan = jje.JoinPlan.make(units[0].pattern, units[1].pattern, cover, ord_)
    return out, jplan


@pytest.mark.parametrize("pname", ["q1_square", "q5_house"])
@pytest.mark.parametrize("kind,pallas", [("caps", False), ("caps", True), ("tiny", False)])
def test_ccjoin_local(pname, kind, pallas):
    kind = CAPS if kind == "caps" else dict(TINY, match_cap=2048)
    (jA, jB), jplan = _unit_comps(pname, kind)
    jc, tc = _caps(kind, pallas=pallas)
    jout = jje.ccjoin_local(jA, jB, jplan, jc)
    tout = tje.ccjoin_local(_cpu_comp(jA), _cpu_comp(jB),
                            jplan, tc)
    assert_same(jout, tout)


def test_filter_set_rows():
    rng = np.random.default_rng(4)
    vals = rng.integers(-1, 30, (12, 9)).astype(np.int32)
    ok = rng.random((12, 9)) < 0.5
    for cap in (3, 9, 12):
        assert_same(jje._filter_set_rows(jnp.asarray(vals), jnp.asarray(ok), cap),
                    tje._filter_set_rows(_t(vals), _t(ok), cap))


# ---------------------------------------------------------------------------
# Candidate update primitives
# ---------------------------------------------------------------------------

def test_dedup_and_lookup_sorted():
    rng = np.random.default_rng(5)
    rows = rng.integers(-1, 20, (40, 2)).astype(np.int32)
    ok = rows[:, 0] >= 0
    for cap in (5, 64):
        assert_same(jje.dedup_rows(jnp.asarray(rows), jnp.asarray(ok), cap),
                    tje.dedup_rows(_t(rows), _t(ok), cap))
    table = np.concatenate([np.unique(rows[:, 1][rows[:, 1] >= 0]),
                            np.full(4, -1)]).astype(np.int32)
    q = rng.integers(-1, 25, (6, 5)).astype(np.int32)
    assert_same(jje.lookup_sorted(jnp.asarray(table), jnp.asarray(q)),
                tje.lookup_sorted(_t(table), _t(q)))


@pytest.mark.parametrize("pallas", [False, True])
def test_edge_probe(pallas):
    rng = np.random.default_rng(6)
    t = np.unique(np.sort(rng.integers(0, 15, (30, 2)), axis=1), axis=0)
    t = t[t[:, 0] != t[:, 1]]
    t = np.concatenate([t, np.full((5, 2), -1)]).astype(np.int32)
    q = rng.integers(-1, 15, (7, 6, 2)).astype(np.int32)
    q[:, :3] = t[rng.integers(0, len(t), (7, 3))]
    j = jje.edge_probe(*(jnp.asarray(x) for x in (q[..., 0], q[..., 1], t[:, 0], t[:, 1])),
                       use_pallas=pallas)
    tt = tje.edge_probe(*(_t(x) for x in (q[..., 0], q[..., 1], t[:, 0], t[:, 1])))
    assert_same(j, tt)


def test_center_adj_contrib():
    _, _, _, _, _, storage = _setup("q2_triangle")
    jpt, tpt = _pads(storage.parts[2])
    ids = np.array([0, 2, 5, 9, 13, 22, 39, -1, -1], np.int32)
    ok = ids >= 0
    assert_same(jje.center_adj_contrib(jpt, jnp.asarray(ids), jnp.asarray(ok)),
                tje.center_adj_contrib(tpt, _t(ids), _t(ok)))


@pytest.mark.parametrize("count_overflow", [True, False])
@pytest.mark.parametrize("D", [3, 8])
def test_apply_edge_delta_rows(count_overflow, D):
    rng = np.random.default_rng(D)
    ids = np.array([1, 3, 4, 8, 10, -1], np.int32)
    rows = np.full((6, D), -1, np.int32)
    for i in range(5):
        nb = np.unique(rng.integers(0, 12, rng.integers(0, D + 1)))[:D]
        rows[i, : len(nb)] = nb
    add = np.array([[1, 3], [3, 4], [8, 11], [4, 10], [1, 20], [-1, -1], [10, 8]], np.int32)
    dele = np.array([[1, rows[0, 0]], [4, 3], [-1, -1]], np.int32)
    assert_same(jje.apply_edge_delta_rows(jnp.asarray(ids), jnp.asarray(rows),
                                          jnp.asarray(add), jnp.asarray(dele), 16,
                                          count_overflow=count_overflow),
                tje.apply_edge_delta_rows(_t(ids), _t(rows), _t(add), _t(dele), 16,
                                          count_overflow=count_overflow))


def _patch_inputs(storage, seed):
    """Well-formed patch_partition inputs: candidates, a lex-sorted drop
    table, and insertions disjoint from the surviving stored edges."""
    rng = np.random.default_rng(seed)
    g = storage.graph
    edges = g.edges()
    drop = edges[rng.choice(len(edges), 12, replace=False)]
    cand_ids = np.unique(drop.reshape(-1))
    ins = set()
    while len(ins) < 8:
        a, b = rng.choice(cand_ids, 2, replace=False)
        ins.add((min(a, b), max(a, b)))
    ins = np.array(sorted(ins))
    drop = np.unique(np.concatenate([drop, ins]), axis=0)   # every insertion is dropped
    cand = np.full(32, -1, np.int32)
    cand[: len(cand_ids)] = cand_ids
    cand_valid = cand >= 0
    dt = np.full((drop.shape[0] + 3, 2), -1, np.int32)
    dt[: len(drop)] = drop
    ins_ok = rng.random(len(ins)) < 0.7
    return (cand, cand_valid, dt[:, 0].copy(), dt[:, 1].copy(),
            ins[:, 0].astype(np.int32), ins[:, 1].astype(np.int32), ins_ok)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_patch_partition(pallas, seed):
    _, _, _, _, _, storage = _setup("q2_triangle", n=24, m_edges=60, parts=1)
    jpt, tpt = _pads(storage.parts[0])
    args = _patch_inputs(storage, seed=seed)
    jc, tc = _caps(CAPS, pallas)
    jout = jje.patch_partition(jpt, *map(jnp.asarray, args), 24, 1, jnp.int32(0), jc,
                               use_pallas=pallas)
    tout = tje.patch_partition(tpt, *map(_t, args), 24, 1, 0, tc)
    assert_same(jout, tout)


# ---------------------------------------------------------------------------
# Maintenance: delete filter, merges, counts
# ---------------------------------------------------------------------------

def test_deleted_edge_cols():
    for pname in ("q1_square", "q5_house", "q2_triangle"):
        _, pat, ord_, cover, _, _ = _setup(pname)
        skel = tuple(c for c in sorted(cover))
        assert jje.deleted_edge_cols(pat, skel) == tje.deleted_edge_cols(pat, skel)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("pname", ["q1_square", "q5_house"])
def test_filter_deleted_dev(pname, pallas):
    (jA, jB), jplan = _unit_comps(pname, CAPS)
    jc, tc = _caps(CAPS)
    joined, _ = jje.ccjoin_local(jA, jB, jplan, jc)
    g, pat, *_ = _setup(pname)
    skel_pairs, comp_pairs = jje.deleted_edge_cols(jplan.pattern, jplan.skel_out)
    dele = g.edges()[::3][:20]
    dt = np.full((24, 2), -1, np.int32)
    dt[:20] = dele
    dt[:20] = dt[np.lexsort((dt[:20, 1], dt[:20, 0]))]
    jout = jje.filter_deleted_dev(joined, skel_pairs, comp_pairs, jnp.asarray(dt[:, 0]),
                                  jnp.asarray(dt[:, 1]), 16, use_pallas=pallas)
    tout = tje.filter_deleted_dev(_cpu_comp(joined), skel_pairs, comp_pairs,
                                  _t(dt[:, 0]), _t(dt[:, 1]), 16)
    assert_same(jout, tout)


@pytest.mark.parametrize("group_cap,set_cap", [(1024, 32), (7, 2)])
def test_merge_groups_and_tables(group_cap, set_cap):
    (jA, jB), jplan = _unit_comps("q1_square", CAPS)
    jc, _ = _caps(CAPS)
    joined, _ = jje.ccjoin_local(jA, jB, jplan, jc)
    tj = _cpu_comp(joined)
    assert_same(jje.merge_groups(joined.skeleton, joined.valid, joined.sets, group_cap, set_cap),
                tje.merge_groups(tj.skeleton, tj.valid, tj.sets, group_cap, set_cap))
    # a second table with overlapping skeletons: the first half of the groups
    half = joined.valid & (jnp.arange(joined.valid.shape[0]) % 2 == 0)
    other = jje.CompTensors(skeleton=joined.skeleton, valid=half, sets=joined.sets)
    assert_same(jje.merge_tables_dev(joined, other, group_cap, set_cap),
                tje.merge_tables_dev(tj, _cpu_comp(other), group_cap, set_cap))


@pytest.mark.parametrize("pname", ["q1_square", "q5_house"])
def test_count_matches_dev(pname):
    (jA, jB), jplan = _unit_comps(pname, CAPS)
    jc, _ = _caps(CAPS)
    joined, _ = jje.ccjoin_local(jA, jB, jplan, jc)
    g, pat, ord_, *_ = _setup(pname)
    want = int(jje.count_matches_dev(joined, jplan.skel_out, ord_))
    got = tje.count_matches_dev(_cpu_comp(joined), jplan.skel_out, ord_)
    assert int(got) == want and want > 0


def _dense_sets(G, S, k, seed):
    rng = np.random.default_rng(seed)
    sets = {}
    for v in range(2, 2 + k):
        sets[v] = np.stack([rng.permutation(10_000)[:S] for _ in range(G)]).astype(np.int32)
    skel = np.stack([np.full(G, 20_000), np.full(G, 20_001)], 1).astype(np.int32)
    return jje.CompTensors(skeleton=jnp.asarray(skel), valid=jnp.ones(G, bool),
                           sets={v: jnp.asarray(a) for v, a in sets.items()})


def test_count_matches_dev_above_2_pow_24():
    """Two compressed vertices, 80 groups of 512 distinct values each:
    about 2.1e7 > 2**24 injective pairs, counted exactly."""
    tc = _dense_sets(80, 512, 2, seed=0)
    a, b = np.asarray(tc.sets[2]), np.asarray(tc.sets[3])
    want = sum(512 * 512 - len(np.intersect1d(x, y)) for x, y in zip(a, b))
    got = int(tje.count_matches_dev(_cpu_comp(tc), (0, 1), ()))
    assert got == want > 2**24


@pytest.mark.parametrize("k,ord_", [(3, ((2, 3),)), (4, ((2, 3), (3, 4)))])
def test_count_matches_dev_three_and_four_vertices(k, ord_):
    tc = _dense_sets(5, 9, k, seed=k)
    assert int(tje.count_matches_dev(_cpu_comp(tc), (0, 1), ord_)) == \
        int(jje.count_matches_dev(tc, (0, 1), ord_))
