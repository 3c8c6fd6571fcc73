"""The port's host engine (``repro_torch.core``: the Alg. 4 update of the NP
storage, listing, the Nav-join, incremental maintenance, the unit-table
cache and the ``DDSL`` facade) against the JAX package's modules on the same
NumPy inputs, made from seeds: every partition's arrays, every report's
counters and every compressed table byte for byte."""

import dataclasses

import numpy as np
import pytest

from conftest import random_graph

from repro.core import DDSL as JDDSL
from repro.core import storage as jstorage
from repro.core.incremental import apply_update_to_matches as japply
from repro.core.incremental import incremental_update as jincremental
from repro.core.listing import ExecutionReport as JExecReport
from repro.core.listing import execute_join_tree as jexecute
from repro.core.navjoin import NavReport as JNavReport
from repro.core.navjoin import nav_join_patch as jnav
from repro.core.pattern import PATTERN_LIBRARY as JLIB
from repro.core.unit_cache import PartitionUnitCache as JCache
from repro.data.graphs import sample_update
from repro.planner import CompileContext as JContext
from repro.planner import compile_plan as jcompile
from repro_torch.core import DDSL, choose_cover
from repro_torch.core import storage as tstorage
from repro_torch.core.estimator import GraphStats
from repro_torch.core.graph import Graph, GraphUpdate
from repro_torch.core.incremental import apply_update_to_matches, incremental_update
from repro_torch.core.listing import ExecutionReport, execute_join_tree
from repro_torch.core.navjoin import NavReport, nav_join_patch
from repro_torch.core.pattern import PATTERN_LIBRARY
from repro_torch.core.unit_cache import CacheStats, PartitionUnitCache
from repro_torch.planner import CompileContext, compile_plan


def _port_graph(g) -> Graph:
    return Graph._from_codes(g.n, np.asarray(g.codes, np.int64))


def _port_update(u) -> GraphUpdate:
    return GraphUpdate(delete=np.asarray(u.delete, np.int64).reshape(-1, 2),
                       add=np.asarray(u.add, np.int64).reshape(-1, 2))


def _updates(g, rounds, d, a, seed0):
    """``rounds`` sampled updates applied in turn: [(jax update, port update)]."""
    out = []
    for b in range(rounds):
        u = sample_update(g, d, a, seed=seed0 + b)
        out.append((u, _port_update(u)))
        g = g.apply_update(u)
    return out


def _same_partition(jp, tp):
    assert jp.pid == tp.pid and jp.num_edges == tp.num_edges
    for f in ("vertices", "center_mask", "indptr", "indices", "codes"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _same_storage(js, ts):
    assert js.m == ts.m and len(js.parts) == len(ts.parts)
    assert np.array_equal(js.graph.codes, ts.graph.codes) and js.graph.n == ts.graph.n
    for jp, tp in zip(js.parts, ts.parts):
        _same_partition(jp, tp)


def _same_table(jt, tt):
    """Compressed tables equal byte for byte: cover, skeleton, every value
    set (hence the same decompressed rows and group counts)."""
    assert tt.cover == jt.cover and tt.skeleton_cols == jt.skeleton_cols
    assert tt.n_groups == jt.n_groups
    assert tt.skeleton.dtype == jt.skeleton.dtype and np.array_equal(tt.skeleton, jt.skeleton)
    assert sorted(tt.comp) == sorted(jt.comp)
    for v, r in jt.comp.items():
        assert np.array_equal(tt.comp[v].offsets, r.offsets)
        assert np.array_equal(tt.comp[v].values, r.values)


def _same_rows(jt, tt, ord_):
    jc, jr = jt.decompress(ord_)
    tc, tr = tt.decompress(ord_)
    assert jc == tc
    assert np.array_equal(np.unique(jr, axis=0) if jr.size else jr,
                          np.unique(tr, axis=0) if tr.size else tr)


def _plans(name, g, m):
    """The same pattern compiled by both packages (same cover, ord, tree)."""
    jp = jcompile(JContext(pattern=JLIB[name], stats=_jstats(g), m=m))
    tp = compile_plan(CompileContext(pattern=PATTERN_LIBRARY[name],
                                     stats=GraphStats.of(_port_graph(g)), m=m))
    assert jp.cover == tp.cover and jp.ord == tp.ord and jp.plan_key() == tp.plan_key()
    return jp, tp


def _jstats(g):
    from repro.core.estimator import GraphStats as JStats

    return JStats.of(g)


# ---------------------------------------------------------------------------
# Storage: the host Alg. 4 batch update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,seed", [(1, 3), (3, 7), (8, 11)])
def test_update_np_storage_equals_jax(m, seed):
    """Five updates in turn: every partition's CSR arrays and edge codes, and
    the UpdateCostReport, equal JAX's; the result equals a rebuild."""
    g = random_graph(24, 60, seed=seed)
    js = jstorage.build_np_storage(g, m)
    ts = tstorage.build_np_storage(_port_graph(g), m)
    _same_storage(js, ts)
    for ju, tu in _updates(g, 5, 3, 3, seed0=100 * seed):
        js, jrep = js.updated(ju)
        ts, trep = ts.updated(tu)
        assert isinstance(trep, tstorage.UpdateCostReport)
        assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
        _same_storage(js, ts)
        _same_storage(js, tstorage.build_np_storage(ts.graph, m))
        assert ts.space_report() == js.space_report()
        assert ts.total_stored_edges() == js.total_stored_edges()


def test_update_np_storage_rejects_bad_updates_as_jax_does():
    g = random_graph(16, 30, seed=5)
    js, ts = jstorage.build_np_storage(g, 2), tstorage.build_np_storage(_port_graph(g), 2)
    e = [int(x) for x in g.edges()[0]]
    absent = next((a, b) for a in range(g.n) for b in range(a + 1, g.n)
                  if not g.has_edges(np.array([a]), np.array([b]))[0])
    for upd in (dict(delete=[e], add=[e]), dict(delete=[absent]), dict(add=[e])):
        with pytest.raises(ValueError) as jerr:
            jstorage.update_np_storage(js, _jupdate(**upd))
        with pytest.raises(ValueError) as terr:
            tstorage.update_np_storage(ts, GraphUpdate.make(**upd))
        assert str(terr.value) == str(jerr.value)


def _jupdate(**kw):
    from repro.core.graph import GraphUpdate as JUpdate

    return JUpdate.make(**kw)


def test_partition_views_and_rebalanced_partition_fn():
    g = random_graph(20, 45, seed=9)
    override = {0: 2, 5: 0, 23: 1}
    jh = jstorage.PartitionFn(3).rebalanced(override)
    th = tstorage.PartitionFn(3).rebalanced(override)
    assert np.array_equal(jh.table, th.table)
    ids = np.arange(30)
    assert np.array_equal(jh(ids), th(ids))
    js = jstorage.build_np_storage(g, 3, jh)
    ts = tstorage.build_np_storage(_port_graph(g), 3, th)
    _same_storage(js, ts)
    for jp, tp in zip(js.parts, ts.parts):
        for u in range(-1, g.n + 1):
            assert np.array_equal(jp.neighbors(u), tp.neighbors(u))


# ---------------------------------------------------------------------------
# Listing, the Nav-join and incremental maintenance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["q2_triangle", "q1_square", "q5_house"])
def test_execute_join_tree_equals_jax(name):
    g = random_graph(22, 55, seed=13)
    jp, tp = _plans(name, g, 3)
    jrep, trep = JExecReport(), ExecutionReport()
    jt = jexecute(jstorage.build_np_storage(g, 3), jp.tree, jp.cover, jp.ord, jrep)
    tt = execute_join_tree(tstorage.build_np_storage(_port_graph(g), 3), tp.tree, tp.cover,
                           tp.ord, trep)
    _same_table(jt, tt)
    _same_rows(jt, tt, tp.ord)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert trep.total_join_cost() == jrep.total_join_cost()


@pytest.mark.parametrize("name", ["q1_square", "q5_house"])
def test_nav_join_patch_and_incremental_update_equal_jax(name):
    """Three batches: the Nav-join patch of each (with its NavReport), and
    the whole §VI pipeline (storage, merged table, IncrementalReport)."""
    g = random_graph(22, 55, seed=17)
    jp, tp = _plans(name, g, 3)
    js = jstorage.build_np_storage(g, 3)
    ts = tstorage.build_np_storage(_port_graph(g), 3)
    jm = jexecute(js, jp.tree, jp.cover, jp.ord)
    tm = execute_join_tree(ts, tp.tree, tp.cover, tp.ord)
    for ju, tu in _updates(g, 3, 3, 3, seed0=40):
        js2, _ = js.updated(ju)
        ts2, _ = ts.updated(tu)
        jrep, trep = JNavReport(), NavReport()
        jpatch = jnav(js2, jp.units, jp.pattern, jp.cover, jp.ord, ju.add, report=jrep)
        tpatch = nav_join_patch(ts2, tp.units, tp.pattern, tp.cover, tp.ord, tu.add, report=trep)
        _same_table(jpatch, tpatch)
        assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
        js, jm, jir = jincremental(js, jm, ju, jp.units, jp.pattern, jp.cover, jp.ord)
        ts, tm, tir = incremental_update(ts, tm, tu, tp.units, tp.pattern, tp.cover, tp.ord)
        _same_storage(js, ts)
        _same_table(jm, tm)
        _same_rows(jm, tm, tp.ord)
        _same_table(jir.patch, tir.patch)
        assert tir.removed_groups == jir.removed_groups
        assert dataclasses.asdict(tir.storage) == dataclasses.asdict(jir.storage)
        assert dataclasses.asdict(tir.nav) == dataclasses.asdict(jir.nav)


def test_unit_cache_equals_uncached_and_jax_stats():
    """Five batches through the unit-table cache (chain steps and seeds):
    the merged tables equal the uncached path's and JAX's cached path's, and
    the CacheStats (hits, misses, invalidations) equal JAX's."""
    g = random_graph(24, 60, seed=21)
    jp, tp = _plans("q1_square", g, 4)
    js = jstorage.build_np_storage(g, 4)
    ts = tstorage.build_np_storage(_port_graph(g), 4)
    jm = jexecute(js, jp.tree, jp.cover, jp.ord)
    tm = tm_plain = execute_join_tree(ts, tp.tree, tp.cover, tp.ord)
    jcache, tcache = JCache(js), PartitionUnitCache(ts)
    for ju, tu in _updates(g, 5, 3, 3, seed0=60):
        js, jcost = js.updated(ju)
        ts, tcost = ts.updated(tu)
        jcache.advance(js, jcost.dirty_parts)
        tcache.advance(ts, tcost.dirty_parts)
        jm, _ = japply(js, jm, ju, jp.units, jp.pattern, jp.cover, jp.ord,
                       seed_fn=jcache.seed_fn(jp.cover, jp.ord, ju.add_codes()),
                       provider=jcache)
        tm, _ = apply_update_to_matches(ts, tm, tu, tp.units, tp.pattern, tp.cover, tp.ord,
                                        seed_fn=tcache.seed_fn(tp.cover, tp.ord, tu.add_codes()),
                                        provider=tcache)
        tm_plain, _ = apply_update_to_matches(ts, tm_plain, tu, tp.units, tp.pattern, tp.cover,
                                              tp.ord)
        _same_table(jm, tm)
        _same_table(tm_plain, tm)
        assert isinstance(tcache.stats, CacheStats)
        assert dataclasses.asdict(tcache.stats) == dataclasses.asdict(jcache.stats)
        assert tcache.entries() == jcache.entries()
        assert tcache.resident_bytes == jcache.resident_bytes
    assert tcache.stats.hits > 0 and tcache.stats.misses > 0


def test_unit_cache_budget_evicts_as_jax():
    """Under an entry budget the LRU evicts the same entries: equal
    CacheStats (evictions included) and tables."""
    g = random_graph(24, 60, seed=23)
    jp, tp = _plans("q5_house", g, 3)
    js = jstorage.build_np_storage(g, 3)
    ts = tstorage.build_np_storage(_port_graph(g), 3)
    jcache = JCache(js, max_entries=4, max_bytes=4096)
    tcache = PartitionUnitCache(ts, max_entries=4, max_bytes=4096)
    for pi in (0, 1, 2, 0, 1):
        for ju, tu in zip(jp.units, tp.units):
            _same_table(jcache.unit_compressed(pi, ju, jp.cover, jp.ord),
                        tcache.unit_compressed(pi, tu, tp.cover, tp.ord))
    assert dataclasses.asdict(tcache.stats) == dataclasses.asdict(jcache.stats)
    assert tcache.stats.evictions > 0
    assert tcache.resident_bytes == jcache.resident_bytes


# ---------------------------------------------------------------------------
# The DDSL facade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,executor", [("q1_square", "tree"), ("q2_triangle", "tree"),
                                           ("q4_clique4", "tree"), ("q2_triangle", "wcoj")])
def test_ddsl_equals_jax_over_five_updates(name, executor):
    """initial() then apply() five times: the plan, every table, count and
    report counter equal JAX's DDSL."""
    g = random_graph(24, 70, seed=31)
    jd = JDDSL(g, JLIB[name], m=4, executor=executor)
    td = DDSL(_port_graph(g), PATTERN_LIBRARY[name], m=4, executor=executor)
    assert td.plan.plan_key() == jd.plan.plan_key() and td.cover == jd.cover
    _same_table(jd.initial(), td.initial())
    assert dataclasses.asdict(td.reports[0]) == dataclasses.asdict(jd.reports[0])
    for ju, tu in _updates(g, 5, 3, 3, seed0=70):
        jrep, trep = jd.apply(ju), td.apply(tu)
        _same_table(jd.state.matches, td.state.matches)
        _same_table(jrep.patch, trep.patch)
        assert td.count() == jd.count()
        assert trep.removed_groups == jrep.removed_groups
        assert dataclasses.asdict(trep.storage) == dataclasses.asdict(jrep.storage)
        assert dataclasses.asdict(trep.nav) == dataclasses.asdict(jrep.nav)
        _same_storage(jd.state.storage, td.state.storage)
        assert np.array_equal(np.unique(td.matches_plain(), axis=0),
                              np.unique(jd.matches_plain(), axis=0))
    assert td.stats == GraphStats.of(td.graph)


def test_choose_cover_reexport_is_the_planners():
    from repro.core.ddsl import choose_cover as jchoose

    from repro.core.pattern import symmetry_break as jbreak
    from repro_torch.core.pattern import symmetry_break

    g = random_graph(20, 45, seed=33)
    for name in ("q1_square", "q5_house"):
        p, jp = PATTERN_LIBRARY[name], JLIB[name]
        assert symmetry_break(p) == jbreak(jp)
        assert choose_cover(p, symmetry_break(p), GraphStats.of(_port_graph(g))) == jchoose(
            jp, jbreak(jp), _jstats(g))
