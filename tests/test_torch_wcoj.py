"""The port's WCOJ executor against the JAX package: the plan IR, the level
cap sizing and its calibration, the executor choice, the host generic join,
``wcoj_list``, the list / init-store steps, the delta seed mask and the
megastep's WCOJ slot beside a tree slot, byte for byte with the overflow
counters (m = 1 in process, m = 8 on 8 fake JAX devices in a subprocess);
then a WCOJ pipeline on the example graph against the host counts. Inputs:
the near-clique graph of ``tests/spmd/run_wcoj_step.py`` (48 vertices, 110
edges, a 9-core at p 0.95, seed 7), batches of 3 + 3 edges, the plain
versions of the kernels (the Pallas kernel in interpret mode on the JAX
side where stated)."""

import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from conftest import REPO, SRC
from test_sharded import _sample_batch
from test_torch_engine import assert_same

from repro.core import Graph, build_np_storage
from repro.core import match_engine as jme
from repro.core import plan as jplan
from repro.core.estimator import GraphStats
from repro.core.graph import GraphUpdate
from repro.core.pattern import PATTERN_LIBRARY, symmetry_break
from repro.core.storage import update_np_storage
from repro.data.graphs import rmat_graph
from repro.dist import jax_engine as jje
from repro.dist import sharded as jsh
from repro.planner import CompileContext, compile_plan
from repro.planner import sizing as jsz
from repro_torch import convert
from repro_torch import engine as tje
from repro_torch import sharded as tsh
from repro_torch.core import graph as tgraph
from repro_torch.core import match_engine as tme
from repro_torch.core import pattern as tpattern
from repro_torch.core import plan as tplan
from repro_torch.core import storage as tstorage
from repro_torch.core.estimator import GraphStats as TGraphStats
from repro_torch.data import graphs as tgraphs
from repro_torch.mesh import LocalMesh
from repro_torch.planner import sizing as tsz
from repro_torch.planner.compiler import choose_executor
from repro_torch.run import EXAMPLE_Q1, PLANTED_K5, WT_Q1, Pipeline, plan_pattern, stages

CAPS = dict(v_cap=64, deg_cap=32, e_cap=256, match_cap=2048, group_cap=2048, set_cap=32,
            pair_cap=64)
EXAMPLE_Q2_COUNTS = (188, 182, 172, 168)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def near_clique_graph(n=48, m=110, k=9, p=0.95, seed=7):
    """``tests/spmd/run_wcoj_step.py``'s graph: a uniform background and a
    dense core holding the cliques."""
    r = np.random.default_rng(seed)
    edges = set()
    while len(edges) < m:
        a, b = int(r.integers(n)), int(r.integers(n))
        if a != b:
            edges.add((min(a, b), max(a, b)))
    core = r.choice(n, size=k, replace=False)
    for i in range(k):
        for j in range(i + 1, k):
            if r.random() < p:
                a, b = int(core[i]), int(core[j])
                edges.add((min(a, b), max(a, b)))
    return Graph.from_edges(np.array(sorted(edges), np.int64), n=n)


def _port_graph(g):
    return tgraph.Graph.from_edges(g.edges(), n=g.n)


def _caps(**kw):
    c = {**CAPS, **kw}
    return jje.EngineCaps(**c, use_pallas=False), tje.EngineCaps(**c, use_kernels=False)


def _plan_fields(plan):
    return (plan.pattern.key(), plan.anchor, plan.order,
            tuple(dataclasses.astuple(lv) for lv in plan.levels), plan.edge_cols,
            plan.anchor_min_degree, plan.cols)


def _jax_wcoj(g, pname, m, jc):
    """JAX's WCOJ plan and store caps, as compile_plan(executor="wcoj")
    makes them (its executor pass, without the join-tree search, which
    the executor choice test holds to compile_plan), and the service's
    calibration of its caps."""
    pat = PATTERN_LIBRARY[pname]
    ord_ = symmetry_break(pat)
    wp = jplan.build_wcoj_plan(pat, None, ord_)
    compiled = jsz.wcoj_level_caps(pat, wp.order, ord_, GraphStats.of(g), m)
    plan = SimpleNamespace(
        pattern=pat, ord=ord_, wcoj=wp, wcoj_level_caps=compiled,
        storage_cover=tuple(sorted(pat.vertices)),
        store_caps=jsz.StoreCaps(group_cap=max(jc.group_cap, compiled[-1]), set_cap=8))
    observed = [jme.wcoj_level_counts(part, plan.wcoj, anchor_to_centers=True)
                for part in build_np_storage(g, m).parts]
    peaks = [max(o[i] for o in observed) for i in range(len(plan.wcoj_level_caps))]
    pow2 = lambda x: tsz._pow2_at_least(x, 64)  # noqa: E731
    lvl = tuple(pow2(int(1.5 * p)) for p in peaks)
    scaps = jsz.quantize_store_caps(dataclasses.replace(
        plan.store_caps, group_cap=max(plan.store_caps.group_cap, pow2(int(4.0 * peaks[-1])))))
    return plan, lvl, scaps


# ---------------------------------------------------------------------------
# (a)–(c) plans, caps and the executor choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pname", sorted(PATTERN_LIBRARY))
def test_wcoj_plan_equals_jax(pname):
    jp = PATTERN_LIBRARY[pname]
    tp = tpattern.PATTERN_LIBRARY[pname]
    assert tplan.wcoj_eligible(tp) == jplan.wcoj_eligible(jp)
    assert tplan.wcoj_anchors(tp) == jplan.wcoj_anchors(jp)
    if not jplan.wcoj_eligible(jp):
        with pytest.raises(ValueError, match="not WCOJ-eligible"):
            tplan.build_wcoj_plan(tp)
        return
    for anchor in (None, *jplan.wcoj_anchors(jp)):
        for ord_ in ((), symmetry_break(jp)):
            assert (_plan_fields(tplan.build_wcoj_plan(tp, anchor, ord_))
                    == _plan_fields(jplan.build_wcoj_plan(jp, anchor, ord_))), (anchor, ord_)


def _graphs(name):
    if name == "wt":
        return rmat_graph(12, 10_000, seed=1), tgraphs.rmat_graph(12, 10_000, seed=1)
    from benchmarks.bench_wcoj import planted_graph

    return planted_graph(), tgraphs.planted_graph()


@pytest.mark.parametrize("gname,m", [("wt", 1), ("wt", 8), ("planted", 1), ("planted", 8)])
def test_wcoj_prefix_estimates_and_level_caps_equal_jax(gname, m):
    jg, tg = _graphs(gname)
    assert np.array_equal(jg.codes, tg.codes)
    js, ts = GraphStats.of(jg), TGraphStats.of(tg)
    for pname in sorted(PATTERN_LIBRARY):
        jp, tp = PATTERN_LIBRARY[pname], tpattern.PATTERN_LIBRARY[pname]
        if not jplan.wcoj_eligible(jp):
            continue
        order = jplan.build_wcoj_plan(jp, None, symmetry_break(jp)).order
        ord_ = symmetry_break(jp)
        assert (tsz.wcoj_prefix_estimates(tp, order, ord_, ts)
                == jsz.wcoj_prefix_estimates(jp, order, ord_, js)), pname
        for headroom in (1.5, 4.0):
            assert (tsz.wcoj_level_caps(tp, order, ord_, ts, m, headroom)
                    == jsz.wcoj_level_caps(jp, order, ord_, js, m, headroom)), pname


def test_calibration_equals_the_service_protocol():
    """calibrate_wcoj_caps against the JAX service's protocol (observed
    level peaks × 1.5 and the last × 4.0 on the pow2 ladder) at m = 1 and 8,
    with the host level counts of both packages equal partition by
    partition."""
    g = near_clique_graph()
    tg = _port_graph(g)
    jc, _ = _caps()
    for m in (1, 8):
        jstore, tstore = build_np_storage(g, m), tstorage.build_np_storage(tg, m)
        for pname in ("q2_triangle", "q3_diamond", "q4_clique4", "q6_clique5"):
            plan, lvl, scaps = _jax_wcoj(g, pname, m, jc)
            tp = tplan.build_wcoj_plan(tpattern.PATTERN_LIBRARY[pname], None, plan.ord)
            for jpart, tpart in zip(jstore.parts, tstore.parts):
                assert (tme.wcoj_level_counts(tpart, tp, anchor_to_centers=True)
                        == jme.wcoj_level_counts(jpart, plan.wcoj, anchor_to_centers=True))
            lvl_t, floor = tsz.calibrate_wcoj_caps(tstore, tp)
            assert lvl_t == lvl, (m, pname)
            assert tsz.quantize_store_caps(dataclasses.replace(
                tsz.StoreCaps(plan.store_caps.group_cap, plan.store_caps.set_cap),
                group_cap=max(plan.store_caps.group_cap, floor))).group_cap == scaps.group_cap


# the executors compile_plan(executor="auto") picks, by graph
AUTO = {"wt": {"q1_square": "tree", "q2_triangle": "wcoj", "q3_diamond": "wcoj",
               "q4_clique4": "wcoj", "q5_house": "tree", "q6_clique5": "wcoj"},
        "planted": {p: "tree" for p in PATTERN_LIBRARY}}


@pytest.mark.parametrize("gname", ["wt", "planted"])
def test_executor_choice_equals_compile_plan(gname):
    """The port's plan_pattern under executor="auto" picks compile_plan's
    executor for every library pattern, with its cost, compile-time level
    caps and store caps (WT_Q1's caps at m = 8 on WT~, PLANTED_K5's at m = 1
    on the planted graph), and the port's join tree (whose search checks a
    union's edge count first) lowers to JAX's program."""
    jg, tg = _graphs(gname)
    cfg = WT_Q1 if gname == "wt" else PLANTED_K5
    c = {k: getattr(cfg, k) for k in CAPS}
    jc, tc = jje.EngineCaps(**c), tje.EngineCaps(**c, use_kernels=False)
    js, ts = GraphStats.of(jg), TGraphStats.of(tg)
    tstore = tstorage.build_np_storage(tg, cfg.m)
    mesh = LocalMesh(cfg.m)
    for pname in sorted(PATTERN_LIBRARY):
        want = compile_plan(CompileContext(pattern=PATTERN_LIBRARY[pname], stats=js, m=cfg.m,
                                           caps=jc, executor="auto"))
        assert want.executor == AUTO[gname][pname], pname
        got = plan_pattern(pname, ts, tstore, tc, mesh, "auto")
        assert got.executor == want.executor, pname
        assert got.cover == want.cover and got.ord == want.ord, pname
        assert repr(got.prog) == repr(want.program), pname
        assert got.cost == want.cost, pname
        if want.executor == "tree":
            assert got.wcoj is None and got.level_caps is None
            assert dataclasses.asdict(got.store_caps) == dataclasses.asdict(want.store_caps)
            continue
        assert _plan_fields(got.wcoj) == _plan_fields(want.wcoj), pname
        # the compile-time caps, before the calibration replaces them
        choice = choose_executor(got.pattern, got.ord, ts, want.tree.cost, "auto", cfg.m, tc,
                                 got.store_caps)
        assert choice.cost == want.cost and choice.level_caps == want.wcoj_level_caps, pname
        assert (dataclasses.asdict(choice.store_caps)
                == dataclasses.asdict(want.store_caps)), pname
    with pytest.raises(ValueError, match="not WCOJ-eligible"):
        plan_pattern("q1_square", ts, tstore, tc, mesh, "wcoj")


# ---------------------------------------------------------------------------
# (d) the host generic join
# ---------------------------------------------------------------------------

def test_host_match_engine_equals_jax():
    """The copied host engine lists the same tables as JAX's, row for row:
    execute_wcoj (with seed_vertices and require_edge_codes, over the graph
    and over centre-anchored partitions), wcoj_level_counts,
    list_matches_wcoj, and the unit-plan half beside them."""
    g = near_clique_graph()
    tg = _port_graph(g)
    jstore, tstore = build_np_storage(g, 4), tstorage.build_np_storage(tg, 4)
    rng = np.random.default_rng(11)
    seeds = np.sort(rng.choice(g.n, size=20, replace=False))
    req = np.sort(g.codes[rng.choice(g.codes.shape[0], size=12, replace=False)])
    same = np.testing.assert_array_equal
    for pname in ("q2_triangle", "q3_diamond", "q4_clique4", "q6_clique5", "q1_square"):
        jp, tp = PATTERN_LIBRARY[pname], tpattern.PATTERN_LIBRARY[pname]
        ord_ = symmetry_break(jp)
        for fn in ("list_matches", "list_matches_wcoj"):
            if fn == "list_matches_wcoj" and not jplan.wcoj_eligible(jp):
                continue
            jc, jt = getattr(jme, fn)(g, jp, ord_)
            tc, tt = getattr(tme, fn)(tg, tp, ord_)
            assert jc == tc
            same(jt, tt)
            jc, jt = getattr(jme, fn)(g, jp, ord_, require_edge_codes=req)
            same(jt, getattr(tme, fn)(tg, tp, ord_, require_edge_codes=req)[1])
        if not jplan.wcoj_eligible(jp):
            continue
        jw = jplan.build_wcoj_plan(jp, None, ord_)
        tw = tplan.build_wcoj_plan(tp, None, ord_)
        kw = dict(seed_vertices=seeds, require_edge_codes=req)
        same(jme.execute_wcoj(g, jw, **kw), tme.execute_wcoj(tg, tw, **kw))
        same(jme.execute_wcoj(g, jw, degree_prune=False, row_chunk=7),
             tme.execute_wcoj(tg, tw, degree_prune=False, row_chunk=7))
        assert jme.wcoj_level_counts(g, jw) == tme.wcoj_level_counts(tg, tw)
        for jpart, tpart in zip(jstore.parts, tstore.parts):
            for kw in ({}, dict(seed_vertices=seeds), dict(require_edge_codes=req)):
                same(jme.execute_wcoj(jpart, jw, anchor_to_centers=True, **kw),
                     tme.execute_wcoj(tpart, tw, anchor_to_centers=True, **kw))
        table = jme.execute_wcoj(g, jw)
        same(jme.require_edge_rows_mask(table, jw.edge_cols, req),
             tme.require_edge_rows_mask(table, tw.edge_cols, req))
    starts, counts = np.array([0, 3, 5]), np.array([2, 0, 4])
    vals = np.arange(10) * 7
    for a, b in zip(jme.ragged_expand(starts, counts, vals),
                    tme.ragged_expand(starts, counts, vals)):
        same(a, b)


# ---------------------------------------------------------------------------
# (e) wcoj_list at m = 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "require_edges", "seed_mask", "overflow", "pallas"])
def test_wcoj_list_byte_equal_to_jax(case):
    """jax_engine.wcoj_list and the port's on the same padded partition:
    table, valid and overflow equal; with too-small level caps the dropped
    rows count the same at every level; ``pallas`` runs the JAX side
    through the Pallas member_probe kernel in interpret mode."""
    g = near_clique_graph()
    jc, tc = _caps()
    if case == "pallas":
        jc = dataclasses.replace(jc, use_pallas=True)
    part = build_np_storage(g, 1).parts[0]
    jpt = jje.pad_partition(part, jc)
    tpt = convert.partitions_from_numpy(jpt, device="cpu")
    rng = np.random.default_rng(13)
    for pname in ("q4_clique4", "q6_clique5"):
        # one edge of a listed match and two other edges of the graph
        listed = jme.list_matches_wcoj(g, PATTERN_LIBRARY[pname])[1]
        add = np.concatenate([listed[:1, :2], g.edges()[rng.choice(g.codes.shape[0], 2)]])
        plan, lvl, _ = _jax_wcoj(g, pname, 1, jc)
        tp = tplan.build_wcoj_plan(tpattern.PATTERN_LIBRARY[pname], None, plan.ord)
        kw_j, kw_t = {}, {}
        if case == "require_edges":
            kw_j["require_edges"] = jnp.asarray(add, jnp.int32)
            kw_t["require_edges"] = torch.from_numpy(add.astype(np.int32))
        if case == "seed_mask":
            mask = rng.random(CAPS["v_cap"]) < 0.5
            kw_j["seed_mask"] = jnp.asarray(mask)
            kw_t["seed_mask"] = torch.from_numpy(mask)
        if case == "overflow":
            lvl = (16,) * len(lvl)
        want = jje.wcoj_list(jpt, plan.wcoj, jc, lvl, **kw_j)
        got = tje.wcoj_list(tpt, tp, tc, lvl, **kw_t)
        assert_same(want, got, f"{case} {pname}")
        if case == "overflow":
            assert int(got[2]) > 0
        else:
            assert int(got[2]) == 0 and int(got[1].sum()) > 0
    with pytest.raises(ValueError, match="level caps"):
        tje.wcoj_list(tpt, tp, tc, lvl[:-1])


# ---------------------------------------------------------------------------
# (f) the steps at m = 1
# ---------------------------------------------------------------------------

def _m1(g, jc):
    mesh = jax.make_mesh((1,), ("data",))
    jpt = jsh.stack_partitions(build_np_storage(g, 1), jc)
    return mesh, jpt, LocalMesh(1), convert.partitions_from_numpy(jpt, device="cpu")


def _host_rows(graph, pname, ord_):
    _, tbl = jme.list_matches_wcoj(graph, PATTERN_LIBRARY[pname], ord_)
    return set(map(tuple, tbl.tolist()))


def _store_rows(store, plan):
    cover_all = plan.storage_cover
    back = jje.comp_to_host(convert.comp_to_numpy(store.flatten()), plan.pattern, cover_all,
                            cover_all)
    return set(map(tuple, back.decompress(plan.ord)[1].tolist()))


@pytest.mark.parametrize("pname", ["q4_clique4", "q6_clique5"])
def test_wcoj_list_and_init_store_steps_byte_equal_to_jax(pname):
    g = near_clique_graph()
    jc, tc = _caps()
    mesh, jpt, tmesh, tpt = _m1(g, jc)
    plan, lvl, scaps = _jax_wcoj(g, pname, 1, jc)
    pp = plan_pattern(pname, TGraphStats.of(_port_graph(g)),
                      tstorage.build_np_storage(_port_graph(g), 1), tc, tmesh, "wcoj")
    assert pp.level_caps == lvl
    assert dataclasses.asdict(pp.store_caps) == dataclasses.asdict(scaps)
    jout, jd = jsh.make_wcoj_list_step(plan.pattern, plan.wcoj, mesh, jc, lvl)(jpt)
    tout, td = pp.list_step(tpt)
    assert_same((jout, jd), (tout, td), "list")
    jst, jd = jsh.make_wcoj_init_store_step(plan.pattern, plan.ord, mesh, jc, scaps, lvl)(jout)
    tst, td = pp.init_step(tout)
    assert_same((jst, jd), (tst, td), "init store")
    assert int(td["overflow"]) == 0
    assert int(td["count"]) == len(_host_rows(g, pname, plan.ord)) > 0
    assert _store_rows(tst, plan) == _host_rows(g, pname, plan.ord)
    # level caps too small for the listing: the same drops
    small = (16,) * len(lvl)
    want = jsh.make_wcoj_list_step(plan.pattern, plan.wcoj, mesh, jc, small)(jpt)
    got = tsh.make_wcoj_list_step(pp.pattern, pp.wcoj, tmesh, tc, small)(tpt)
    assert_same(want, got, "small level caps")
    assert int(got[1]["overflow"]) > 0


def _jax_seed_mask(mesh, jpt, add):
    """JAX's ``_wcoj_seed_mask`` under shard_map, one mask per device."""
    axes = tuple(mesh.axis_names)

    def body(pt_st, a):
        pt = jax.tree.map(lambda x: x[0], pt_st)
        return jsh._wcoj_seed_mask(pt, a, axes)[None]

    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(jsh.partition_specs(mesh), P()),
                                 out_specs=P("data"), check_vma=False))(jpt, add)


def test_wcoj_seed_mask_byte_equal_to_jax():
    g = near_clique_graph()
    jc, tc = _caps()
    mesh, jpt, tmesh, tpt = _m1(g, jc)
    rng = np.random.default_rng(19)
    for b in range(3):
        add, _ = _sample_batch(g, rng, 3, g.n)
        want = _jax_seed_mask(mesh, jpt, jnp.asarray(add, jnp.int32))
        pts = [tsh._part(tpt, j) for j in tmesh.indices()]
        got = tsh._wcoj_seed_masks(pts, torch.from_numpy(add.astype(np.int32)), tmesh)
        assert_same(want, torch.stack(got), f"batch {b}")
        assert 0 < int(got[0].sum()) < CAPS["v_cap"]


def _specs(g, jc, tc, tmesh):
    """q4_clique4 (WCOJ) and q1_square (tree) slots on each side, with each
    side's stage 1 and the tree slot's carry."""
    tg = _port_graph(g)
    tstats, tstore = TGraphStats.of(tg), tstorage.build_np_storage(tg, tmesh.size)
    out = []
    for pname, ex in (("q4_clique4", "wcoj"), ("q1_square", "tree")):
        pp = plan_pattern(pname, tstats, tstore, tc, tmesh, ex)
        plan = compile_plan(CompileContext(pattern=PATTERN_LIBRARY[pname],
                                           stats=GraphStats.of(g), m=tmesh.size, caps=jc,
                                           executor=ex))
        store = jsh.StoreCaps(**dataclasses.asdict(pp.store_caps))
        jspec = jsh.MaintainSpec(name=pname, prog=plan.program, units=tuple(plan.units),
                                 store=store, unit_caps=plan.unit_caps, wcoj=plan.wcoj,
                                 wcoj_level_caps=pp.level_caps)
        out.append((pname, plan, pp, jspec))
    return out


def test_megastep_with_wcoj_and_tree_slots_byte_equal_to_jax():
    """One megastep holding a WCOJ slot (q4_clique4) and a tree slot
    (q1_square) equals JAX's over three batches at m = 1: stores, patches,
    carries and every diag key; the WCOJ slot's carry stays ``{}``, its
    ``unit_refreshes`` 0, and its store equals the host generic join."""
    g = near_clique_graph()
    jc, tc = _caps()
    mesh, jpt, tmesh, tpt = _m1(g, jc)
    slots = _specs(g, jc, tc, tmesh)
    jst, tst, jcar, tcar = {}, {}, {}, {}
    for pname, plan, pp, jspec in slots:
        if pp.wcoj is not None:
            out, _ = jsh.make_wcoj_list_step(plan.pattern, plan.wcoj, mesh, jc,
                                             pp.level_caps)(jpt)
            jst[pname], _ = jsh.make_wcoj_init_store_step(plan.pattern, plan.ord, mesh, jc,
                                                          jspec.store, pp.level_caps)(out)
            jcar[pname] = tcar[pname] = {}
        else:
            out, _ = jsh.make_list_step(plan.program, mesh, jc)(jpt)
            jst[pname], _ = jsh.make_init_store_step(plan.program, mesh, jc, jspec.store)(out)
            jcar[pname], _ = jsh.make_unit_refresh_step(plan.program, plan.units, mesh, jc,
                                                        plan.unit_caps)(jpt)
            tcar[pname], _ = pp.refresh_step(tpt)
        tst[pname], d = pp.init_step(pp.list_step(tpt)[0])
        assert int(d["overflow"]) == 0
    assert_same((jst, jcar), (tst, tcar), "stage 1")
    jmega = jsh.make_maintain_mega_step([s[3] for s in slots], mesh, jc)
    tmega = tsh.make_maintain_mega_step([s[2].spec() for s in slots], tmesh, tc)
    ush = dict(n_add=3, n_del=3)
    jstep = jsh.make_storage_update_step(mesh, jc, jsh.UpdateShapes(**ush))
    tstep = tsh.make_storage_update_step(tmesh, tc, tsh.UpdateShapes(**ush))
    rng = np.random.default_rng(23)
    cur = build_np_storage(g, 1)
    for b in range(3):
        add, dele = _sample_batch(cur.graph, rng, 3, g.n)
        cur, _ = update_np_storage(cur, GraphUpdate(delete=dele, add=add))
        ja, jd_ = jnp.asarray(add, jnp.int32), jnp.asarray(dele, jnp.int32)
        ta, td_ = torch.from_numpy(add.astype(np.int32)), torch.from_numpy(dele.astype(np.int32))
        jpt, jsd = jstep(jpt, ja, jd_)
        tpt, tsd = tstep(tpt, ta, td_)
        want = jmega(jpt, jst, jcar, jsd["part_dirty"], ja, jd_)
        got = tmega(tpt, tst, tcar, tsd["part_dirty"], ta, td_)
        assert_same(want, got, f"batch {b}")
        jst, jcar = want[0], want[2]
        d = got[3]["q4_clique4"]
        assert got[2]["q4_clique4"] == {} and int(d["unit_refreshes"]) == 0
        assert int(d["overflow"]) == int(got[3]["q1_square"]["overflow"]) == 0
        plan = slots[0][1]
        assert int(d["count"]) == len(_host_rows(cur.graph, "q4_clique4", plan.ord)), b
        assert _store_rows(tst["q4_clique4"], plan) == _host_rows(cur.graph, "q4_clique4",
                                                                  plan.ord)
    # a WCOJ-only megastep never reads part_dirty on the host
    wonly = tsh.make_maintain_mega_step([slots[0][2].spec()], tmesh, tc)
    add, dele = _sample_batch(cur.graph, rng, 3, g.n)
    ta, td_ = torch.from_numpy(add.astype(np.int32)), torch.from_numpy(dele.astype(np.int32))
    tpt, tsd = tstep(tpt, ta, td_)

    class Unread(torch.Tensor):
        def tolist(self):
            raise AssertionError("part_dirty read on the host")

    _, _, car, d = wonly(tpt, {"q4_clique4": tst["q4_clique4"]}, {"q4_clique4": {}},
                         tsd["part_dirty"].as_subclass(Unread), ta, td_)
    assert car == {"q4_clique4": {}} and int(d["q4_clique4"]["overflow"]) == 0


# ---------------------------------------------------------------------------
# (g) m = 8 against the JAX steps on 8 fake devices
# ---------------------------------------------------------------------------

_M8_SCRIPT = r'''
import dataclasses
import numpy as np
import jax, jax.numpy as jnp, torch
from jax.sharding import NamedSharding
from repro.core import Graph, GraphUpdate, build_np_storage
from repro.core.estimator import GraphStats
from repro.core.match_engine import list_matches_wcoj
from repro.core.pattern import PATTERN_LIBRARY
from repro.core.storage import update_np_storage
from repro.dist import jax_engine as jje, sharded as jsh
from repro.planner import CompileContext, compile_plan
from repro_torch import convert, engine as tje, sharded as tsh
from repro_torch.core import graph as tgraph, storage as tstorage
from repro_torch.core.estimator import GraphStats as TGraphStats
from repro_torch.mesh import LocalMesh
from repro_torch.run import plan_pattern
from test_sharded import _sample_batch
from test_torch_wcoj import CAPS, near_clique_graph

def leaves(x):
    if dataclasses.is_dataclass(x):
        return [l for f in dataclasses.fields(x) for l in leaves(getattr(x, f.name))]
    if isinstance(x, dict):
        return [l for k in sorted(x, key=str) for l in leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [l for v in x for l in leaves(v)]
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x).astype(np.int64)]

def same(a, b, what):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and (x == y).all(), f"{what}: leaf {i} differs"

def rows(store, plan):
    cover = plan.storage_cover
    back = jje.comp_to_host(convert.comp_to_numpy(store.flatten()), plan.pattern, cover, cover)
    return set(map(tuple, back.decompress(plan.ord)[1].tolist()))

def host(graph, pname, plan):
    return set(map(tuple, list_matches_wcoj(graph, PATTERN_LIBRARY[pname], plan.ord)[1].tolist()))

M = 8
g = near_clique_graph()
tg = tgraph.Graph.from_edges(g.edges(), n=g.n)
mesh = jax.make_mesh((M,), ("data",))
jc, tc = jje.EngineCaps(**CAPS, use_pallas=False), tje.EngineCaps(**CAPS, use_kernels=False)
jpt = jsh.stack_partitions(build_np_storage(g, M), jc)
jpt = jax.device_put(jpt, jax.tree.map(lambda s: NamedSharding(mesh, s),
                                       jsh.partition_specs(mesh)))
tmesh = LocalMesh(M)
tpt = convert.partitions_from_numpy(jpt, device="cpu")
tstats, tstore = TGraphStats.of(tg), tstorage.build_np_storage(tg, M)
jspecs, tspecs, jst, tst, jcar, tcar, plans = [], [], {}, {}, {}, {}, {}
for pname, ex in (("q6_clique5", "wcoj"), ("q4_clique4", "wcoj"), ("q1_square", "tree")):
    pp = plan_pattern(pname, tstats, tstore, tc, tmesh, ex)
    plan = plans[pname] = compile_plan(CompileContext(
        pattern=PATTERN_LIBRARY[pname], stats=GraphStats.of(g), m=M, caps=jc, executor=ex))
    store = jsh.StoreCaps(**dataclasses.asdict(pp.store_caps))
    tout, ld = pp.list_step(tpt)
    tst[pname], idiag = pp.init_step(tout)
    assert int(ld["overflow"]) == int(idiag["overflow"]) == 0, pname
    if ex == "wcoj":
        jout, jd = jsh.make_wcoj_list_step(plan.pattern, plan.wcoj, mesh, jc, pp.level_caps)(jpt)
        same((jout, jd), (tout, ld), f"{pname} list step")
        jst[pname], jd = jsh.make_wcoj_init_store_step(plan.pattern, plan.ord, mesh, jc, store,
                                                       pp.level_caps)(jout)
        jcar[pname] = tcar[pname] = {}
        assert rows(tst[pname], plan) == host(g, pname, plan), pname
    else:
        jout, _ = jsh.make_list_step(plan.program, mesh, jc)(jpt)
        jst[pname], jd = jsh.make_init_store_step(plan.program, mesh, jc, store)(jout)
        jcar[pname], _ = jsh.make_unit_refresh_step(plan.program, plan.units, mesh, jc,
                                                    plan.unit_caps)(jpt)
        tcar[pname], _ = pp.refresh_step(tpt)
    same((jst[pname], jd), (tst[pname], idiag), f"{pname} init store")
    jspecs.append(jsh.MaintainSpec(name=pname, prog=plan.program, units=tuple(plan.units),
                                   store=store, unit_caps=plan.unit_caps, wcoj=plan.wcoj,
                                   wcoj_level_caps=pp.level_caps))
    tspecs.append(pp.spec())
same((jcar, jst), (tcar, tst), "stage 1")
ush = dict(n_add=3, n_del=3)
jstep = jsh.make_storage_update_step(mesh, jc, jsh.UpdateShapes(**ush))
tstep = tsh.make_storage_update_step(tmesh, tc, tsh.UpdateShapes(**ush))
jmega = jsh.make_maintain_mega_step(jspecs, mesh, jc)
tmega = tsh.make_maintain_mega_step(tspecs, tmesh, tc)
rng = np.random.default_rng(17)
cur = build_np_storage(g, M)
for b in range(3):
    add, dele = _sample_batch(cur.graph, rng, 3, g.n)
    cur, _ = update_np_storage(cur, GraphUpdate(delete=dele, add=add))
    ja, jd_ = jnp.asarray(add, jnp.int32), jnp.asarray(dele, jnp.int32)
    ta, td_ = torch.from_numpy(add.astype(np.int32)), torch.from_numpy(dele.astype(np.int32))
    jpt, jsd = jstep(jpt, ja, jd_)
    tpt, tsd = tstep(tpt, ta, td_)
    want = jmega(jpt, jst, jcar, jsd["part_dirty"], ja, jd_)
    got = tmega(tpt, tst, tcar, tsd["part_dirty"], ta, td_)
    same(want, got, f"batch {b} megastep")
    jst, jcar = want[0], want[2]
    for pname in ("q6_clique5", "q4_clique4"):
        d = got[3][pname]
        assert int(d["overflow"]) == int(d["unit_refreshes"]) == 0, (b, pname)
        want_rows = host(cur.graph, pname, plans[pname])
        assert int(d["count"]) == len(want_rows) and rows(tst[pname], plans[pname]) == want_rows
    assert int(got[3]["q1_square"]["overflow"]) == 0
for pname in ("q6_clique5", "q4_clique4"):
    print(f"{pname}: m=8 port == JAX steps over 3 batches, count {int(got[3][pname]['count'])}")
'''


@pytest.mark.slow
def test_m8_wcoj_steps_byte_equal_to_jax_on_8_devices():
    """K5 and K4 (WCOJ) beside q1_square (tree) in one megastep at m = 8:
    the list, init-store and megastep outputs byte-equal to the JAX steps
    on 8 fake devices over three batches, the match sets to the host
    generic join."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.pathsep.join([SRC, os.path.join(REPO, "tests")])
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", _M8_SCRIPT], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    assert out.stdout.count("m=8 port == JAX steps") == 2


# ---------------------------------------------------------------------------
# (h) a WCOJ pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change,match", [
    (dict(n_edges=10_000), "planted graph has 4096 vertices and 12000"),
    (dict(n_log2=13), "planted graph has 4096 vertices and 12000"),
    (dict(graph="er"), "unknown graph"),
    (dict(executor="nav"), "unknown executor"),
])
def test_run_config_rejects_fields_the_graph_does_not_read(change, match):
    """The planted graph's size is fixed: a config on it must state that
    size, and unknown graphs and executors are refused when the config is
    made."""
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(PLANTED_K5, **change)
    assert dataclasses.replace(PLANTED_K5, graph_seed=3).graph_seed == 3


def test_wcoj_pipeline_on_the_example_graph_gives_the_host_counts():
    pipe = Pipeline(dataclasses.replace(EXAMPLE_Q1, pattern="q2_triangle", executor="wcoj"),
                    "cpu", use_kernels=False)
    plan = pipe.describe()["patterns"]["q2_triangle"]
    assert plan["executor"] == "wcoj" and plan["unit_plans"] == 0 and plan["carry_gib"] == 0
    recs = list(stages(pipe, 3))
    assert tuple(r["count"] for r in recs) == EXAMPLE_Q2_COUNTS
    assert all(r["overflow"] == 0 for r in recs)
    assert all(r["unit_refreshes"] == 0 for r in recs[1:])
    assert pipe.carries == {"q2_triangle": {}}
