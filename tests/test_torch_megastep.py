"""The port's unit-table carry, carried steps and multi-pattern megastep
against the JAX steps (m = 1, byte for byte, overflow counters included),
against the port's own uncached steps, and at m = 8 against the host
``DDSL``. Small random graphs as in ``tests/test_sharded.py`` (30 vertices,
70 edges, batches of 3 + 3 edges); every run on the CPU with the plain
versions of the kernels."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import random_graph
from test_sharded import _sample_batch
from test_torch_engine import assert_same

from repro.core import DDSL, build_np_storage, symmetry_break
from repro.core.cost import CostModel
from repro.core.ddsl import choose_cover
from repro.core.estimator import GraphStats
from repro.core.graph import GraphUpdate
from repro.core.join_tree import minimum_unit_decomposition, optimal_join_tree
from repro.core.pattern import PATTERN_LIBRARY
from repro.core.storage import update_np_storage
from repro.dist import jax_engine as jje
from repro.dist import sharded as jsh
from repro.planner import sizing as jsizing
from repro_torch import convert
from repro_torch import engine as tje
from repro_torch import sharded as tsh
from repro_torch.mesh import LocalMesh
from repro_torch.planner import sizing as tsz
from repro_torch.run import Pipeline, RunConfig, stages

CAPS = dict(v_cap=64, deg_cap=32, e_cap=512, match_cap=2048, group_cap=2048,
            set_cap=32, pair_cap=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _caps(**kw):
    c = {**CAPS, **kw}
    return jje.EngineCaps(**c, use_pallas=False), tje.EngineCaps(**c, use_kernels=False)


def _pattern(g, pname, jc):
    pat = PATTERN_LIBRARY[pname]
    ord_ = symmetry_break(pat)
    stats = GraphStats.of(g)
    cover = choose_cover(pat, ord_, stats)
    tree = optimal_join_tree(pat, cover, CostModel(cover, ord_, stats))
    prog = jsh.build_tree_program(tree, cover, ord_)
    units = tuple(minimum_unit_decomposition(pat, cover))
    return SimpleNamespace(
        name=pname, pat=pat, ord=ord_, cover=cover, prog=prog, units=units, stats=stats,
        store=jsh.match_caps(pat, cover, ord_, stats, jc),
        ucaps=jsh.unit_table_caps(units, cover, ord_, stats, jc))


def _m1(g, jc):
    """The JAX one-device mesh and stacked partitions, and the port's."""
    mesh = jax.make_mesh((1,), ("data",))
    jpt = jsh.stack_partitions(build_np_storage(g, 1), jc)
    return mesh, jpt, LocalMesh(1), convert.partitions_from_numpy(jpt, device="cpu")


def _batch(cur, rng, n=30):
    add, dele = _sample_batch(cur.graph, rng, 3, n)
    cur, _ = update_np_storage(cur, GraphUpdate(delete=dele, add=add))
    add, dele = add.astype(np.int32), dele.astype(np.int32)
    return cur, (jnp.asarray(add), jnp.asarray(dele)), (torch.from_numpy(add),
                                                       torch.from_numpy(dele))


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return tje.map_tensors(torch.clone, x)


@pytest.mark.parametrize("pname", ["q1_square", "q2_triangle", "q5_house"])
def test_unit_refresh_step_byte_equal_to_jax(pname):
    g = random_graph(30, 70, seed=47)
    jc, tc = _caps()
    p = _pattern(g, pname, jc)
    asdict = dataclasses.asdict
    assert asdict(tsz.unit_table_caps(p.units, p.cover, p.ord, p.stats, tc)) == asdict(p.ucaps)
    assert asdict(tsz.quantize_store_caps(p.store)) == asdict(jsizing.quantize_store_caps(p.store))
    jplans, jnames = jsh.unit_plan_registry(p.prog, p.units)
    tplans, tnames = tsh.unit_plan_registry(p.prog, p.units)
    assert jnames == tnames and list(jplans) == list(tplans)
    mesh, jpt, tmesh, tpt = _m1(g, jc)
    jcarry, jd = jsh.make_unit_refresh_step(p.prog, p.units, mesh, jc, p.ucaps)(jpt)
    tcarry, td = tsh.make_unit_refresh_step(p.prog, p.units, tmesh, tc, p.ucaps)(tpt)
    assert_same((jcarry, jd), (tcarry, td))
    assert int(td["overflow"]) == 0
    # undersized carry caps count their drops the same way
    small = jsh.StoreCaps(group_cap=4, set_cap=2)
    _, jd = jsh.make_unit_refresh_step(p.prog, p.units, mesh, jc, small)(jpt)
    _, td = tsh.make_unit_refresh_step(p.prog, p.units, tmesh, tc, small)(tpt)
    assert int(td["overflow"]) == int(jd["overflow"]) > 0


def test_maintain_step_carry_matches_uncached():
    """The carried maintain step equals the port's uncached one over five
    batches: stores, patches and every diag key, refreshes only where the
    storage step reports a dirty partition (mirrors test_sharded's
    carry-against-uncached test)."""
    g = random_graph(30, 70, seed=47)
    jc, tc = _caps()
    p = _pattern(g, "q1_square", jc)
    m = 4
    mesh = LocalMesh(m)
    storage = build_np_storage(g, m)
    pt = tsh.stack_partitions(storage, tc, "cpu")
    root, _ = tsh.make_list_step(p.prog, mesh, tc)(pt)
    st, _ = tsh.make_init_store_step(p.prog, mesh, tc, p.store)(root)
    st_c = _clone(st)
    carry, rdiag = tsh.make_unit_refresh_step(p.prog, p.units, mesh, tc, p.ucaps)(pt)
    assert int(rdiag["overflow"]) == 0
    sstep = tsh.make_storage_update_step(mesh, tc, tsh.UpdateShapes(n_add=3, n_del=3))
    oracle = tsh.make_maintain_step(p.prog, p.units, mesh, tc, p.store)
    cached = tsh.make_maintain_step(p.prog, p.units, mesh, tc, p.store, unit_caps=p.ucaps)
    rng = np.random.default_rng(49)
    cur = storage
    for b in range(5):
        cur, _, (add, dele) = _batch(cur, rng)
        pt, sdiag = sstep(pt, add, dele)
        st, patch_o, odiag = oracle(pt, st, add, dele)
        st_c2, patch_c, carry2, cdiag = cached(pt, st_c, carry, sdiag["part_dirty"], add, dele)
        assert st_c2 is st_c and carry2 is carry
        assert int(cdiag["unit_refreshes"]) == int(sdiag["part_dirty"].sum()) <= m
        assert_same((st, patch_o, odiag),
                    (st_c, patch_c, {k: v for k, v in cdiag.items() if k != "unit_refreshes"}),
                    f"batch {b}")
        # the carry stays equal to a cold fill of the updated partitions
        fresh, _ = tsh.make_unit_refresh_step(p.prog, p.units, mesh, tc, p.ucaps)(pt)
        assert_same(fresh, carry, f"batch {b} carry")
    assert int(odiag["count"]) > 0


def test_patch_step_carry_matches_uncached_and_jax():
    """Both forms of the patch step equal JAX's at m = 1 and each other
    (mirrors test_sharded's carried patch-step test)."""
    g = random_graph(36, 90, seed=7)
    jc, tc = _caps()
    p = _pattern(g, "q2_triangle", jc)
    mesh, jpt, tmesh, tpt = _m1(g, jc)
    add, dele = _sample_batch(g, np.random.default_rng(5), 2, 36)
    ja, jd_ = jnp.asarray(add, jnp.int32), jnp.asarray(dele, jnp.int32)
    ta, td_ = torch.from_numpy(add.astype(np.int32)), torch.from_numpy(dele.astype(np.int32))
    ush = jsh.UpdateShapes(n_add=2, n_del=2)
    jpt2, jsd = jsh.make_storage_update_step(mesh, jc, ush)(jpt, ja, jd_)
    tpt2, tsd = tsh.make_storage_update_step(tmesh, tc, tsh.UpdateShapes(2, 2))(tpt, ta, td_)
    jcarry, _ = jsh.make_unit_refresh_step(p.prog, p.units, mesh, jc, p.ucaps)(jpt2)
    tcarry, _ = tsh.make_unit_refresh_step(p.prog, p.units, tmesh, tc, p.ucaps)(tpt2)
    jplain = jsh.make_patch_step(p.prog, p.units, mesh, jc)(jpt2, ja)
    tplain = tsh.make_patch_step(p.prog, p.units, tmesh, tc)(tpt2, ta)
    assert_same(jplain, tplain)
    jwith = jsh.make_patch_step(p.prog, p.units, mesh, jc, unit_caps=p.ucaps)(
        jpt2, jcarry, jsd["part_dirty"], ja)
    twith = tsh.make_patch_step(p.prog, p.units, tmesh, tc, unit_caps=p.ucaps)(
        tpt2, tcarry, tsd["part_dirty"], ta)
    assert_same(jwith, twith)
    assert_same(tplain[0], twith[0])
    assert int(twith[2]["patch_groups"]) == int(tplain[1]["patch_groups"]) > 0
    assert int(twith[2]["unit_refreshes"]) == 1


def test_uncached_patch_counts_unit_overflow_at_each_use():
    """With unit tables that overflow their caps the uncached patch counts
    a table's drops at each chain step that joins it and once more, as
    the JAX step does."""
    g = random_graph(36, 90, seed=7)
    jc, tc = _caps(match_cap=64, group_cap=16, set_cap=4, pair_cap=8)
    p = _pattern(g, "q1_square", jc)
    mesh, jpt, tmesh, tpt = _m1(g, jc)
    add, _ = _sample_batch(g, np.random.default_rng(5), 3, 36)
    jpatch, jd = jsh.make_patch_step(p.prog, p.units, mesh, jc)(jpt, jnp.asarray(add, jnp.int32))
    tpatch, td = tsh.make_patch_step(p.prog, p.units, tmesh, tc)(
        tpt, torch.from_numpy(add.astype(np.int32)))
    assert int(jd["overflow"]) > 0
    assert_same((jpatch, jd), (tpatch, td))


def test_update_step_stages_compose_and_match_jax():
    """make_storage_update_step + make_patch_step == make_update_step, and
    the fused step equals JAX's in both modes (mirrors test_sharded's
    composition and full/delta end-to-end tests)."""
    g = random_graph(36, 90, seed=7)
    jc, tc = _caps()
    p = _pattern(g, "q1_square", jc)
    mesh, jpt, tmesh, tpt = _m1(g, jc)
    add, dele = _sample_batch(g, np.random.default_rng(17), 3, 36)
    ja, jd_ = jnp.asarray(add, jnp.int32), jnp.asarray(dele, jnp.int32)
    ta, td_ = torch.from_numpy(add.astype(np.int32)), torch.from_numpy(dele.astype(np.int32))
    ush = tsh.UpdateShapes(n_add=3, n_del=3)
    fused = {}
    for mode in ("delta", "full"):
        fused[mode] = tsh.make_update_step(p.prog, p.units, tmesh, tc, ush, mode=mode)(
            tpt, ta, td_)
        want = jsh.make_update_step(p.prog, p.units, mesh, jc,
                                    jsh.UpdateShapes(n_add=3, n_del=3), mode=mode)(jpt, ja, jd_)
        assert_same(want, fused[mode], mode)
    pt2, sdiag = tsh.make_storage_update_step(tmesh, tc, ush)(tpt, ta, td_)
    patch, pdiag = tsh.make_patch_step(p.prog, p.units, tmesh, tc)(pt2, ta)
    pt2_f, patch_f, diag_f = fused["delta"]
    assert_same((pt2, patch), (pt2_f, patch_f))
    assert int(diag_f["overflow"]) == int(sdiag["overflow"]) + int(pdiag["overflow"])
    assert int(diag_f["patch_groups"]) == int(pdiag["patch_groups"]) > 0
    assert_same(fused["full"][:2], fused["delta"][:2])


def _mega_setup(g, jc, tc, names):
    """Stage 1 and the cold carry of each pattern on the m = 1 JAX mesh and
    the port's, with each side's megastep and carried per-pattern steps."""
    mesh, jpt, tmesh, tpt = _m1(g, jc)
    side = {"jax": dict(specs=[], steps={}, stores={}, carries={}),
            "port": dict(specs=[], steps={}, stores={}, carries={})}
    for name in names:
        p = _pattern(g, name, jc)
        for key, sh, ms, caps, pt in (("jax", jsh, mesh, jc, jpt), ("port", tsh, tmesh, tc, tpt)):
            d = side[key]
            out, _ = sh.make_list_step(p.prog, ms, caps)(pt)
            d["stores"][name], idiag = sh.make_init_store_step(p.prog, ms, caps, p.store)(out)
            assert int(idiag["overflow"]) == 0
            d["carries"][name], rdiag = sh.make_unit_refresh_step(p.prog, p.units, ms, caps,
                                                                  p.ucaps)(pt)
            assert int(rdiag["overflow"]) == 0
            d["specs"].append(sh.MaintainSpec(name=name, prog=p.prog, units=p.units,
                                              store=p.store, unit_caps=p.ucaps))
            d["steps"][name] = sh.make_maintain_step(p.prog, p.units, ms, caps, p.store,
                                                     unit_caps=p.ucaps)
    side["jax"]["mega"] = jsh.make_maintain_mega_step(side["jax"]["specs"], mesh, jc)
    side["port"]["mega"] = tsh.make_maintain_mega_step(side["port"]["specs"], tmesh, tc)
    return mesh, jpt, tmesh, tpt, side


def test_maintain_mega_step_matches_per_pattern_and_jax():
    """One megastep over q2_triangle + q1_square equals each pattern's
    carried step run alone and JAX's megastep at m = 1 over five batches:
    stores, patches, carries and all seven diag keys (mirrors
    test_sharded's megastep test)."""
    g = random_graph(30, 70, seed=47)
    jc, tc = _caps()
    names = ("q2_triangle", "q1_square")
    mesh, jpt, tmesh, tpt, side = _mega_setup(g, jc, tc, names)
    j, t = side["jax"], side["port"]
    ref_stores = {n: _clone(s) for n, s in t["stores"].items()}
    ref_carries = {n: _clone(c) for n, c in t["carries"].items()}
    jstep = jsh.make_storage_update_step(mesh, jc, jsh.UpdateShapes(n_add=3, n_del=3))
    tstep = tsh.make_storage_update_step(tmesh, tc, tsh.UpdateShapes(n_add=3, n_del=3))
    rng = np.random.default_rng(53)
    cur = build_np_storage(g, 1)
    for b in range(5):
        cur, (ja, jd_), (ta, td_) = _batch(cur, rng)
        jpt, jsd = jstep(jpt, ja, jd_)
        tpt, tsd = tstep(tpt, ta, td_)
        want = j["mega"](jpt, j["stores"], j["carries"], jsd["part_dirty"], ja, jd_)
        got = t["mega"](tpt, t["stores"], t["carries"], tsd["part_dirty"], ta, td_)
        assert got[0] is t["stores"] and got[2] is t["carries"]
        assert_same(want, got, f"batch {b}")
        j["stores"], j["carries"] = want[0], want[2]
        for name in names:
            st, patch, carry, diag = t["steps"][name](tpt, ref_stores[name], ref_carries[name],
                                                      tsd["part_dirty"], ta, td_)
            assert sorted(diag) == sorted(got[3][name])
            assert_same((st, patch, carry, diag),
                        tuple(x[name] for x in got), f"batch {b} {name}")
        assert all(int(got[3][n]["overflow"]) == 0 for n in names)
    assert int(got[3]["q1_square"]["count"]) > 0 and int(got[3]["q2_triangle"]["count"]) > 0


def _host_rows(host):
    return set(map(tuple, host.matches_plain().tolist()))


def _store_rows(store, p):
    skel_cols = p.prog.nodes[p.prog.root].skel_cols
    back = jje.comp_to_host(convert.comp_to_numpy(store.flatten()), p.pat, p.cover, skel_cols)
    return set(map(tuple, back.decompress(p.ord)[1].tolist()))


def _megastep_at_m8(names, n, n_edges, seed):
    """The named patterns (tree executor) as slots of one megastep at m = 8
    on ``random_graph(n, n_edges, seed)`` against the host DDSL after stage
    1 and each of three batches: counts and match sets. Returns the host
    engines."""
    g = random_graph(n, n_edges, seed=seed)
    m = 8
    jc, tc = _caps()
    mesh = LocalMesh(m)
    storage = build_np_storage(g, m)
    pt = tsh.stack_partitions(storage, tc, "cpu")
    pats, stores, carries, hosts, specs = {}, {}, {}, {}, []
    for name in names:
        p = pats[name] = _pattern(g, name, jc)
        root, _ = tsh.make_list_step(p.prog, mesh, tc)(pt)
        stores[name], d = tsh.make_init_store_step(p.prog, mesh, tc, p.store)(root)
        carries[name], rd = tsh.make_unit_refresh_step(p.prog, p.units, mesh, tc, p.ucaps)(pt)
        hosts[name] = DDSL(g, p.pat, m=m, cover=p.cover)
        hosts[name].initial()
        assert int(d["overflow"]) == int(rd["overflow"]) == 0
        assert int(d["count"]) == hosts[name].count()
        assert _store_rows(stores[name], p) == _host_rows(hosts[name])
        specs.append(tsh.MaintainSpec(name=name, prog=p.prog, units=p.units, store=p.store,
                                      unit_caps=p.ucaps))
    mega = tsh.make_maintain_mega_step(specs, mesh, tc)
    sstep = tsh.make_storage_update_step(mesh, tc, tsh.UpdateShapes(n_add=3, n_del=3))
    rng = np.random.default_rng(59)
    cur = storage
    for b in range(3):
        add, dele = _sample_batch(cur.graph, rng, 3, n)
        cur, _ = update_np_storage(cur, GraphUpdate(delete=dele, add=add))
        ta = torch.from_numpy(add.astype(np.int32))
        td_ = torch.from_numpy(dele.astype(np.int32))
        pt, sdiag = sstep(pt, ta, td_)
        stores, _, carries, diag = mega(pt, stores, carries, sdiag["part_dirty"], ta, td_)
        for name, p in pats.items():
            hosts[name].apply(GraphUpdate(delete=dele, add=add))
            assert int(diag[name]["overflow"]) == 0, (b, name)
            assert int(diag[name]["count"]) == hosts[name].count(), (b, name)
            assert _store_rows(stores[name], p) == _host_rows(hosts[name]), (b, name)
    return hosts


def test_megastep_with_q5_house_at_m8_matches_host_ddsl():
    """q5_house (and q1_square) as megastep slots at m = 8 equal the host
    DDSL after stage 1 and each of three batches: counts and match sets."""
    hosts = _megastep_at_m8(("q5_house", "q1_square"), 30, 70, seed=47)
    assert hosts["q5_house"].count() > 0


def test_megastep_tree_q3_diamond_q4_clique4_at_m8_matches_host_ddsl():
    """q3_diamond and q4_clique4 on their join trees as megastep slots at
    m = 8 equal the host DDSL after stage 1 and each of three batches (a
    denser graph than q5_house's, which holds 11 K4s)."""
    hosts = _megastep_at_m8(("q3_diamond", "q4_clique4"), 20, 70, seed=50)
    assert hosts["q3_diamond"].count() > 0 and hosts["q4_clique4"].count() > 0


# A small graph and caps for whole pipelines (stage 1 + three batches).
SMALL = RunConfig(n_log2=6, n_edges=150, graph_seed=3, pattern="q1_square", m=4, v_cap=64,
                  deg_cap=32, e_cap=512, match_cap=2048, group_cap=2048, set_cap=32,
                  pair_cap=64, n_add=3, n_del=3)


def test_multi_pattern_pipeline_equals_single_pattern_pipelines():
    """A pipeline maintaining q1_square and q2_triangle in one megastep
    gives each pattern the counts, stores and carries of its own
    single-pattern pipeline."""
    multi = Pipeline(dataclasses.replace(SMALL, more_patterns=("q2_triangle",)), "cpu",
                     use_kernels=False)
    singles = {n: Pipeline(dataclasses.replace(SMALL, pattern=n), "cpu", use_kernels=False)
               for n in ("q1_square", "q2_triangle")}
    plan = multi.describe()["patterns"]
    assert sorted(plan) == ["q1_square", "q2_triangle"]
    assert plan["q1_square"]["unit_plans"] == 2 and plan["q2_triangle"]["unit_plans"] == 1
    runs = {n: list(stages(p, 3)) for n, p in singles.items()}
    for i, rec in enumerate(stages(multi, 3)):
        assert rec["overflow"] == 0
        for name in singles:
            want = runs[name][i]
            assert rec.get("cand_edges") == want.get("cand_edges")
            for k, v in rec["patterns"][name].items():
                assert v == want[k], (i, name, k)
    assert all(r["unit_refreshes"] > 0 for r in runs["q1_square"][1:])
    assert runs["q1_square"][-1]["count"] > 0 and runs["q2_triangle"][-1]["count"] > 0
    for name, single in singles.items():
        assert_same(multi.stores[name], single.stores[name], name)
        assert_same(multi.carries[name], single.carries[name], name)
