"""The port's plan compiler and the host pieces of its streaming backend
against the JAX package's: ``compile_plan`` (plan key and JSON dump, each
executor, m = 1 and 8), the VCBC tables (``compress_table``, ``decompress``,
``concat_tables``, ``cc_join``), ``stack_matches`` (with the int32 owner
hash wrapping), ``comp_to_host`` of a store the port's steps built,
``removed_rows``, and the metrics registry and span tracer exports. Small
random graphs; WT~ once, without K5 (``tests/test_torch_wcoj.py`` compiles
K5 on WT~)."""

import itertools
import json
import time

import numpy as np
import pytest
import torch

from conftest import random_graph

from repro.core import DDSL
from repro.core import vcbc as jvcbc
from repro.core.estimator import GraphStats as JStats
from repro.core.incremental import removed_rows as jremoved
from repro.core.join_tree import minimum_unit_decomposition
from repro.core.match_engine import list_matches
from repro.core.pattern import PATTERN_LIBRARY
from repro.core.plan import JoinPlan
from repro.data.graphs import rmat_graph
from repro.dist import jax_engine as jje
from repro.dist import sharded as jsh
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.planner import CompileContext as JContext
from repro.planner import compile_plan as jcompile
from repro.planner.sizing import StoreCaps as JStoreCaps
from repro_torch import engine as tje
from repro_torch import sharded as tsh
from repro_torch.core import vcbc as tvcbc
from repro_torch.core.estimator import GraphStats as TStats
from repro_torch.core.graph import Graph as TGraph
from repro_torch.core.incremental import removed_rows as tremoved
from repro_torch.core.pattern import PATTERN_LIBRARY as TLIB
from repro_torch.core.pattern import Pattern as TPattern
from repro_torch.core.plan import JoinPlan as TJoinPlan
from repro_torch.core.storage import build_np_storage as tbuild
from repro_torch.mesh import LocalMesh
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.planner import CompileContext as TContext
from repro_torch.planner import compile_plan as tcompile
from repro_torch.run import WT_Q1, plan_pattern
from repro_torch.stream import scheduler as tsched

FIVE = ("q1_square", "q2_triangle", "q3_diamond", "q4_clique4", "q5_house")
CAPS = dict(v_cap=64, deg_cap=32, e_cap=512, match_cap=1024, group_cap=256, set_cap=16,
            pair_cap=32)
CAP_FIELDS = ("v_cap", "deg_cap", "e_cap", "match_cap", "group_cap", "set_cap", "pair_cap")


def _tgraph(g):
    return TGraph._from_codes(g.n, g.codes)


def _no_timings(dump):
    """A plan dump without the passes' wall times."""
    return {**dump, "passes": [{k: v for k, v in p.items() if k != "elapsed_ms"}
                               for p in dump["passes"]]}


def _same_plan(want, got):
    assert got.plan_key() == want.plan_key()
    assert _no_timings(got.to_json()) == _no_timings(want.to_json())
    assert repr(got.program) == repr(want.program)
    json.dumps(got.to_json())


def _compile_both(g, pname, m, caps, executor, **kw):
    """(JAX plan, port plan) of one library pattern, or the ValueError both
    raised with the same message."""
    jc = jje.EngineCaps(**caps) if caps else None
    tc = tje.EngineCaps(**caps, use_kernels=False) if caps else None
    try:
        want = jcompile(JContext(pattern=PATTERN_LIBRARY[pname], stats=JStats.of(g), m=m,
                                 caps=jc, executor=executor, **kw))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tcompile(TContext(pattern=TLIB[pname], stats=TStats.of(_tgraph(g)), m=m, caps=tc,
                              executor=executor, **kw))
        assert str(got.value) == str(e)
        return None, None
    got = tcompile(TContext(pattern=TLIB[pname], stats=TStats.of(_tgraph(g)), m=m, caps=tc,
                            executor=executor, **kw))
    return want, got


# ---------------------------------------------------------------------------
# compile_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("executor", ["tree", "wcoj", "auto"])
def test_compile_plan_equals_jax(executor, m):
    """The five library patterns on random_graph(36, 90, seed=7): the same
    plan key, JSON dump (but the passes' times), program and executor; a
    pattern "wcoj" cannot take raises the same error."""
    g = random_graph(36, 90, seed=7)
    seen = set()
    for pname in FIVE:
        want, got = _compile_both(g, pname, m, CAPS, executor)
        if want is None:
            assert executor == "wcoj" and pname in ("q1_square", "q5_house")
            continue
        _same_plan(want, got)
        seen.add(got.executor)
    assert seen == ({"wcoj"} if executor == "wcoj" else {"tree"})


def test_compile_plan_equals_jax_on_wt_auto():
    """WT~ (rmat_graph(12, 10_000, seed=1)) under executor="auto" at m = 8
    with WT_Q1's engine caps: the generic join for q2_triangle, q3_diamond
    and q4_clique4, the join tree for q1_square and q5_house (with
    q6_clique5 on the generic join, the 4-of-6 choice), plans equal."""
    g = rmat_graph(12, 10_000, seed=1)
    caps = {k: getattr(WT_Q1, k) for k in CAP_FIELDS}
    picked = {}
    for pname in FIVE:
        want, got = _compile_both(g, pname, 8, caps, "auto")
        _same_plan(want, got)
        picked[pname] = got.executor
    assert picked == {"q1_square": "tree", "q2_triangle": "wcoj", "q3_diamond": "wcoj",
                      "q4_clique4": "wcoj", "q5_house": "tree"}


@pytest.mark.parametrize("pname", ["q1_square", "q5_house"])
def test_compile_plan_cost_objective_and_pinned_cover_equal_jax(pname):
    """The online re-optimizer's joint cover + tree search (objective
    "cost", with its search pass), a pinned cover, no caps, and the errors
    of an unknown executor or objective and of a cover that is none."""
    g = random_graph(36, 90, seed=7)
    want, got = _compile_both(g, pname, 8, CAPS, "tree", cover_objective="cost")
    _same_plan(want, got)
    assert got.passes[-1].name == "search"
    want, got = _compile_both(g, pname, 1, None, "auto", cover=want.cover)
    _same_plan(want, got)
    assert got.store_caps is None and got.sharding is None
    for kw in (dict(executor="greedy"), dict(cover_objective="size"), dict(cover=(0,))):
        _compile_both(g, pname, 1, None, kw.pop("executor", "tree"), **kw)


def test_plan_pattern_is_compile_plan():
    """run.plan_pattern takes compile_plan's plan: cover, ord, units,
    program, cost and caps; under "wcoj" the calibrated level caps."""
    g = _tgraph(random_graph(36, 90, seed=7))
    stats, storage = TStats.of(g), tbuild(g, 8)
    caps = tje.EngineCaps(**CAPS, use_kernels=False)
    for pname, executor in (("q1_square", "auto"), ("q2_triangle", "wcoj")):
        plan = tcompile(TContext(pattern=TLIB[pname], stats=stats, m=8, caps=caps,
                                 executor=executor))
        pp = plan_pattern(pname, stats, storage, caps, LocalMesh(8), executor)
        assert (pp.executor, pp.cover, pp.ord, pp.units, pp.cost, pp.unit_caps) == (
            plan.executor, plan.cover, plan.ord, plan.units, plan.cost, plan.unit_caps)
        assert repr(pp.prog) == repr(plan.program)
        if executor == "wcoj":
            assert pp.wcoj == plan.wcoj and len(pp.level_caps) == len(plan.wcoj_level_caps)
            assert pp.store_caps.group_cap >= plan.store_caps.group_cap
        else:
            assert pp.store_caps == plan.store_caps


# ---------------------------------------------------------------------------
# VCBC tables
# ---------------------------------------------------------------------------

def _same_table(want, got):
    assert got.cover == tuple(want.cover) and got.skeleton_cols == tuple(want.skeleton_cols)
    assert got.pattern.key() == want.pattern.key()
    np.testing.assert_array_equal(got.skeleton, want.skeleton)
    assert sorted(got.comp) == sorted(want.comp)
    for v, r in want.comp.items():
        np.testing.assert_array_equal(got.comp[v].offsets, r.offsets)
        np.testing.assert_array_equal(got.comp[v].values, r.values)


def _host_matches(g, pname):
    """A DDSL's table of ``pname`` on ``g``, its plain rows and cover."""
    d = DDSL(g, PATTERN_LIBRARY[pname], m=4)
    d.initial()
    cols, rows = d.state.matches.decompress(d.ord_)
    return d, cols, rows


@pytest.mark.parametrize("pname", FIVE)
def test_compress_decompress_concat_equal_jax(pname):
    """compress_table under the DDSL cover and under every vertex, then
    decompress, count_matches, concat_tables and storage_ints."""
    g = random_graph(24, 70, seed=3)
    d, cols, rows = _host_matches(g, pname)
    ord_ = d.ord_
    for cover in (d.cover, tuple(PATTERN_LIBRARY[pname].vertices)):
        want = jvcbc.compress_table(PATTERN_LIBRARY[pname], cover, cols, rows)
        got = tvcbc.compress_table(TLIB[pname], cover, cols, rows)
        _same_table(want, got)
        assert got.count_matches(ord_) == want.count_matches(ord_) == rows.shape[0]
        assert got.storage_ints() == want.storage_ints()
        wc, wr = want.decompress(ord_)
        gc, gr = got.decompress(ord_)
        assert gc == wc
        np.testing.assert_array_equal(gr, wr)
        half = rows.shape[0] // 2
        parts = [(rows[:half], rows[half:])]
        wcat = jvcbc.concat_tables([jvcbc.compress_table(PATTERN_LIBRARY[pname], cover, cols, r)
                                    for r in parts[0]])
        gcat = tvcbc.concat_tables([tvcbc.compress_table(TLIB[pname], cover, cols, r)
                                    for r in parts[0]])
        _same_table(wcat, gcat)


def test_cc_join_equals_jax():
    """q1_square's two Nav-join units listed on the host, compressed under
    the pattern's cover and CC-joined: the same table (empty groups dropped
    alike), holding every match of the pattern."""
    g = random_graph(24, 70, seed=3)
    pat = PATTERN_LIBRARY["q1_square"]
    d = DDSL(g, pat, m=4)
    d.initial()
    ord_, cover = d.ord_, d.cover
    units = minimum_unit_decomposition(pat, cover)
    assert len(units) == 2
    tabs = []
    for u in units:
        sub = [e for e in ord_ if set(e) <= set(u.pattern.vertices)]
        cols, rows = list_matches(g, u.pattern, sub)
        tabs.append((u.pattern, cols, rows))
    jt = [jvcbc.compress_table(p, cover, c, r) for p, c, r in tabs]
    tt = [tvcbc.compress_table(TPattern.make(p.edges, p.vertices), cover, c, r)
          for p, c, r in tabs]
    want = jvcbc.cc_join(jt[0], jt[1], ord_,
                         JoinPlan.make(jt[0].pattern, jt[1].pattern, cover, ord_))
    got = tvcbc.cc_join(tt[0], tt[1], ord_,
                        TJoinPlan.make(tt[0].pattern, tt[1].pattern, cover, ord_))
    _same_table(want, got)
    assert got.count_matches(ord_) == want.count_matches(ord_) == d.count() > 0


def _wide_table(pname, seed=0):
    """A compressed table of ``pname`` whose skeleton ids are near 2**30, so
    the ownership hash wraps in int32, with sets of 1-5 values."""
    rng = np.random.default_rng(seed)
    pat, tpat = PATTERN_LIBRARY[pname], TLIB[pname]
    cover = DDSL(random_graph(24, 70, seed=3), pat, m=4).cover
    cols = tuple(sorted(pat.vertices))
    base = (1 << 30) + rng.integers(0, 1 << 20, size=(400, len(cols)))
    reps = rng.integers(1, 6, size=400)
    rows = np.repeat(base, reps, axis=0)
    comp = [c for c in cols if c not in cover]
    rows[:, [cols.index(c) for c in comp]] = rng.integers(0, 1 << 30, size=(rows.shape[0],
                                                                           len(comp)))
    return (jvcbc.compress_table(pat, cover, cols, rows),
            tvcbc.compress_table(tpat, cover, cols, rows))


@pytest.mark.parametrize("m", [3, 8])
def test_stack_matches_byte_equal_jax(m):
    """Skeletons whose int32 hash overflows, placed on m owners: the same
    stacked store, byte for byte, and a misfit raises the same error."""
    want_t, got_t = _wide_table("q1_square")
    skel = want_t.skeleton.astype(np.int64)
    wide = np.zeros(skel.shape[0], np.int64)
    for j in range(skel.shape[1]):
        wide = wide * 1000003 + skel[:, j]
    assert np.abs(wide).max() > 2**31          # the hash wraps
    np.testing.assert_array_equal(tsh._owner_rows_np(skel, m), jsh._owner_rows_np(skel, m))
    caps = (512, 16)
    want = jsh.stack_matches(want_t, m, JStoreCaps(*caps))
    got = tsh.stack_matches(got_t, m, tsh.StoreCaps(*caps), device="cpu")
    np.testing.assert_array_equal(got.skeleton.numpy(), np.asarray(want.skeleton))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert sorted(got.sets) == sorted(want.sets)
    for v in want.sets:
        np.testing.assert_array_equal(got.sets[v].numpy(), np.asarray(want.sets[v]))
    for bad in ((8, 16), (512, 2)):
        with pytest.raises(ValueError) as e:
            jsh.stack_matches(want_t, m, JStoreCaps(*bad))
        with pytest.raises(ValueError, match=str(e.value).split(" > ")[1]):
            tsh.stack_matches(got_t, m, tsh.StoreCaps(*bad), device="cpu")


@pytest.mark.parametrize("pname", ["q1_square", "q5_house"])
def test_comp_to_host_of_the_port_store_equals_jax(pname):
    """A store built by the port's list and init-store steps at m = 8, read
    back by the port's comp_to_host and by JAX's on the same arrays: the
    same table, whose rows are the host DDSL's."""
    g = random_graph(24, 70, seed=3)
    tg = _tgraph(g)
    caps = tje.EngineCaps(**CAPS, use_kernels=False)
    plan = tcompile(TContext(pattern=TLIB[pname], stats=TStats.of(tg), m=8, caps=caps))
    mesh = LocalMesh(8)
    pt = tsh.stack_partitions(tbuild(tg, 8), caps, "cpu")
    root, _ = tsh.make_list_step(plan.program, mesh, caps)(pt)
    store, diag = tsh.make_init_store_step(plan.program, mesh, caps, plan.store_caps)(root)
    assert int(diag["overflow"]) == 0
    flat = store.flatten()
    arrs = dict(skeleton=flat.skeleton.numpy(), valid=flat.valid.numpy(),
                sets={v: a.numpy() for v, a in flat.sets.items()})
    skel_cols = plan.program.nodes[plan.program.root].skel_cols
    want = jje.comp_to_host(jje.CompTensors(**arrs), PATTERN_LIBRARY[pname], plan.cover,
                            skel_cols)
    got = tje.comp_to_host(tje.CompTensors(**arrs), TLIB[pname], plan.cover, skel_cols)
    _same_table(want, got)
    got_cpu = tje.comp_to_host(flat, TLIB[pname], plan.cover, skel_cols)
    _same_table(want, got_cpu)
    d, _, rows = _host_matches(g, pname)
    assert set(map(tuple, got.decompress(plan.ord)[1].tolist())) == set(map(tuple,
                                                                         rows.tolist()))


@pytest.mark.parametrize("pname", ["q2_triangle", "q1_square", "q5_house"])
def test_removed_rows_equal_jax(pname):
    g = random_graph(24, 70, seed=3)
    d, cols, rows = _host_matches(g, pname)
    want_t = jvcbc.compress_table(PATTERN_LIBRARY[pname], d.cover, cols, rows)
    got_t = tvcbc.compress_table(TLIB[pname], d.cover, cols, rows)
    edges = g.edges()
    rng = np.random.default_rng(5)
    for k in (0, 1, 6):
        dele = edges[rng.choice(edges.shape[0], size=k, replace=False)]
        want = jremoved(want_t, dele, d.ord_)
        got = tremoved(got_t, dele, d.ord_)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        if k == 6:
            assert got.shape[0] > 0


# ---------------------------------------------------------------------------
# metrics and spans
# ---------------------------------------------------------------------------

def _drive_obs(metrics_mod, trace_mod, probe=None):
    reg = metrics_mod.MetricsRegistry()
    reg.counter("stream_batches_total", "committed micro-batches").inc()
    reg.counter("host_transfer_bytes_total", "bytes").inc(4096)
    c = reg.counter("jax_execute_calls_total", "calls", labels=("step",))
    c.labels(step="maintain_mega").inc()
    c.labels(step="storage_update").inc(3)
    reg.gauge("stream_watermark_lag", "lag").set(7)
    reg.gauge("unit_cache_entries", "entries", labels=("pattern",)).labels(pattern="sq").set(2.5)
    h = reg.histogram("stream_batch_latency_seconds", "latency")
    for x in (0.0004, 0.003, 0.2, 1.5, 30.0):
        h.observe(x)
    if probe is not None:
        probe("cache_misses", 16, metrics=reg)
        probe("host_materializations", metrics=reg)
    tr = trace_mod.Tracer(enabled=True)
    for b in range(2):
        with tr.span("batch", batch_index=b, lo=b, hi=b + 4) as bsp:
            with tr.span("storage_update") as ssp:
                ssp.add("overflow", 0)
            with tr.span("maintain_mega", patterns=2) as msp:
                msp.add("store_groups", 12 + b)
            for name in ("tri", "sq"):
                with tr.span("maintain", pattern=name) as psp:
                    psp.add("patch_groups", b)
                    with tr.span("materialize", pattern=name) as sp:
                        sp.add("host_bytes", 64)
            bsp.add("n_ops", 4)
    trace_mod.Tracer(enabled=False).span("batch").add("n", 1)
    return reg, tr


def test_metrics_and_tracer_exports_equal_jax(monkeypatch, tmp_path):
    """The same calls on each package's registry and tracer (one clock for
    both) export the same Prometheus text, JSON snapshot, span JSONL and
    Chrome trace; the port's probe_inc mirrors like JAX's."""
    from repro.stream import scheduler as jsched

    out = {}
    for tag, mm, tm, probe in (("jax", jmetrics, jtrace, jsched.probe_inc),
                               ("torch", tmetrics, ttrace, tsched.probe_inc)):
        tick = itertools.count(10_000, 1_000)
        monkeypatch.setattr(time, "perf_counter_ns", lambda: next(tick))
        monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_000_000_000)
        reg, tr = _drive_obs(mm, tm, probe)
        tr.to_jsonl(str(tmp_path / f"{tag}.jsonl"))
        tr.to_chrome_trace(str(tmp_path / f"{tag}.json"))
        out[tag] = (reg.to_prometheus(), reg.snapshot(),
                    (tmp_path / f"{tag}.jsonl").read_text(),
                    (tmp_path / f"{tag}.json").read_text(),
                    [r.skeleton() for r in tr.roots])
    assert out["torch"] == out["jax"]
    assert "unit_cache_misses_total 16" in out["torch"][0]
    assert tsched.PROBE_METRIC_NAMES == jsched.PROBE_METRIC_NAMES


def test_probe_is_the_ports_own():
    """The port's PROBE counts in this package only."""
    from repro.stream import scheduler as jsched

    tsched.reset_probe()
    jsched.reset_probe()
    tsched.probe_inc("cache_hits", 3)
    assert tsched.PROBE["cache_hits"] == 3 and jsched.PROBE["cache_hits"] == 0
    tsched.reset_probe()
    assert tsched.PROBE["cache_hits"] == 0


def test_stack_matches_keeps_the_store_layout():
    """stack_matches keeps the store layout of the steps: int32 ids, bool
    valid, PAD tails."""
    _, got_t = _wide_table("q5_house", seed=1)
    st = tsh.stack_matches(got_t, 8, tsh.StoreCaps(512, 16), device="cpu")
    assert st.skeleton.dtype == torch.int32 and st.valid.dtype == torch.bool
    assert all(a.dtype == torch.int32 for a in st.sets.values())
    n = st.valid.sum(dim=1)
    for j in range(8):
        assert bool(st.valid[j, : n[j]].all()) and not bool(st.valid[j, n[j]:].any())
        assert bool((st.skeleton[j, n[j]:] == -1).all())
    assert int(n.sum()) == got_t.n_groups
