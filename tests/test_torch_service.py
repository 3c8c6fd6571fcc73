"""The port's streaming front door (``repro_torch.stream``: the journal, the
scheduler and its shared delta, the sinks, ``ListingService`` with
``HostBackend`` and ``TorchBackend``, snapshots and ``PlanManager``) against
the JAX package's ``repro.stream`` on the same inputs, made from seeds.

Everything is held exactly equal: journal windows and files, scheduler
floats, counts, batch metrics and reports (all but the fields that hold
measured seconds), overflow counters, audits, sink events, registry
counters, snapshots (each package restores the other's) and plan swaps."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from conftest import random_graph

from repro import stream as jstream
from repro.core.estimator import GraphStats as JStats
from repro.core.graph import GraphUpdate as JUpdate
from repro.core.pattern import PATTERN_LIBRARY as JLIB
from repro.core.storage import build_np_storage as jbuild
from repro.data.graphs import sample_update
from repro.planner import CompileContext as JContext
from repro.planner import compile_plan as jcompile
from repro.stream.service import _default_caps
from repro_torch import convert
from repro_torch import engine as tje
from repro_torch import stream as tstream
from repro_torch.backend import TorchBackend
from repro_torch.core.estimator import GraphStats
from repro_torch.core.graph import Graph, GraphUpdate
from repro_torch.core.pattern import PATTERN_LIBRARY
from repro_torch.core.storage import build_np_storage
from repro_torch.planner import CompileContext, compile_plan
from repro_torch.stream import (BatchScheduler, CountDeltaSink, ListingService, MatchDeltaSink,
                                PlanManager, UpdateJournal, compute_shared_delta)

SPECS = {"tri": "q2_triangle", "sq": "q1_square"}
SMALL = dict(match_cap=512, group_cap=256, set_cap=16, pair_cap=32)
# fields of BatchMetrics / PatternReport / BatchEvent / SwapEvent that hold
# measured seconds (or derive from them), left out of the comparisons
TIMED = {"latency_s", "predicted_s", "elapsed_s"}
# gauges that do not derive from measured seconds
GAUGES = ("stream_watermark_lag", "stream_cand_vertices", "stream_cand_edges",
          "unit_cache_resident_bytes", "unit_cache_entries")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_graph(g) -> Graph:
    return Graph._from_codes(g.n, np.asarray(g.codes, np.int64))


def _port_update(u) -> GraphUpdate:
    return GraphUpdate(delete=np.asarray(u.delete, np.int64).reshape(-1, 2),
                       add=np.asarray(u.add, np.int64).reshape(-1, 2))


def _rows(table) -> set:
    return set(map(tuple, np.asarray(table).tolist()))


def _fields(obj) -> dict:
    return {k: v for k, v in dataclasses.asdict(obj).items() if k not in TIMED}


def _same_report(jr, tr):
    assert isinstance(tr, tstream.PatternReport)
    a, b = _fields(jr), _fields(tr)
    for k in ("added", "removed"):
        x, y = a.pop(k), b.pop(k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert np.array_equal(x, y), k
    assert a == b


def _same_metrics(jm, tm):
    assert isinstance(tm, tstream.BatchMetrics)
    assert tm.overflow == jm.overflow and tm.patterns.keys() == jm.patterns.keys()
    for name, jr in jm.patterns.items():
        _same_report(jr, tm.patterns[name])
    a = {k: v for k, v in vars(jm).items() if k not in TIMED | {"patterns"}}
    b = {k: v for k, v in vars(tm).items() if k not in TIMED | {"patterns"}}
    assert a == b


def _same_registry(jsvc, tsvc):
    js, ts = jsvc.obs.metrics.snapshot(), tsvc.obs.metrics.snapshot()
    counters = sorted(n for n, e in js.items() if e["type"] == "counter")
    assert counters == sorted(n for n, e in ts.items() if e["type"] == "counter")
    for name in counters + [g for g in GAUGES if g in js]:
        assert ts[name]["values"] == js[name]["values"], name


def _same_service(jsvc, tsvc):
    """Counts, watermarks, graphs, every BatchMetrics, audits and the
    registry's deterministic instruments; every pattern's rows."""
    assert tsvc.committed_watermark == jsvc.committed_watermark
    assert tsvc.journal.tail == jsvc.journal.tail
    assert tsvc.counts() == jsvc.counts()
    assert np.array_equal(tsvc.graph.codes, jsvc.graph.codes) and tsvc.graph.n == jsvc.graph.n
    assert len(tsvc.metrics) == len(jsvc.metrics)
    for jm, tm in zip(jsvc.metrics, tsvc.metrics):
        _same_metrics(jm, tm)
    assert tsvc.audits == jsvc.audits
    _same_registry(jsvc, tsvc)
    for name in tsvc.patterns():
        assert _rows(tsvc.backend.matches_plain(name)) == _rows(jsvc.backend.matches_plain(name))


def _ingest_both(jsvc, tsvc, d, a, seed):
    u = sample_update(jsvc.projected_graph(), d, a, seed=seed)
    assert jsvc.ingest(u) == tsvc.ingest(_port_update(u))


def _host_pair(g, m=3, names=("tri", "sq"), **kw):
    jsvc = jstream.ListingService(g, m=m, backend="host", **kw.get("j", {}))
    tsvc = ListingService(_port_graph(g), m=m, backend="host", **kw.get("t", {}))
    for name in names:
        assert tsvc.register(name, PATTERN_LIBRARY[SPECS[name]]) == jsvc.register(
            name, JLIB[SPECS[name]])
    return jsvc, tsvc


# ---------------------------------------------------------------------------
# Journal
# ---------------------------------------------------------------------------

def _toggle_ops(n_ops, seed):
    """A well-formed op stream over a small edge pool: each op toggles one
    edge, so deletes hit present edges and inserts absent ones."""
    rng = np.random.default_rng(seed)
    present = {(0, 1), (1, 2), (2, 3)}
    ops = []
    for _ in range(n_ops):
        a, b = sorted(int(x) for x in rng.choice(6, 2, replace=False))
        e = (a, b)
        ops.append(("delete" if e in present else "add", e))
        present ^= {e}
    return ops


def _journals(ops):
    jj, tj = jstream.UpdateJournal(), UpdateJournal()
    for kind, e in ops:
        assert jj.append(JUpdate.make(**{kind: [e]})) == tj.append(GraphUpdate.make(**{kind: [e]}))
    return jj, tj


def _same_update(ju, tu):
    assert np.array_equal(np.asarray(ju.delete), tu.delete)
    assert np.array_equal(np.asarray(ju.add), tu.add)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_journal_windows_netting_and_watermarks_equal_jax(seed):
    jj, tj = _journals(_toggle_ops(40, seed))
    assert (tj.tail, tj.base, len(tj)) == (jj.tail, jj.base, len(jj))
    for lo in range(0, 41, 5):
        for hi in (lo, lo + 3, lo + 11, None):
            _same_update(jj.window(lo, hi), tj.window(lo, hi))
            _same_update(jj.replay(lo, hi), tj.replay(lo, hi))
        assert tj.pending(lo) == jj.pending(lo)
    assert [dataclasses.astuple(e) for e in tj.entries(3, 17)] == [
        dataclasses.astuple(e) for e in jj.entries(3, 17)]
    assert [e.edge() for e in tj.entries(3, 17)] == [e.edge() for e in jj.entries(3, 17)]
    assert tj.truncate(12) == jj.truncate(12)
    _same_update(jj.window(12), tj.window(12))
    for j in (jj, tj):
        with pytest.raises(ValueError, match="precedes truncation base 12"):
            j.window(5)


def test_journal_files_are_byte_identical_and_load_across(tmp_path):
    jj, tj = _journals(_toggle_ops(30, 7))
    jj.truncate(9)
    tj.truncate(9)
    jp, tp = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    assert jj.save(jp) == tj.save(tp)
    assert filecmp.cmp(jp, tp, shallow=False)
    from_j, from_t = UpdateJournal.load(jp), jstream.UpdateJournal.load(tp)
    for lo in (9, 15, 20):
        _same_update(from_t.window(lo), from_j.window(lo))
        _same_update(jj.window(lo), from_j.window(lo))
    assert (from_j.base, from_j.tail) == (9, 30)
    with open(tp, "a") as f:
        f.write('{"seq": 99, "op": 1, "code": 5}\n')
    with pytest.raises(ValueError, match="corrupt journal"):
        UpdateJournal.load(tp)


# ---------------------------------------------------------------------------
# The shared delta and the scheduler
# ---------------------------------------------------------------------------

def test_shared_delta_storage_and_seeds_equal_jax():
    """compute_shared_delta, ensure_storage (Φ(d'), its report and stats)
    and the memoized seeds of two patterns sharing a unit, with and without
    the unit cache; the PROBE mirrors in each service registry."""
    from repro.core.unit_cache import PartitionUnitCache as JCache
    from repro.obs.metrics import MetricsRegistry as JRegistry
    from repro_torch.core.unit_cache import PartitionUnitCache
    from repro_torch.obs.metrics import MetricsRegistry

    g = random_graph(24, 60, seed=41)
    jj, tj = jstream.UpdateJournal(), UpdateJournal()
    u = sample_update(g, 3, 3, seed=43)
    jj.append(u)
    tj.append(_port_update(u))
    jreg, treg = JRegistry(), MetricsRegistry()
    jd = jstream.compute_shared_delta(jj, 0, jj.tail, metrics=jreg)
    td = compute_shared_delta(tj, 0, tj.tail, metrics=treg)
    assert (td.lo, td.hi, td.n_ops, td.net_size) == (jd.lo, jd.hi, jd.n_ops, jd.net_size)
    assert np.array_equal(td.add_codes, jd.add_codes)
    assert np.array_equal(td.delete_codes, jd.delete_codes)
    js, ts = jbuild(g, 3), build_np_storage(_port_graph(g), 3)
    js2, ts2 = jd.ensure_storage(js), td.ensure_storage(ts)
    assert td.ensure_storage(ts) is ts2
    assert dataclasses.asdict(td.storage_report) == dataclasses.asdict(jd.storage_report)
    assert dataclasses.asdict(td.stats) == dataclasses.asdict(jd.stats)
    for jp, tp in zip(js2.parts, ts2.parts):
        assert np.array_equal(jp.codes, tp.codes)
    jcache, tcache = JCache(js), PartitionUnitCache(ts)
    jcache.advance(js2, jd.storage_report.dirty_parts)
    tcache.advance(ts2, td.storage_report.dirty_parts)
    for name in ("q1_square", "q5_house"):
        jp = jcompile(JContext(pattern=JLIB[name], stats=JStats.of(g), m=3))
        tp = compile_plan(CompileContext(pattern=PATTERN_LIBRARY[name],
                                         stats=GraphStats.of(_port_graph(g)), m=3))
        for cache_j, cache_t in ((None, None), (jcache, tcache)):
            jfn = jd.seed_provider(jp.cover, jp.ord, cache=cache_j)
            tfn = td.seed_provider(tp.cover, tp.ord, cache=cache_t)
            for ju, tu in zip(jp.units, tp.units):
                jt, tt = jfn(ju), tfn(tu)
                assert tt.skeleton_cols == jt.skeleton_cols
                assert np.array_equal(tt.skeleton, jt.skeleton)
                for v, r in jt.comp.items():
                    assert np.array_equal(tt.comp[v].values, r.values)
    assert dataclasses.asdict(tcache.stats) == dataclasses.asdict(jcache.stats)
    assert treg.snapshot() == jreg.snapshot()


def test_batch_scheduler_equals_jax_under_scripted_observations():
    """The same register / refresh / observe / observe_cache series: every
    batch size, prediction, drift and cost term equal, float for float."""
    g = random_graph(30, 90, seed=47)
    jsch = jstream.BatchScheduler(target_cost=900.0, target_latency_s=0.02, min_ops=2,
                                  max_ops=40)
    tsch = BatchScheduler(target_cost=900.0, target_latency_s=0.02, min_ops=2, max_ops=40)
    jsvc = jstream.ListingService(g, m=3)
    tsvc = ListingService(_port_graph(g), m=3)
    for name in ("sq", "tri"):
        jsvc.register(name, JLIB[SPECS[name]])
        tsvc.register(name, PATTERN_LIBRARY[SPECS[name]])
        jm, tm = jsvc.backend.meta(name), tsvc.backend.meta(name)
        jsch.register(name, jm.pattern, jm.ord_, jm.units)
        tsch.register(name, tm.pattern, tm.ord_, tm.units)
    jsch.refresh(JStats.of(g))
    tsch.refresh(GraphStats.of(_port_graph(g)))
    rng = np.random.default_rng(49)

    def state(s):
        return (s.cost_per_op(), s.fixed_cost_cold(), s.fixed_miss_rate(), s.fixed_cost(),
                s.predict_seconds(17), s.drift(), s.last_predicted_s, s.last_observed_s,
                s.last_drift, s.min_ops, s.max_ops, [s.next_batch_size(p) for p in
                                                     (0, 1, 5, 37, 500)])

    assert state(tsch) == state(jsch)
    for i in range(30):
        k = int(rng.integers(1, 40))
        sec = float(rng.choice([0.0, rng.uniform(1e-4, 0.05)]))
        jsch.observe(k, sec)
        tsch.observe(k, sec)
        h, m = (int(x) for x in rng.integers(0, 9, size=2))
        jsch.observe_cache(h, m)
        tsch.observe_cache(h, m)
        if i == 20:
            jsch.reset_drift()
            tsch.reset_drift()
            jsch.clamp_max_ops(12)
            tsch.clamp_max_ops(12)
        assert state(tsch) == state(jsch)
    jsch.unregister("tri")
    tsch.unregister("tri")
    assert state(tsch) == state(jsch)


# ---------------------------------------------------------------------------
# The service: host backend, device backend, sinks, snapshots, plan swaps
# ---------------------------------------------------------------------------

N_STREAM_BATCHES = 25


def test_host_service_stream_equals_jax():
    """tests/test_stream.py's 50-batch host stream cut to 25 batches, with a
    periodic audit and both kinds of sink: everything equal to JAX's."""
    g = random_graph(20, 45, seed=13)
    sched = dict(max_ops=4, min_ops=1)
    jsvc, tsvc = _host_pair(g, j=dict(scheduler=jstream.BatchScheduler(**sched), audit_every=5),
                            t=dict(scheduler=BatchScheduler(**sched), audit_every=5))
    jc, tc = jsvc.subscribe(jstream.CountDeltaSink()), tsvc.subscribe(CountDeltaSink())
    jm, tm = (jsvc.subscribe(jstream.MatchDeltaSink(["sq"])),
              tsvc.subscribe(MatchDeltaSink(["sq"])))
    b = 0
    while len(tsvc.metrics) < N_STREAM_BATCHES:
        _ingest_both(jsvc, tsvc, 2, 2, seed=1000 + b)
        assert len(tsvc.advance()) == len(jsvc.advance())
        b += 1
    _same_service(jsvc, tsvc)
    assert len(tsvc.audits) == len(tsvc.metrics) // 5 and all(ok for *_, ok in tsvc.audits)
    assert tc.events == jc.events and tc.totals == jc.totals
    for attr in ("added", "removed"):
        got, want = getattr(tm, attr), getattr(jm, attr)
        assert [(p, hi) for p, hi, _ in got] == [(p, hi) for p, hi, _ in want]
        assert all(np.array_equal(x[2], y[2]) for x, y in zip(got, want))
    assert all(m.patterns[n].added is None for m in tsvc.metrics for n in m.patterns)
    assert tsvc.audit() == jsvc.audit() == {"tri": True, "sq": True}
    assert tsvc.compact() == jsvc.compact()
    assert len(tsvc.journal) == 0


def _device_caps(g):
    """The JAX service's own cap sizing at one partition with smaller
    listing caps (as tests/test_torch_backend.py sizes them)."""
    return dataclasses.replace(_default_caps(jbuild(g, 1), g, 1, False), **SMALL)


def test_torch_backend_service_equals_jax_sharded_service():
    """The port's service with backend="sharded" (a TorchBackend on the CPU,
    m = 8) against the JAX service's ShardedBackend over 6 batches, a no-op
    window and a periodic audit: counts, metrics (host bytes, candidate
    counters, cache traffic, overflow), reports and rows equal."""
    g = random_graph(18, 35, seed=51)
    caps = _device_caps(g)
    jsvc = jstream.ListingService(g, backend="sharded", caps=caps, max_add=4, max_del=4,
                                  scheduler=jstream.BatchScheduler(max_ops=8), audit_every=3)
    tsvc = ListingService(_port_graph(g), backend="sharded", caps=caps, max_add=4, max_del=4,
                          m=8, device="cpu", scheduler=BatchScheduler(max_ops=8),
                          audit_every=3)
    assert isinstance(tsvc.backend, TorchBackend) and isinstance(tsvc.backend,
                                                                 tstream.StreamBackend)
    assert tsvc.scheduler.max_ops == jsvc.scheduler.max_ops == 4
    for name in ("tri", "sq"):
        assert tsvc.register(name, PATTERN_LIBRARY[SPECS[name]]) == jsvc.register(
            name, JLIB[SPECS[name]])
    for b in range(3):
        _ingest_both(jsvc, tsvc, 2, 2, seed=53 + b)
        tsvc.advance()
        jsvc.advance()
    # a window netting to nothing: an insert and its delete
    e = next((a, c) for a in range(g.n) for c in range(a + 1, g.n)
             if (a << 32 | c) not in set(int(x) for x in tsvc.projected_graph().codes))
    for svc, upd in ((jsvc, JUpdate), (tsvc, GraphUpdate)):
        svc.ingest(upd.make(add=[e]))
        svc.ingest(upd.make(delete=[e]))
        svc.advance()
    for b in range(2):
        _ingest_both(jsvc, tsvc, 2, 2, seed=63 + b)
        tsvc.advance()
        jsvc.advance()
    assert len(tsvc.metrics) == len(jsvc.metrics) == 6
    noop = tsvc.metrics[3]
    assert noop.net_add == noop.net_delete == 0 and noop.host_bytes == 0
    for jm, tm in zip(jsvc.metrics, tsvc.metrics):
        assert tm.host_bytes == jm.host_bytes == 0 and tm.overflow == 0
        assert (tm.cand_vertices, tm.cand_edges) == (jm.cand_vertices, jm.cand_edges)
        for name, jr in jm.patterns.items():
            tr = tm.patterns[name]
            for f in ("count_before", "count_after", "patch_groups", "removed_groups",
                      "overflow"):
                assert getattr(tr, f) == getattr(jr, f), (name, f)
    assert tsvc.counts() == jsvc.counts() and tsvc.audits == jsvc.audits
    for name in ("tri", "sq"):
        assert _rows(tsvc.backend.matches_plain(name)) == _rows(jsvc.backend.matches_plain(name))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshots_restore_across_packages(direction, tmp_path):
    """A snapshot written by one package (with ops pending past its
    watermark) restores in the other, on the host backend and on the port's
    device backend; the files themselves are the same bytes but for the
    zip members of the tables, whose arrays are equal; both continue equal."""
    g = random_graph(20, 40, seed=91)
    sched = dict(max_ops=5)
    jsvc, tsvc = _host_pair(g, j=dict(scheduler=jstream.BatchScheduler(**sched)),
                            t=dict(scheduler=BatchScheduler(**sched)))
    for b in range(3):
        _ingest_both(jsvc, tsvc, 2, 2, seed=93 + b)
    jsvc.advance()
    tsvc.advance()
    _ingest_both(jsvc, tsvc, 2, 2, seed=97)          # pending past the watermark
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jsvc.snapshot(jdir)
    tsvc.snapshot(tdir)
    for f in ("meta.json", "journal.jsonl"):
        assert filecmp.cmp(os.path.join(jdir, f), os.path.join(tdir, f), shallow=False), f
    for f in sorted(os.listdir(jdir)):
        if f.endswith(".npz"):
            zj, zt = np.load(os.path.join(jdir, f)), np.load(os.path.join(tdir, f))
            assert sorted(zj.files) == sorted(zt.files)
            assert all(np.array_equal(zj[k], zt[k]) and zj[k].dtype == zt[k].dtype
                       for k in zj.files)
    src = jdir if direction == "jax_to_port" else tdir
    jr = jstream.ListingService.restore(src, backend="host", m=3,
                                        scheduler=jstream.BatchScheduler(**sched))
    tr = ListingService.restore(src, backend="host", m=3, scheduler=BatchScheduler(**sched))
    caps = _device_caps(g)
    td = ListingService.restore(src, backend="sharded", caps=caps, max_add=4, max_del=4,
                                device="cpu", scheduler=BatchScheduler(**sched))
    for svc in (tr, td):
        assert svc.committed_watermark == jr.committed_watermark == jsvc.committed_watermark
        assert svc.counts() == jr.counts() == jsvc.counts()
        assert svc.journal.tail == jr.journal.tail
    u = sample_update(jsvc.projected_graph(), 2, 2, seed=98)
    for svc in (jsvc, jr):
        svc.ingest(u)
        svc.advance()
    for svc in (tsvc, tr, td):
        svc.ingest(_port_update(u))
        svc.advance()
        assert svc.counts() == jsvc.counts()
        assert all(svc.audit().values())
    _same_service(jr, tr)
    for name in ("tri", "sq"):
        assert _rows(td.backend.matches_plain(name)) == _rows(jr.backend.matches_plain(name))
    with open(os.path.join(src, "meta.json"), "w") as f:
        f.write('{"kind": "repro.stream.snapshot", "version": 9}\n')
    with pytest.raises(ValueError, match="unsupported snapshot version 9"):
        ListingService.restore(src)


def test_forced_plan_swap_equals_jax():
    """PlanManager.reoptimize after a stream that moved the best plan: the
    same SwapEvents (costs, verdicts, counts), the same recompiled plans and
    counters, and counts unchanged by the swap, audited after it."""
    g = random_graph(40, 120, seed=13)
    jsvc, tsvc = _host_pair(g, names=("sq",), j=dict(obs=jstream.Observability.full()),
                            t=dict(obs=tstream.Observability.full()))
    for b in range(3):
        _ingest_both(jsvc, tsvc, 1, 6, seed=300 + b)
    jsvc.advance()
    tsvc.advance()
    before = tsvc.counts()
    jev = jstream.PlanManager(verify=True).reoptimize(jsvc, trigger="manual")
    tev = PlanManager(verify=True).reoptimize(tsvc, trigger="manual")
    assert [_fields(e) for e in tev] == [_fields(e) for e in jev]
    assert any(e.swapped for e in tev)
    assert tsvc.counts() == before == jsvc.counts()
    assert tsvc.backend.plan("sq").plan_key() == jsvc.backend.plan("sq").plan_key()
    assert tsvc.obs.metrics.counter("plan_swaps_total").value == 1
    _same_registry(jsvc, tsvc)
    names = {s.name for r in tsvc.obs.tracer.roots for s in r.walk()}
    assert "plan_swap" in names
    _ingest_both(jsvc, tsvc, 2, 2, seed=310)
    jsvc.advance()
    tsvc.advance()
    assert tsvc.counts() == jsvc.counts() and all(tsvc.audit().values())


def test_ingest_validation_errors_equal_jax():
    g = random_graph(12, 20, seed=17)
    jsvc, tsvc = _host_pair(g, m=2, names=("tri",))
    e = tuple(int(x) for x in g.edges()[0])
    f = tuple(int(x) for x in g.edges()[1])
    absent = next((a, b) for a in range(g.n) for b in range(a + 1, g.n)
                  if not g.has_edges(np.array([a]), np.array([b]))[0])
    cases = [dict(add=[e]), dict(delete=[absent]), dict(delete=[e, e]),
             dict(add=[absent, absent]), dict(delete=[e], add=[e])]
    for kw in cases:
        with pytest.raises(ValueError) as jerr:
            jsvc.ingest(JUpdate.make(**kw))
        with pytest.raises(ValueError) as terr:
            tsvc.ingest(GraphUpdate.make(**kw))
        assert str(terr.value) == str(jerr.value), kw
    for svc, upd in ((jsvc, JUpdate), (tsvc, GraphUpdate)):
        svc.ingest(upd.make(delete=[e, f]))
        with pytest.raises(ValueError, match="delete of absent edge"):
            svc.ingest(add=[], delete=[e])
        svc.ingest(add=[e])
        svc.advance()
    _same_service(jsvc, tsvc)
    with pytest.raises(ValueError, match="unknown backend 'gpu'"):
        ListingService(_port_graph(g), backend="gpu")


def test_sharded_backend_needs_the_card_unless_asked_for_the_cpu():
    g = _port_graph(random_graph(12, 20, seed=17))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ListingService(g, backend="sharded")


# ---------------------------------------------------------------------------
# The device engine's count under the example's patterns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,ord_", [(2, ((2, 3),)), (3, ((2, 3),))])
def test_count_matches_dev_slices_bound_the_pair_masks(k, ord_, monkeypatch):
    """With ``_SLICE_CELLS`` at 4,096, no ``[groups, width, width]`` pair mask
    a count builds passes it (with two compressed vertices, as q5_house's
    store has in examples/torch_subgraph_service.py, it once built the mask
    of every group in a slice sized for one row of it), and the count is
    JAX's."""
    import jax.numpy as jnp
    from repro.dist import jax_engine as jje

    rng = np.random.default_rng(k)
    G, S = 40, 32
    tc = jje.CompTensors(
        skeleton=jnp.asarray(np.stack([np.full(G, 20_000), np.full(G, 20_001)], 1), jnp.int32),
        valid=jnp.ones(G, bool),
        sets={v: jnp.asarray(np.stack([rng.permutation(10_000)[:S] for _ in range(G)]),
                             jnp.int32) for v in range(2, 2 + k)})
    monkeypatch.setattr(tje, "_SLICE_CELLS", 4096)
    seen = []
    for name in ("count_nonzero", "einsum"):
        orig = getattr(torch, name)

        def spy(*args, _orig=orig):
            seen.extend(a.numel() for a in args if isinstance(a, torch.Tensor))
            return _orig(*args)

        monkeypatch.setattr(torch, name, spy)
    got = tje.count_matches_dev(convert.comp_from_numpy(tc, device="cpu"), (0, 1), ord_)
    assert int(got) == int(jje.count_matches_dev(tc, (0, 1), ord_))
    assert seen and max(seen) <= 4096
