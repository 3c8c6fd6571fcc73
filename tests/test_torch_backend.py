"""``TorchBackend`` plugged into the JAX package's ``ListingService`` on the
CPU (``device="cpu"``, the plain versions of the kernels, m = 8), held
against the same service with ``backend="sharded"`` (one CPU device, m = 1)
and against a from-scratch ``DDSL`` at every committed watermark: counts,
``PatternReport``s, ``BatchMetrics`` and materialized row sets. The cases
are those of ``tests/test_stream.py`` for the sharded backend (the 50-batch
stream cut to 25 batches), its failure paths (strict overflow, best effort,
store resize, candidate-cap fallback), the plan swap of
``tests/test_planner.py``, snapshots across backends, and the backend's own
guarantees. Both backends get the same engine caps: the service's own
sizing (``_default_caps``) with smaller listing caps, which keeps the CPU
runs short; every run asserts zero overflow where the original does."""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import random_graph

from repro.core import DDSL, GraphUpdate
from repro.core.estimator import GraphStats
from repro.core.pattern import PATTERN_LIBRARY
from repro.core.storage import build_np_storage
from repro.data.graphs import sample_update
from repro.obs import Observability
from repro.obs.jaxprof import JaxProfiler
from repro.planner import CompileContext, compile_plan
from repro.stream import (BatchScheduler, CountDeltaSink, ListingService, MatchDeltaSink)
from repro.stream.plan_manager import PlanManager
from repro.stream.service import _default_caps
from repro_torch import sharded as tsh
from repro_torch.backend import PatternMeta, PatternReport, TorchBackend
from repro_torch.core.graph import Graph as TGraph
from repro_torch.core.graph import GraphUpdate as TUpdate
from repro_torch.core.pattern import PATTERN_LIBRARY as TLIB
from repro_torch.core.vcbc import CompressedTable
from repro_torch.obs import Observability as TObservability
from repro_torch.obs import ProfiledStep, StepProfiler
from repro_torch.planner import CompiledPlan
from repro_torch.stream import SharedDelta

SMALL = dict(match_cap=512, group_cap=256, set_cap=16, pair_cap=32)
SPECS = {"tri": "q2_triangle", "sq": "q1_square", "k4": "q4_clique4"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(table) -> set:
    return set(map(tuple, np.asarray(table).tolist()))


def _caps(g):
    """The service's own cap sizing for ``g`` at one partition (the JAX
    backend's mesh), with smaller listing caps; both backends get these."""
    c = _default_caps(build_np_storage(g, 1), g, 1, False)
    return dataclasses.replace(c, **SMALL)


def _sched(min_ops=1, max_ops=8):
    return BatchScheduler(min_ops=min_ops, max_ops=max_ops)


def _torch_service(g, names=("tri",), sched=None, obs=None, max_add=4, max_del=4, **kw):
    be = TorchBackend(g, m=8, caps=_caps(g), max_add=max_add, max_del=max_del,
                      device="cpu", **kw)
    svc = ListingService(g, backend=be, scheduler=sched or _sched(), obs=obs)
    for name in names:
        svc.register(name, PATTERN_LIBRARY[SPECS[name]])
    return svc


def _jax_service(g, names=("tri",), sched=None, max_add=4, max_del=4, **kw):
    svc = ListingService(g, backend="sharded", caps=_caps(g), scheduler=sched or _sched(),
                         max_add=max_add, max_del=max_del, **kw)
    for name in names:
        svc.register(name, PATTERN_LIBRARY[SPECS[name]])
    return svc


def _stream(svcs, rounds, d, a, seed0):
    """Ingest the same sampled updates into every service."""
    for b in range(rounds):
        upd = sample_update(svcs[0].projected_graph(), d, a, seed=seed0 + b)
        for svc in svcs:
            svc.ingest(upd)


def _scratch(svc, name):
    fresh = DDSL(svc.graph, svc.backend.meta(name).pattern, m=4)
    fresh.initial()
    return fresh


def _same_state(tsvc, jsvc=None):
    """At the committed watermark: counts, last batch metrics and reports,
    and each pattern's rows equal between the two services (where the
    sharded one is given) and DDSL."""
    for name in tsvc.patterns():
        fresh = _scratch(tsvc, name)
        assert fresh.count() == tsvc.count(name)
        assert _rows(tsvc.backend.matches_plain(name)) == _rows(fresh.matches_plain())
    if jsvc is None:
        return
    assert tsvc.committed_watermark == jsvc.committed_watermark
    assert tsvc.counts() == jsvc.counts()
    assert {int(c) for c in tsvc.graph.codes} == {int(c) for c in jsvc.graph.codes}
    if jsvc.metrics:
        tb, jb = tsvc.metrics[-1], jsvc.metrics[-1]
        for f in ("lo", "hi", "n_ops", "net_add", "net_delete", "storage_overflow",
                  "cand_vertices", "cand_edges", "overflow"):
            assert getattr(tb, f) == getattr(jb, f), f
        assert tb.patterns.keys() == jb.patterns.keys()
        for name, jr in jb.patterns.items():
            tr = tb.patterns[name]
            assert isinstance(tr, PatternReport)
            for f in ("count_before", "count_after", "patch_groups", "removed_groups",
                      "overflow"):
                assert getattr(tr, f) == getattr(jr, f), (name, f)
    for name in tsvc.patterns():
        assert _rows(tsvc.backend.matches_plain(name)) == _rows(
            jsvc.backend.matches_plain(name))


# ---------------------------------------------------------------------------
# Streams: torch = sharded = DDSL at every committed watermark
# ---------------------------------------------------------------------------

N_STREAM_BATCHES = 25


def test_stream_of_25_batches_equals_sharded_and_scratch():
    """Two patterns over 25 micro-batches (the 50-batch stream of
    tests/test_stream.py cut to 25), one storage step and one megastep a
    batch; overflow 0, candidate counters per batch and bounded, and a
    match sink's row deltas equal the sharded backend's."""
    g = random_graph(20, 45, seed=13)
    sched = lambda: BatchScheduler(max_ops=4, min_ops=1)  # noqa: E731
    tsvc = _torch_service(g, ("tri", "sq"), sched=sched())
    jsvc = _jax_service(g, ("tri", "sq"), sched=sched())
    tsink, jsink = tsvc.subscribe(MatchDeltaSink()), jsvc.subscribe(MatchDeltaSink())
    dcap = tsvc.backend.caps.deg_cap
    batches, b = 0, 0
    while batches < N_STREAM_BATCHES:
        _stream([tsvc, jsvc], 1, 2, 2, seed0=2000 + b)
        done = tsvc.advance()
        assert len(jsvc.advance()) == len(done)
        batches += len(done)
        b += 1
        _same_state(tsvc, jsvc)
    assert all(bm.overflow == 0 for bm in tsvc.metrics)
    for bm in tsvc.metrics:
        net = bm.net_add + bm.net_delete
        if net:
            assert 0 < bm.cand_vertices <= 2 * net * (dcap + 1)
            assert 0 < bm.cand_edges <= 2 * net * dcap
        else:
            assert bm.cand_vertices == -1 and bm.cand_edges == -1
    for attr in ("added", "removed"):
        got = [(p, hi, _rows(r)) for p, hi, r in getattr(tsink, attr)]
        want = [(p, hi, _rows(r)) for p, hi, r in getattr(jsink, attr)]
        assert got == want
    assert tsink.added and tsink.removed


def test_wcoj_stream_restore_and_install_equal_sharded():
    """executor="wcoj" (q2_triangle and q4_clique4 on the generic join,
    stores of plain rows, no carry): batches equal the sharded backend's;
    then q4_clique4 is removed and restored from its own table, and the
    stream goes on exact."""
    g = random_graph(16, 50, seed=21)
    tsvc = _torch_service(g, ("tri", "k4"), executor="wcoj")
    jsvc = _jax_service(g, ("tri", "k4"), executor="wcoj")
    for name in ("tri", "k4"):
        assert tsvc.backend.plan(name).executor == "wcoj"
        assert tsvc.backend.entries[name].carry == {}
    assert tsvc.counts()["k4"] > 0
    _same_state(tsvc, jsvc)
    for r in range(3):
        _stream([tsvc, jsvc], 1, 2, 2, seed0=31 + r)
        tsvc.advance()
        jsvc.advance()
        _same_state(tsvc, jsvc)
    be = tsvc.backend
    table = be.materialize("k4")
    meta = be.meta("k4")
    be.remove_pattern("k4")
    assert be.restore_pattern("k4", meta.pattern, meta.cover, table) == jsvc.count("k4")
    for r in range(2):
        _stream([tsvc, jsvc], 1, 2, 2, seed0=41 + r)
        tsvc.advance()
        jsvc.advance()
        _same_state(tsvc, jsvc)
    assert all(tsvc.audit().values())


def test_same_watermark_install_reuses_the_carry():
    """remove_pattern then install_plan with the pattern's own plan and
    table at the same watermark reuses the stashed unit-table carry (no
    cold refresh) and the next batch stays exact."""
    g = random_graph(18, 35, seed=51)
    tsvc = _torch_service(g, ("sq",))
    be = tsvc.backend
    plan, table = be.plan("sq"), be.materialize("sq")
    count, misses = tsvc.count("sq"), _counter(tsvc, "unit_cache_misses_total")
    be.remove_pattern("sq")
    assert be.install_plan("sq", plan, table) == count
    assert _counter(tsvc, "plan_swap_carry_reuses_total") == 1
    assert _counter(tsvc, "unit_cache_misses_total") == misses
    _stream([tsvc], 1, 2, 2, seed0=7)
    tsvc.advance()
    _same_state(tsvc)


# ---------------------------------------------------------------------------
# No-op windows and per-batch metrics
# ---------------------------------------------------------------------------

def _absent_edges(graph, k, seed=0):
    rng = np.random.default_rng(seed)
    existing = set(map(tuple, graph.edges().tolist()))
    out = set()
    while len(out) < k:
        a, b = int(rng.integers(graph.n)), int(rng.integers(graph.n))
        if a != b and (min(a, b), max(a, b)) not in existing:
            out.add((min(a, b), max(a, b)))
    return sorted(out)


def _counter(svc, name):
    return svc.obs.metrics.counter(name).value


def test_noop_window_moves_only_the_watermark():
    """Adds and deletes netting to nothing: the watermark moves, no
    storage update runs, counts and reports stay, the audit passes."""
    g = random_graph(18, 35, seed=37)
    svcs = [_torch_service(g, sched=_sched(4, 64)), _jax_service(g, sched=_sched(4, 64))]
    edges = _absent_edges(svcs[0].projected_graph(), 2, seed=7)
    for svc in svcs:
        svc.ingest(GraphUpdate.make(add=edges))
        svc.ingest(GraphUpdate.make(delete=edges))
        before = dict(svc.counts())
        svc.advance()
        bm = svc.metrics[-1]
        assert svc.committed_watermark == svc.journal.tail
        assert _counter(svc, "stream_storage_updates_total") == 0
        assert _counter(svc, "stream_delta_decodes_total") >= 1
        assert bm.net_add == 0 and bm.net_delete == 0
        assert bm.cand_vertices == -1 and bm.storage_overflow == 0
        assert svc.counts() == before
        for rep in bm.patterns.values():
            assert rep.count_before == rep.count_after
        assert all(svc.audit().values())
    _same_state(*svcs)


def test_per_batch_metrics_reset_each_batch():
    """Candidate counters and overflow are per batch: a small batch after
    a big one reports its own bounded numbers, a no-op batch none."""
    g = random_graph(18, 35, seed=41)
    tsvc = _torch_service(g, sched=_sched(1, 64), max_add=8, max_del=8)
    dcap = tsvc.backend.caps.deg_cap
    out = []
    for seed, k in ((43, 4), (44, 1)):
        tsvc.ingest(sample_update(tsvc.projected_graph(), k, k, seed=seed))
        tsvc.advance()
        _same_state(tsvc)
        out.append(tsvc.metrics[-1])
    big, small = out
    assert 0 < big.cand_vertices <= 2 * 8 * (dcap + 1)
    assert 0 < small.cand_vertices <= 2 * 2 * (dcap + 1)
    edges = _absent_edges(tsvc.projected_graph(), 2, seed=45)
    tsvc.ingest(GraphUpdate.make(add=edges))
    tsvc.ingest(GraphUpdate.make(delete=edges))
    tsvc.advance(watermark=tsvc.journal.tail)
    noop = tsvc.metrics[-1]
    assert noop.cand_vertices == -1 and noop.cand_edges == -1
    assert noop.storage_overflow == 0 and noop.overflow == 0
    assert all(tsvc.audit().values())
    _same_state(tsvc)


# ---------------------------------------------------------------------------
# Matches stay on the device; a match sink pulls them
# ---------------------------------------------------------------------------

def test_count_only_batches_pull_no_match_bytes():
    """With no match-row subscriber a batch pulls scalars only: zero host
    bytes and zero materializations; materialize is the only host path."""
    g = random_graph(18, 35, seed=51)
    svc = _torch_service(g, ("tri", "sq"))
    svc.subscribe(CountDeltaSink())
    _stream([svc], 4, 2, 2, seed0=53)
    svc.advance()
    assert len(svc.metrics) >= 2
    assert all(bm.host_bytes == 0 for bm in svc.metrics)
    assert _counter(svc, "stream_host_materializations_total") == 0
    assert svc.backend.total_host_bytes == 0
    assert all(svc.audit().values())
    assert svc.backend.total_host_bytes == 0
    for name in ("tri", "sq"):
        assert _rows(_scratch(svc, name).matches_plain()) == _rows(
            svc.backend.matches_plain(name))
    assert svc.backend.total_host_bytes > 0
    assert _counter(svc, "stream_host_materializations_total") == 2
    assert _counter(svc, "host_transfer_bytes_total") == svc.backend.total_host_bytes


def test_match_sink_triggers_lazy_materialization():
    """A wants_matches sink makes the subscribed pattern's rows travel:
    host bytes > 0 on every batch with a net effect, and the row deltas
    replay to the final match set."""
    g = random_graph(18, 35, seed=55)
    svc = _torch_service(g)
    before_rows = _rows(svc.backend.matches_plain("tri"))
    deltas = svc.subscribe(MatchDeltaSink(patterns=["tri"]))
    _stream([svc], 3, 2, 2, seed0=57)
    svc.advance()
    nonempty = [bm for bm in svc.metrics if bm.net_add + bm.net_delete]
    assert nonempty and all(bm.host_bytes > 0 for bm in nonempty)
    rows = set(before_rows)
    by_hi: dict = {}
    for _, hi, r in deltas.removed:
        by_hi.setdefault(hi, [set(), set()])[0] |= _rows(r)
    for _, hi, r in deltas.added:
        by_hi.setdefault(hi, [set(), set()])[1] |= _rows(r)
    for hi in sorted(by_hi):
        rem, add = by_hi[hi]
        rows -= rem
        rows |= add
    assert rows == _rows(svc.backend.matches_plain("tri"))


# ---------------------------------------------------------------------------
# Failure paths
# ---------------------------------------------------------------------------

def _doctored_maintain(be, name="tri", extra=5, store_extra=0):
    """Wrap the backend's megastep so one pattern's diag reports extra
    (store) overflow."""
    orig = be.maintain_step

    def overflowing_step(pt2, stores, carries, dirty, add, dele):
        stores2, patches, carries2, diag = orig(pt2, stores, carries, dirty, add, dele)
        d = dict(diag[name])
        d["overflow"] = d["overflow"] + extra
        d["store_overflow"] = d["store_overflow"] + store_extra
        return stores2, patches, carries2, {**diag, name: d}

    return overflowing_step


def _partitions(be):
    return {f.name: getattr(be.pt, f.name).clone() for f in dataclasses.fields(be.pt)}


def _same_partitions(be, snap):
    return all(torch.equal(getattr(be.pt, k), v) for k, v in snap.items())


def test_strict_overflow_aborts_batch_and_stays_usable():
    """A maintain overflow in strict mode raises before the batch commits;
    the committed partitions are byte-equal to their value before it, the
    stores are rebuilt from them, and the same batch then replays exactly."""
    g = random_graph(18, 35, seed=61)
    svc = _torch_service(g, strict_overflow=True)
    be = svc.backend
    orig = be.maintain_step
    count0 = svc.count("tri")
    pt0 = _partitions(be)
    be.maintain_step = _doctored_maintain(be)
    _stream([svc], 1, 2, 2, seed0=63)
    with pytest.raises(RuntimeError, match="overflowed device caps"):
        svc.advance()
    assert _same_partitions(be, pt0)
    assert svc.committed_watermark == 0
    assert svc.count("tri") == count0
    assert be.entries["tri"].store is not None
    assert all(svc.audit().values())
    assert be.matches_plain("tri").shape[1] == 3
    assert _rows(be.matches_plain("tri")) == _rows(_scratch(svc, "tri").matches_plain())
    be.maintain_step = orig
    svc.advance()
    assert svc.committed_watermark == svc.journal.tail
    assert all(svc.audit().values())
    assert not _same_partitions(be, pt0)


def test_strict_storage_overflow_raises_before_commit():
    """A storage-step overflow in strict mode raises before any store
    moves; the partitions are untouched and the undoctored backend
    retries the batch."""
    g = random_graph(18, 35, seed=61)
    svc = _torch_service(g, strict_overflow=True)
    be = svc.backend
    be.ushapes = tsh.UpdateShapes(n_add=4, n_del=4)
    orig_storage = be.storage_step
    pt0 = _partitions(be)

    def overflowing_storage(pt, add, dele):
        pt2, diag = orig_storage(pt, add, dele)
        return pt2, {**diag, "overflow": diag["overflow"] + 3}

    be.storage_step = overflowing_storage
    _stream([svc], 1, 2, 2, seed0=63)
    with pytest.raises(RuntimeError, match="storage update overflowed"):
        svc.advance()
    assert _same_partitions(be, pt0) and svc.committed_watermark == 0
    be.storage_step = orig_storage
    svc.advance()
    assert svc.committed_watermark == svc.journal.tail
    assert all(svc.audit().values())


def test_best_effort_mode_downgrades_overflow_to_metric():
    """Engine-cap overflow in best-effort mode stays a counted metric; no
    resize is tried."""
    g = random_graph(18, 35, seed=61)
    svc = _torch_service(g, strict_overflow=False)
    svc.backend.maintain_step = _doctored_maintain(svc.backend)
    _stream([svc], 1, 2, 2, seed0=63)
    svc.advance()
    assert svc.metrics[-1].overflow >= 5
    assert svc.backend.store_resizes == 0
    assert svc.committed_watermark == svc.journal.tail


def test_store_overflow_auto_resizes_and_retries():
    """A store overflow in best-effort mode heals: caps ×2, stores rebuilt
    from the committed partitions, megastep rebuilt (shedding the doctored
    wrapper), the batch retried once, and the stream stays exact."""
    g = random_graph(18, 35, seed=61)
    svc = _torch_service(g)
    jsvc = _jax_service(g)
    be = svc.backend
    e = be.entries["tri"]
    be.maintain_step = _doctored_maintain(be, extra=3, store_extra=3)
    g0, s0 = e.store_caps.group_cap, e.store_caps.set_cap
    _stream([svc, jsvc], 1, 2, 2, seed0=63)
    svc.advance()
    jsvc.advance()
    assert be.store_resizes == 1
    assert (e.store_caps.group_cap, e.store_caps.set_cap) == (2 * g0, 2 * s0)
    assert svc.metrics[-1].overflow == 0
    assert svc.committed_watermark == svc.journal.tail
    assert _counter(svc, "sharded_store_resizes_total") == 1
    _same_state(svc, jsvc)
    _stream([svc, jsvc], 1, 2, 2, seed0=64)
    svc.advance()
    jsvc.advance()
    _same_state(svc, jsvc)


def test_estimator_cap_overflow_falls_back_and_retries():
    """Candidate caps far below the batch's candidate set: nothing commits,
    the backend falls back for good to the never-overflow caps (one
    rebuilt storage step), retries the same batch and stays exact."""
    g = random_graph(18, 35, seed=71)
    svc = _torch_service(g)
    be = svc.backend
    be.ushapes = be._sharded.UpdateShapes(n_add=4, n_del=4, cand_cap=2, cedge_cap=2)
    be.storage_step = be._sharded.make_storage_update_step(
        be.mesh, be.caps, be.ushapes, mode=be.update_mode)
    _stream([svc], 2, 2, 2, seed0=73)
    svc.advance()
    assert be.cap_fallbacks == 1
    assert be.ushapes.cand_cap is None
    assert svc.committed_watermark == svc.journal.tail
    assert all(bm.storage_overflow == 0 for bm in svc.metrics)
    assert _counter(svc, "sharded_cap_fallbacks_total") == 1
    _same_state(svc)


# ---------------------------------------------------------------------------
# Plan swaps and snapshots
# ---------------------------------------------------------------------------

def test_plan_manager_drift_swap_end_to_end():
    """The drift-triggered swap of tests/test_planner.py through the port:
    materialize → recompress → stack_matches → carry, audited from
    scratch after every swap (verify=True)."""
    g = random_graph(32, 90, seed=3)
    p = PATTERN_LIBRARY["q1_square"]
    pm = PlanManager(drift_threshold=0.0, recost_every=0, verify=True)
    be = TorchBackend(g, m=8, caps=_caps(g), device="cpu")
    svc = ListingService(g, backend=be, plan_manager=pm, obs=Observability.full())
    svc.register("sq", p)
    for b in range(12):
        svc.ingest(sample_update(svc.projected_graph(), 1, 3, seed=100 + b))
        svc.advance()
    assert any(e.swapped for e in pm.events)
    fresh = DDSL(svc.graph, p)
    fresh.initial()
    assert svc.count("sq") == fresh.count()
    assert svc.obs.metrics.counter("plan_swaps_total").value >= 1
    dump = svc.obs.plans["sq"]
    assert dump == be.plan("sq").to_json() and isinstance(be.plan("sq"), CompiledPlan)
    names = {s.name for r in svc.obs.tracer.roots for s in r.walk()}
    assert {"storage_update", "maintain_mega", "maintain", "plan_swap"} <= names


def test_plan_dump_equals_jax_compile_plan():
    """The plan the service records for each pattern is JAX's compile_plan
    on the backend's machine shape (m = 8, its caps and store headroom):
    the same JSON dump but the passes' times."""
    g = random_graph(18, 35, seed=51)
    tsvc = _torch_service(g, ("sq", "tri"))

    def bare(d):
        return {**d, "passes": [{k: v for k, v in p.items() if k != "elapsed_ms"}
                                for p in d["passes"]]}

    for name in ("sq", "tri"):
        meta = tsvc.backend.meta(name)
        assert isinstance(meta, PatternMeta)
        want = compile_plan(CompileContext(pattern=PATTERN_LIBRARY[SPECS[name]],
                                           stats=GraphStats.of(g), m=8, caps=_caps(g)))
        assert bare(tsvc.obs.plans[name]) == bare(want.to_json())
        assert meta.plan.plan_key() == want.plan_key()


@pytest.mark.parametrize("direction", ["host_to_torch", "torch_to_host"])
def test_snapshot_restores_across_backends(direction, tmp_path):
    """A host-backend snapshot restores into TorchBackend and a
    TorchBackend snapshot into the host backend: equal counts, then two
    more batches on each side, equal counts and rows and audits."""
    g = random_graph(18, 35, seed=101)
    specs = ("tri", "sq")
    if direction == "host_to_torch":
        src = ListingService(g, m=2, backend="host", scheduler=BatchScheduler(max_ops=4))
        for name in specs:
            src.register(name, PATTERN_LIBRARY[SPECS[name]])
    else:
        src = _torch_service(g, specs, sched=BatchScheduler(max_ops=4))
    _stream([src], 2, 2, 2, seed0=103)
    src.advance()
    snap = str(tmp_path / "snap")
    src.snapshot(snap)
    if direction == "host_to_torch":
        be = TorchBackend(src.graph, m=8, caps=_caps(src.graph), device="cpu")
        dst = ListingService.restore(snap, backend=be, scheduler=BatchScheduler(max_ops=4))
        assert isinstance(dst.backend.materialize("sq"), CompressedTable)
    else:
        dst = ListingService.restore(snap, backend="host", m=2,
                                     scheduler=BatchScheduler(max_ops=4))
    assert dst.counts() == src.counts()
    assert dst.committed_watermark == src.committed_watermark
    for b in range(2):
        _stream([src, dst], 1, 2, 2, seed0=105 + b)
        src.advance()
        dst.advance()
        assert dst.counts() == src.counts()
    for name in specs:
        assert _rows(dst.backend.matches_plain(name)) == _rows(src.backend.matches_plain(name))
    assert all(dst.audit().values()) and all(src.audit().values())


# ---------------------------------------------------------------------------
# The backend's own guarantees
# ---------------------------------------------------------------------------

def test_default_jax_observability_never_profiles_a_torch_step(monkeypatch):
    """A service with a default JAX Observability (whose JaxProfiler is on)
    resolves that profiler for every wrapped step; the port's steps never
    hand themselves to it and run directly."""
    def refuse(self, step, *args):
        raise AssertionError(f"JaxProfiler._call reached with {step.name}")

    monkeypatch.setattr(JaxProfiler, "_call", refuse)
    g = random_graph(18, 35, seed=51)
    svc = _torch_service(g, ("tri", "sq"))
    assert isinstance(svc.obs, Observability) and svc.obs.jaxprof.enabled
    assert svc.backend._jaxprof() is svc.obs.jaxprof
    _stream([svc], 2, 2, 2, seed0=53)
    svc.advance()
    assert len(svc.metrics) >= 1 and all(svc.audit().values())
    assert svc.obs.jaxprof.steps == {}


def test_profiled_step_calls_only_the_ports_profiler():
    """ProfiledStep hands itself to a StepProfiler that is on, and calls
    the step directly for a disabled one, for None and for any other
    object."""
    seen = []

    class Recording(StepProfiler):
        def _call(self, step, *args):
            seen.append(step.name)
            return step.fn(*args)

    prof = Recording()
    holder = {"p": prof}
    step = ProfiledStep("s", lambda x: x + 1, lambda: holder["p"])
    assert step(1) == 2 and seen == ["s"]
    prof.enabled = False
    assert step(2) == 3 and seen == ["s"]
    for other in (None, object(), JaxProfiler(enabled=True)):
        holder["p"] = other
        assert step(3) == 4
    assert seen == ["s"]
    obs = TObservability()
    assert isinstance(obs.jaxprof, StepProfiler) and obs.jaxprof.enabled
    assert TObservability.disabled().jaxprof.enabled is False


def test_standalone_backend_grows_its_own_observability():
    """Driven without a service, the backend makes the port's default
    Observability and counts into it."""
    g = random_graph(18, 35, seed=51)
    tg = TGraph._from_codes(g.n, g.codes)
    be = TorchBackend(tg, m=8, caps=_caps(g), max_add=4, max_del=4, device="cpu")
    assert be.caps.use_kernels is False
    n0 = be.register("tri", TLIB["q2_triangle"])
    upd = sample_update(g, 2, 2, seed=9)
    u = TUpdate(delete=np.asarray(upd.delete), add=np.asarray(upd.add))
    rep = be.apply_batch(SharedDelta(lo=0, hi=4, update=u, add_codes=u.add_codes(),
                                     delete_codes=u.delete_codes()), set())
    assert isinstance(be.obs, TObservability)
    fresh = DDSL(g.apply_update(upd), PATTERN_LIBRARY["q2_triangle"], m=4)
    fresh.initial()
    assert rep["tri"].count_before == n0 and rep["tri"].count_after == fresh.count()
    assert be.obs.metrics.counter("unit_cache_misses_total").value > 0


def test_cuda_is_required_unless_asked_for_the_cpu():
    g = random_graph(18, 35, seed=51)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchBackend(g, m=8, caps=_caps(g))
