"""The port's step profiler (``repro_torch.obs.prof``) against the JAX
package's ``repro.obs.jaxprof``.

Eager PyTorch has no ahead-of-time lowering, so the port books the first
call of each wrapped step as its compile and every later call as a steady
execution (the reference's pre-AOT heuristic, ``heuristic`` set); JAX's AOT
path books the compile apart and counts the first execution as a call. So
on one stream the port's ``compiles`` equal JAX's, and the port's
``compiles + calls`` equal JAX's ``calls``. Held here: the twins of
``tests/test_obs.py``'s profiler cases on torch functions, the port's
service (``TorchBackend`` on the CPU) against JAX's ``ShardedBackend`` on
one stream (step names, counts, span skeletons, the exported profile), the
store-resize rewrap, and ``torch.profiler`` capture windows."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from conftest import random_graph

from repro import stream as jstream
from repro.data.graphs import sample_update
from repro.core.pattern import PATTERN_LIBRARY as JLIB
from repro.core.storage import build_np_storage as jbuild
from repro.stream.service import _default_caps
from repro_torch.backend import TorchBackend
from repro_torch.core.graph import Graph, GraphUpdate
from repro_torch.core.pattern import PATTERN_LIBRARY
from repro_torch.data.graphs import sample_update as port_sample_update
from repro_torch.obs import MetricsRegistry, Observability, ProfiledStep, StepProfile, StepProfiler
from repro_torch.obs.prof import tensor_bytes
from repro_torch.stream import BatchScheduler, ListingService

SMALL = dict(match_cap=512, group_cap=256, set_cap=16, pair_cap=32)
STEPS = {"storage_update", "maintain_mega", "list:tri", "init_store:tri", "unit_refresh:tri"}


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


def _caps(g):
    """The JAX service's own cap sizing at one partition with smaller
    listing caps (as tests/test_torch_service.py sizes them)."""
    return dataclasses.replace(_default_caps(jbuild(g, 1), g, 1, False), **SMALL)


def _port_service(g, sched, obs=None):
    """The port's ListingService over a TorchBackend on the CPU at one
    partition, as JAX's ShardedBackend runs on the one CPU device."""
    be = TorchBackend(_port_graph(g), m=1, caps=_caps(g), max_add=4, max_del=4, device="cpu")
    return ListingService(_port_graph(g), backend=be, scheduler=BatchScheduler(**sched),
                          obs=obs)


def _counters_equal_records(prof, reg):
    for name, rec in prof.steps.items():
        assert reg.get("step_compiles_total").value_for(step=name) == rec.compiles
        assert reg.get("step_execute_calls_total").value_for(step=name) == rec.calls
        assert reg.get("step_compile_seconds_total").value_for(step=name) \
            == pytest.approx(rec.compile_seconds)
        assert reg.get("step_execute_seconds_total").value_for(step=name) \
            == pytest.approx(rec.execute_seconds)
        for f in ("output_size_in_bytes", "alias_size_in_bytes"):
            assert reg.get(f"step_{f}").value_for(step=name) == rec.memory[f]


# ---------------------------------------------------------------------------
# The step split (twins of tests/test_obs.py's JaxProfiler cases)
# ---------------------------------------------------------------------------

def test_profiled_step_splits_first_call_from_steady_calls():
    reg = MetricsRegistry()
    prof = StepProfiler(reg, enabled=True)
    step = ProfiledStep("toy", lambda x: x * 2 + 1, lambda: prof)
    x = torch.arange(8)
    for _ in range(3):
        assert torch.equal(step(x), x * 2 + 1)
    rec = prof.steps["toy"]
    assert isinstance(rec, StepProfile)
    assert rec.compiles == 1 and rec.calls == 2
    assert rec.heuristic and rec.cost is None
    assert rec.compile_seconds > 0 and rec.execute_seconds > 0
    assert rec.last_execute_s > 0
    assert rec.memory == {"argument_size_in_bytes": 64, "output_size_in_bytes": 64,
                          "alias_size_in_bytes": 0}
    _counters_equal_records(prof, reg)
    assert set(rec.as_dict()) == {f.name for f in dataclasses.fields(StepProfile)}


def test_profiled_step_rewrap_accumulates_under_same_name():
    """Cap fallbacks and store resizes rewrap the step in a NEW ProfiledStep
    under the SAME name: the new wrapper warms up again, into the same
    StepProfile."""
    reg = MetricsRegistry()
    prof = StepProfiler(reg, enabled=True)
    fn = lambda x: x * 2 + 1   # noqa: E731
    s1 = ProfiledStep("toy", fn, lambda: prof)
    s1(torch.arange(8))
    s2 = ProfiledStep("toy", fn, lambda: prof)   # the rewrap
    s2(torch.arange(16))
    rec = prof.steps["toy"]
    assert rec.compiles == 2 and rec.calls == 0
    assert rec.memory["argument_size_in_bytes"] == 128   # the latest warm-up's
    s1(torch.arange(8))
    s2(torch.arange(16))
    assert rec.compiles == 2 and rec.calls == 2
    assert reg.get("step_compiles_total").value_for(step="toy") == 2
    _counters_equal_records(prof, reg)


def test_profiled_step_disable_and_other_profilers_pass_through():
    # disabled profiler → pure passthrough, zero accounting
    off = StepProfiler(None, enabled=False)
    s2 = ProfiledStep("off", lambda x: x - 1, lambda: off)
    out = s2(torch.ones(2))
    assert float(out[0]) == 0.0 and off.steps == {}
    assert not s2._warm
    reg = MetricsRegistry()
    off = StepProfiler(reg, enabled=False)
    ProfiledStep("off", lambda x: x - 1, lambda: off)(torch.ones(2))
    assert off.steps == {} and reg.get("step_compiles_total") is None
    # no profiler at all
    assert float(ProfiledStep("none", lambda x: x + 1, lambda: None)(torch.ones(1))[0]) == 2.0


def test_memory_walk_counts_each_storage_once():
    """Arguments and outputs are walked through tuples, dicts, dataclasses
    and None; a view shares its base's storage; an output that is (a view
    of) an argument is alias bytes."""

    @dataclasses.dataclass
    class Box:
        a: torch.Tensor
        b: dict
        c: object = None

    base = torch.zeros(16, dtype=torch.int32)      # 64 bytes
    other = torch.zeros(4, dtype=torch.int64)      # 32 bytes
    arg = Box(a=base, b={"x": base[:4], "y": other, "z": None}, c=(base[8:], 3, "s"))
    assert tensor_bytes(arg) == 96

    def step(box, k):
        box.a.add_(k)                              # in place, as the megastep
        return box, {"new": torch.ones(3)}, None

    prof = StepProfiler(None)
    ProfiledStep("inplace", step, lambda: prof)(arg, 1)
    mem = prof.steps["inplace"].memory
    assert mem == {"argument_size_in_bytes": 96, "output_size_in_bytes": 96 + 12,
                   "alias_size_in_bytes": 96}
    assert int(base[0]) == 1


# ---------------------------------------------------------------------------
# The port's service against JAX's sharded service on one stream
# ---------------------------------------------------------------------------

def _service_pair(g, sched, obs_j, obs_t):
    jsvc = jstream.ListingService(g, backend="sharded", caps=_caps(g), max_add=4, max_del=4,
                                  scheduler=jstream.BatchScheduler(**sched), obs=obs_j)
    tsvc = _port_service(g, sched, obs_t)
    assert tsvc.register("tri", PATTERN_LIBRARY["q2_triangle"]) == jsvc.register(
        "tri", JLIB["q2_triangle"])
    return jsvc, tsvc


def test_service_profile_equals_jax_sharded_service(tmp_path):
    """random_graph(20, 45, seed=13), q2_triangle, 12 batches through the
    port's ListingService with TorchBackend and through JAX's with
    ShardedBackend: the same step names, the port's compiles equal to JAX's
    and its compiles + calls to JAX's calls, the same span skeleton batch
    for batch, and the exported profile with the same steps and fields."""
    g = random_graph(20, 45, seed=13)
    jsvc, tsvc = _service_pair(g, dict(max_ops=4, min_ops=1), jstream.Observability.full(),
                               Observability.full())
    b = 0
    while len(tsvc.metrics) < 12:
        u = sample_update(jsvc.projected_graph(), 2, 2, seed=1000 + b)
        jsvc.ingest(u)
        tsvc.ingest(_port_update(u))
        b += 1
        jsvc.advance()
        tsvc.advance()
    assert len(jsvc.metrics) == len(tsvc.metrics) == 12
    assert tsvc.counts() == jsvc.counts()
    tprof, jprof = tsvc.obs.jaxprof, jsvc.obs.jaxprof
    assert set(tprof.steps) == set(jprof.steps) == STEPS
    for name in STEPS:
        t, j = tprof.steps[name], jprof.steps[name]
        assert not j.heuristic and t.heuristic
        assert t.compiles == j.compiles >= 1, name
        assert t.compiles + t.calls == j.calls, name
        assert t.compile_seconds > 0 and t.cost is None
        assert t.calls == 0 or t.execute_seconds > 0
        assert set(t.memory) == {"argument_size_in_bytes", "output_size_in_bytes",
                                 "alias_size_in_bytes"}
        assert t.memory["output_size_in_bytes"] > 0
    # one maintain profile per service, with its per-pattern shares
    assert not any(n.startswith("maintain:") for n in tprof.steps)
    assert tprof.steps["maintain_mega"].subs == jprof.steps["maintain_mega"].subs == {"tri": 1.0}
    # the megastep overwrites the store in place: its alias bytes hold it
    store = tensor_bytes(tsvc.backend.entries["tri"].store)
    assert tprof.steps["maintain_mega"].memory["alias_size_in_bytes"] >= store > 0
    _counters_equal_records(tprof, tsvc.obs.metrics)
    # the same span skeleton, batch for batch
    troots, jroots = tsvc.obs.tracer.roots, jsvc.obs.tracer.roots
    assert len(troots) == len(jroots) == 12
    assert [r.skeleton() for r in troots] == [r.skeleton() for r in jroots]
    # device→host bytes keep flowing through _pull with the profiler on
    for svc in (jsvc, tsvc):
        svc.backend.materialize("tri")
    host = tsvc.obs.metrics.get("host_transfer_bytes_total").value
    assert host == jsvc.obs.metrics.get("host_transfer_bytes_total").value > 0
    assert host == tsvc.backend.total_host_bytes
    # the exported profile: the same steps and record fields as JAX's
    tout = tsvc.obs.export(str(tmp_path / "t"), prefix="torch")
    jout = jsvc.obs.export(str(tmp_path / "j"), prefix="jax")
    tdoc = json.loads(open(tout["prof_json"]).read())
    jdoc = json.loads(open(jout["jaxprof_json"]).read())
    assert set(tdoc["steps"]) == set(jdoc["steps"]) == STEPS
    for name in STEPS:
        assert set(tdoc["steps"][name]) == set(jdoc["steps"][name])
        assert tdoc["steps"][name]["compiles"] == jdoc["steps"][name]["compiles"]
    assert tdoc["captured_dirs"] == jdoc["captured_dirs"] == []
    assert tdoc["capture_failures"] == [] and tdoc["capture_pending"] is None


def test_store_resize_recompile_lands_in_same_profile():
    """A store resize rebuilds the fused megastep mid-batch; its warm-up
    must accumulate into the same ``maintain_mega`` StepProfile (same step
    name, no per-pattern entries), with the shares kept."""
    g = random_graph(18, 35, seed=61)
    svc = _port_service(g, dict(min_ops=1, max_ops=8))
    svc.register("tri", PATTERN_LIBRARY["q2_triangle"])
    be = svc.backend
    orig = be.maintain_step

    def overflowing_step(pt2, stores, carries, dirty, add, dele):
        stores2, patches, carries2, diag = orig(pt2, stores, carries, dirty, add, dele)
        d = dict(diag["tri"])
        d["overflow"] = d["overflow"] + 3
        d["store_overflow"] = d["store_overflow"] + 3
        return stores2, patches, carries2, {**diag, "tri": d}

    be.maintain_step = overflowing_step
    svc.ingest(_port_update(sample_update(g, 2, 2, seed=63)))
    svc.advance()
    assert be.store_resizes == 1
    rec = svc.obs.jaxprof.steps["maintain_mega"]
    assert rec.compiles == 2                      # initial + post-resize
    assert rec.compiles + rec.calls >= 2          # overflowing try + retry
    assert rec.subs == {"tri": 1.0}               # sub-attribution survives
    assert not any(n.startswith("maintain:") for n in svc.obs.jaxprof.steps)
    assert svc.obs.metrics.get("step_compiles_total").value_for(step="maintain_mega") == 2
    # the rebuilt stores were listed again: list and init-store warmed up twice
    assert svc.obs.jaxprof.steps["init_store:tri"].compiles == 2
    assert all(svc.audit().values())


def test_default_observability_exports_the_profile(tmp_path):
    g = random_graph(16, 30, seed=5)
    svc = _port_service(g, {})
    svc.register("tri", PATTERN_LIBRARY["q2_triangle"])
    assert svc.obs.jaxprof.enabled and not svc.obs.tracer.enabled
    out = svc.obs.export(str(tmp_path))
    doc = json.loads(open(out["prof_json"]).read())
    assert set(doc["steps"]) == {"list:tri", "init_store:tri", "unit_refresh:tri"}
    assert os.path.basename(out["prof_json"]) == "obs_prof.json"
    off = _port_service(g, {}, Observability.disabled())
    off.register("tri", PATTERN_LIBRARY["q2_triangle"])
    assert off.obs.jaxprof.steps == {}
    assert "prof_json" not in off.obs.export(str(tmp_path / "off"))


# ---------------------------------------------------------------------------
# Capture windows
# ---------------------------------------------------------------------------

def _capture_service(g):
    svc = _port_service(g, dict(min_ops=4, max_ops=4))
    svc.register("tri", PATTERN_LIBRARY["q2_triangle"])
    return svc


def _drive(svc, n_batches, seed0):
    b = 0
    while len(svc.metrics) < n_batches:
        svc.ingest(port_sample_update(svc.projected_graph(), 2, 2, seed=seed0 + b))
        b += 1
        svc.advance()


def test_capture_window_writes_one_trace(tmp_path):
    """A window armed on the second batch writes one Chrome trace of it (the
    CPU activity here), records its directory, and leaves nothing armed."""
    g = random_graph(20, 45, seed=13)
    svc = _capture_service(g)
    logdir = str(tmp_path / "trace")
    svc.obs.jaxprof.arm_capture(logdir, start_batch=1, n_batches=1)
    assert svc.obs.jaxprof.snapshot()["capture_pending"] == {
        "logdir": logdir, "start_batch": 1, "n_batches": 1, "running": False}
    _drive(svc, 3, seed0=500)
    prof = svc.obs.jaxprof
    assert prof.captured_dirs == [logdir]
    files = os.listdir(logdir)
    assert files == ["batches_1-1.pt.trace.json"]
    doc = json.loads(open(os.path.join(logdir, files[0])).read())
    ops = {e["name"] for e in doc["traceEvents"] if e.get("cat") == "cpu_op"}
    assert ops and any(n.startswith("aten::") for n in ops)
    snap = prof.snapshot()
    assert snap["captured_dirs"] == [logdir]
    assert snap["capture_failures"] == [] and snap["capture_pending"] is None


def test_capture_that_cannot_start_disarms_visibly(tmp_path):
    """torch.profiler does not nest: a window whose batch starts while
    another session runs disarms, writes nothing, and says so in the
    snapshot; a window never reached stays pending there."""
    from torch.profiler import ProfilerActivity, profile

    g = random_graph(20, 45, seed=13)
    svc = _capture_service(g)
    logdir = str(tmp_path / "nested")
    svc.obs.jaxprof.arm_capture(logdir, start_batch=0, n_batches=2)
    with profile(activities=[ProfilerActivity.CPU]) as outer:
        _drive(svc, 2, seed0=600)
    assert outer.key_averages()   # the outer session was left running
    snap = svc.obs.jaxprof.snapshot()
    assert snap["captured_dirs"] == [] and snap["capture_pending"] is None
    (fail,) = snap["capture_failures"]
    assert fail["logdir"] == logdir and fail["start_batch"] == 0 and fail["n_batches"] == 2
    assert "another torch.profiler session" in fail["error"]
    assert not os.path.exists(logdir)
    late = str(tmp_path / "late")
    svc.obs.jaxprof.arm_capture(late, start_batch=99)
    _drive(svc, 3, seed0=700)
    assert svc.obs.jaxprof.snapshot()["capture_pending"]["start_batch"] == 99
    assert not os.path.exists(late)
