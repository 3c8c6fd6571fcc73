"""The port's steps and service on a ``ProcessMesh`` of gloo ranks on the
CPU, byte for byte against the one-process ``LocalMesh`` run and against
JAX's steps on 8 fake devices.

Each test spawns its ranks as subprocesses (``RANK`` / ``WORLD_SIZE`` in
the environment, a file rendezvous, a 60 s process-group timeout and a
subprocess timeout); every rank saves what it holds, and the test joins
the ranks' partition slices in rank order. Inputs: ``run.EXAMPLE_Q1``
(``rmat_graph(7, 320, seed=0)``, m = 8, 4 + 4 edge batches drawn from
seeds 100, 101). Tolerance 0: every tensor and counter is an integer.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, SRC

# Leaves of nested dataclasses / dicts / lists as int64 arrays, dict keys
# sorted (the order of test_torch_spmd.py's comparison).
_LEAVES = r'''
import dataclasses
import numpy as np
import torch

def leaves(x):
    if dataclasses.is_dataclass(x):
        return [l for f in dataclasses.fields(x) for l in leaves(getattr(x, f.name))]
    if isinstance(x, dict):
        return [l for k in sorted(x, key=str) for l in leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [l for v in x for l in leaves(v)]
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x).astype(np.int64)]

def save(path, stages):
    flat = {}
    for s, (label, ls) in enumerate(stages):
        flat[f"label_{s}"] = np.asarray(label)
        for i, a in enumerate(ls):
            flat[f"{s}_{i:04d}"] = a
    np.savez(path, **flat)
'''

# Stage 1 (list, init store and carry refresh of every pattern) and two
# batches (storage update, megastep) of a Pipeline, each step's outputs
# and diag recorded.
_DRIVE = _LEAVES + r'''
def drive(pipe, batches=2):
    stages = []
    stores, carries = {}, {}
    for name, p in pipe.plans.items():
        root, ld = p.list_step(pipe.pt)
        stores[name], idg = p.init_step(root)
        carries[name], rd = p.refresh_step(pipe.pt)
        stages.append((f"stage1 {name}", leaves((pipe.pt, root, ld, stores[name], idg,
                                                 carries[name], rd))))
    for b in range(batches):
        upd = pipe.next_update()
        add = torch.from_numpy(upd.add.astype(np.int32).reshape(-1, 2)).to(pipe.device)
        dele = torch.from_numpy(upd.delete.astype(np.int32).reshape(-1, 2)).to(pipe.device)
        pipe.pt, sd = pipe.storage_step(pipe.pt, add, dele)
        out = pipe.maintain_step(pipe.pt, stores, carries, sd["part_dirty"], add, dele)
        stores, carries = out[0], out[2]
        pipe.graph = pipe.graph.apply_update(upd)
        pipe.batches += 1
        stages.append((f"batch {b}", leaves((pipe.pt, sd, out))))
    return stages
'''

_RANK = _DRIVE + r'''
import os, sys
from repro_torch.launch.mesh import init_process_mesh
from repro_torch.run import EXAMPLE_Q1, Pipeline

mode, out = sys.argv[1], sys.argv[2]
if "RANK" in os.environ:
    rank = int(os.environ["RANK"])
    mesh = init_process_mesh(8, "cpu", timeout_s=60, init_method=f"file://{out}/store")
    assert mesh.indices() == range(rank * mesh.local, (rank + 1) * mesh.local)
    name = f"rank{rank}"
else:                   # the reference: the same run on a LocalMesh
    rank, mesh, name = 0, None, "local"
if mode == "steps":
    cfg = eval(sys.argv[3])
    save(f"{out}/{name}.npz", drive(Pipeline(cfg, "cpu", use_kernels=False, mesh=mesh)))
elif mode == "service":
    import pickle
    exec(sys.argv[3])
    with open(f"{out}/{name}.pkl", "wb") as f:
        pickle.dump(service(mesh, rank, out), f)
'''

# The service at m = 8 with the listing caps of test_torch_imports.py, a
# MatchDeltaSink on both patterns (materialize and removed rows on every
# batch), three 4 + 4 updates in batches of 8 ops, a snapshot restored on every
# rank with one more update, and the
# agreement check (on a process mesh, a rank with other store caps makes
# it raise on every rank).
_SERVICE = r'''
def service(mesh, rank, out):
    from dataclasses import replace
    from repro_torch.core.pattern import PATTERN_LIBRARY
    from repro_torch.data.graphs import rmat_graph, sample_update
    from repro_torch.engine import EngineCaps
    from repro_torch.run import EXAMPLE_Q1 as c
    from repro_torch.stream import BatchScheduler, ListingService, MatchDeltaSink
    caps = EngineCaps(v_cap=c.v_cap, deg_cap=c.deg_cap, e_cap=c.e_cap, match_cap=2048,
                      group_cap=1024, set_cap=c.set_cap, pair_cap=128)
    kw = {} if mesh is None else {"mesh": mesh}
    svc = ListingService(rmat_graph(7, 320, seed=0), backend="sharded", caps=caps,
                         max_add=8, max_del=8, device="cpu",
                         scheduler=BatchScheduler(max_ops=8), **kw)
    counts = [svc.register(n, PATTERN_LIBRARY[n]) for n in ("q1_square", "q2_triangle")]
    sink = svc.subscribe(MatchDeltaSink())
    for b in range(3):
        svc.ingest(sample_update(svc.projected_graph(), 4, 4, seed=100 + b))
    rec = [counts]
    for bm in svc.advance():
        rec.append([bm.lo, bm.hi, bm.n_ops, bm.net_add, bm.net_delete, bm.overflow,
                    bm.storage_overflow, bm.host_bytes, bm.cand_vertices, bm.cand_edges,
                    bm.cache_hits, bm.cache_misses, bm.invalidated_parts,
                    [[r.count_before, r.count_after, r.patch_groups, r.removed_groups,
                      r.overflow] for _, r in sorted(bm.patterns.items())]])
    rows = [np.sort(a, axis=0) for n in ("q1_square", "q2_triangle")
            for a in (sink.added_rows(n), sink.removed_rows(n))]
    table = svc.backend.materialize("q1_square")
    snap = f"{out}/snap{rank}"
    svc.snapshot(snap)
    be = svc.backend
    res = {"records": rec, "rows": rows, "skeleton": table.skeleton,
           "comp": {v: (r.offsets, r.values) for v, r in table.comp.items()},
           "snapshot": [os.path.exists(f"{snap}/meta.json"), os.path.exists(snap)],
           "agree_checks": be.agree_checks, "check": None}
    # every rank restores rank 0's snapshot (its stores stacked from the
    # tables, each rank its own shards) and takes one more update
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()
    back = ListingService.restore(f"{out}/snap0", backend="sharded", caps=caps, max_add=8,
                                  max_del=8, device="cpu",
                                  scheduler=BatchScheduler(max_ops=8), **kw)
    back.ingest(sample_update(back.projected_graph(), 4, 4, seed=103))
    res["restored"] = [back.committed_watermark, [bm.patterns["q1_square"].count_after
                                                   for bm in back.advance()], back.counts()]
    if mesh is not None:
        e = be.entries["q2_triangle"]
        if rank == 1:
            e.store_caps = replace(e.store_caps, set_cap=2 * e.store_caps.set_cap)
        try:
            be._check_ranks_agree("under test")
            res["check"] = "agreed"
        except RuntimeError as err:
            res["check"] = str(err).split(":")[0]
    return res
'''


# The same stages through JAX's steps on 8 fake devices, the port's
# Pipeline supplying the plans (as in test_torch_spmd.py) and the updates.
_JAX = _LEAVES + r'''
import sys
import jax
from jax.sharding import NamedSharding
from repro.core import build_np_storage
from repro.data.graphs import rmat_graph
from repro.dist import jax_engine as jje, sharded as jsh
from repro_torch.run import EXAMPLE_Q1, Pipeline

cfg = dataclasses.replace(EXAMPLE_Q1, more_patterns=("q2_triangle",))
pipe = Pipeline(cfg, "cpu", use_kernels=False)
mesh = jax.make_mesh((cfg.m,), ("data",))
jc = jje.EngineCaps(**{k: v for k, v in dataclasses.asdict(pipe.caps).items()
                       if k != "use_kernels"}, use_pallas=False)
g = rmat_graph(cfg.n_log2, cfg.n_edges, seed=cfg.graph_seed)
pt = jsh.stack_partitions(build_np_storage(g, cfg.m), jc)
pt = jax.device_put(pt, jax.tree.map(lambda s: NamedSharding(mesh, s),
                                     jsh.partition_specs(mesh)))
stages, stores, carries, specs = [], {}, {}, []
for name, p in pipe.plans.items():
    root, ld = jsh.make_list_step(p.prog, mesh, jc)(pt)
    stores[name], idg = jsh.make_init_store_step(p.prog, mesh, jc, p.store_caps)(root)
    carries[name], rd = jsh.make_unit_refresh_step(p.prog, p.units, mesh, jc, p.unit_caps)(pt)
    stages.append((f"stage1 {name}", leaves((pt, root, ld, stores[name], idg,
                                             carries[name], rd))))
    specs.append(jsh.MaintainSpec(name=name, prog=p.prog, units=p.units, store=p.store_caps,
                                  unit_caps=p.unit_caps))
sstep = jsh.make_storage_update_step(mesh, jc, jsh.UpdateShapes(
    **dataclasses.asdict(pipe.ushapes)))
mega = jsh.make_maintain_mega_step(specs, mesh, jc)
for b in range(2):
    upd = pipe.next_update()
    add = jax.numpy.asarray(upd.add.astype(np.int32).reshape(-1, 2))
    dele = jax.numpy.asarray(upd.delete.astype(np.int32).reshape(-1, 2))
    pt, sd = sstep(pt, add, dele)
    out = mega(pt, stores, carries, sd["part_dirty"], add, dele)
    stores, carries = out[0], out[2]
    pipe.graph = pipe.graph.apply_update(upd)
    pipe.batches += 1
    stages.append((f"batch {b}", leaves((pt, sd, out))))
save(sys.argv[1], stages)
'''


def _env():
    """Every spawned process single-threaded: the ranks and the reference
    run side by side."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    return env


def _start(world: int, args, out: str):
    """Start ``world`` ranks of ``_RANK`` with ``args`` in the background;
    ``world`` 0 starts the one-process ``LocalMesh`` reference instead."""
    os.makedirs(out, exist_ok=True)
    procs = []
    for r in range(max(world, 1)):
        env = _env()
        if world:
            env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen([sys.executable, "-c", _RANK, args[0], out, *args[1:]],
                                      env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def _wait(procs, timeout: float = 600) -> None:
    """Every process must exit 0 within ``timeout`` seconds."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} of {len(procs)}:\n{so}\n{se[-4000:]}"


def _joined(world: int, out: str):
    return _join([_load(f"{out}/rank{r}.npz") for r in range(world)])


def _load(path):
    z = np.load(path)
    stages = []
    s = 0
    while f"label_{s}" in z:
        n = sum(1 for k in z.files if k.startswith(f"{s}_"))
        stages.append((str(z[f"label_{s}"]), [z[f"{s}_{i:04d}"] for i in range(n)]))
        s += 1
    return stages


def _join(ranks):
    """The ranks' stages with every partition-stacked leaf concatenated in
    rank order; a 0-d leaf (a summed counter) must be equal on every rank."""
    out = []
    for s, (label, first) in enumerate(ranks[0]):
        joined = []
        for i, a in enumerate(first):
            parts = [r[s][1][i] for r in ranks]
            if a.ndim == 0:
                assert all(int(p) == int(a) for p in parts), (label, i, parts)
                joined.append(a)
            else:
                joined.append(np.concatenate(parts, axis=0))
        out.append((label, joined))
    return out


def _same(got, want):
    assert [l for l, _ in got] == [l for l, _ in want]
    for (label, a), (_, b) in zip(got, want):
        assert len(a) == len(b), label
        for i, (x, y) in enumerate(zip(a, b)):
            assert x.shape == y.shape and np.array_equal(x, y), f"{label}: leaf {i} differs"


_STEPS_CFG = 'dataclasses.replace(EXAMPLE_Q1, more_patterns=("q2_triangle",))'
# caps that drop listing rows, groups and set values at every step
_SMALL_CFG = "dataclasses.replace(EXAMPLE_Q1, match_cap=64, group_cap=32, set_cap=4, pair_cap=4)"


def test_process_mesh_world8_equals_jax_on_8_devices(tmp_path):
    """World 8, one partition a rank (JAX's layout): stage 1 and two
    batches of the q1_square + q2_triangle megastep equal JAX's steps on 8
    fake devices, partitions, listings, stores, carries, patches and every
    diag counter. JAX runs beside the ranks, in its own process."""
    env = _env()
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    want_path = str(tmp_path / "jax.npz")
    jx = subprocess.Popen([sys.executable, "-c", _JAX, want_path], env=env, cwd=REPO,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = str(tmp_path / "mesh")
    _wait(_start(8, ["steps", _STEPS_CFG], out) + [jx], timeout=900)
    _same(_joined(8, out), _load(want_path))


@pytest.fixture(scope="module")
def steps_runs(tmp_path_factory):
    """Worlds 4 and 2 and the LocalMesh(8) reference, side by side."""
    out = {w: str(tmp_path_factory.mktemp(f"world{w}")) for w in (4, 2, 0)}
    _wait([p for w, o in out.items() for p in _start(w, ["steps", _STEPS_CFG], o)])
    return _load(f"{out[0]}/local.npz"), {w: _joined(w, out[w]) for w in (4, 2)}


@pytest.mark.parametrize("world", [4, 2])
def test_process_mesh_steps_equal_local_mesh(world, steps_runs):
    """World 4 x 2 and 2 x 4 partitions: stage 1 and two batches of the
    q1_square + q2_triangle megastep equal the LocalMesh(8) run."""
    want, got = steps_runs
    _same(got[world], want)


def test_undersized_caps_overflow_equal_on_the_mesh(tmp_path):
    """Caps that overflow: the counters are nonzero and equal to the
    LocalMesh run's, every store and carry equal as well."""
    _wait(_start(2, ["steps", _SMALL_CFG], str(tmp_path / "mesh"))
          + _start(0, ["steps", _SMALL_CFG], str(tmp_path / "local")))
    want = _load(f"{tmp_path}/local/local.npz")
    _same(_joined(2, str(tmp_path / "mesh")), want)
    # the summed counters of stage 1 and of the last batch
    for label, ls in (want[0], want[-1]):
        assert any(int(a) > 0 for a in ls if a.ndim == 0), f"no overflow counted in {label}"


def test_service_on_two_ranks_equals_local_service(tmp_path):
    """ListingService(backend="sharded", mesh=...) at world 2: the same
    BatchMetrics counts, added / removed rows and materialized table as the
    LocalMesh service; rank 0 alone writes the snapshot, which both ranks
    restore (each stacking its own shards) and take one more update on, to
    the LocalMesh service's counts; a rank holding other store caps makes
    the agreement check raise on both ranks."""
    import pickle

    out = str(tmp_path / "mesh")
    _wait(_start(2, ["service", _SERVICE], out)
          + _start(0, ["service", _SERVICE], str(tmp_path / "local")))
    got = []
    for path in (f"{out}/rank0.pkl", f"{out}/rank1.pkl", f"{tmp_path}/local/local.pkl"):
        with open(path, "rb") as f:
            got.append(pickle.load(f))
    want = got.pop()
    assert len(want["records"]) > 3
    for r, g in enumerate(got):
        assert g["records"] == want["records"], r
        assert all(np.array_equal(a, b) for a, b in zip(g["rows"], want["rows"])), r
        assert np.array_equal(g["skeleton"], want["skeleton"])
        assert g["comp"].keys() == want["comp"].keys()
        for v, (o, vals) in want["comp"].items():
            assert np.array_equal(g["comp"][v][0], o) and np.array_equal(g["comp"][v][1], vals)
        # two registrations and one check a batch
        assert g["agree_checks"] == 2 + len(want["records"]) - 1, g["agree_checks"]
        assert g["check"] == "the mesh's ranks disagree under test", g["check"]
    assert want["snapshot"] == got[0]["snapshot"] == [True, True]
    assert got[1]["snapshot"] == [False, False]
    assert want["agree_checks"] == 0 and want["check"] is None
    assert got[0]["restored"] == got[1]["restored"] == want["restored"], want["restored"]
    assert want["restored"][0] == 24 and len(want["restored"][1]) == 1
