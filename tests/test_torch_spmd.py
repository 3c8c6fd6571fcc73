"""The port at m = 8 against the JAX steps on 8 fake CPU devices: stage 1
(with the unit-table carries) plus three stage-2 batches of q1_square and
q2_triangle in one megastep, byte for byte against JAX's megastep and its
per-pattern maintain steps, and the full storage update against JAX's
(slow: a subprocess that compiles the JAX steps for an 8-device mesh)."""

import os
import subprocess
import sys

import pytest

from conftest import REPO, SRC

_M8_SCRIPT = r'''
import dataclasses
import numpy as np
import jax, jax.numpy as jnp, torch
from jax.sharding import NamedSharding
from repro.core import build_np_storage
from repro.dist import jax_engine as jje, sharded as jsh
from repro.data.graphs import rmat_graph
from repro_torch import sharded as tsh
from repro_torch.run import EXAMPLE_Q1, Pipeline

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

# q1_square and q2_triangle maintained by one pipeline, whose megastep
# carries both patterns' unit tables
cfg = dataclasses.replace(EXAMPLE_Q1, more_patterns=("q2_triangle",))
pipe = Pipeline(cfg, "cpu", use_kernels=False)
names = list(pipe.plans)
mesh = jax.make_mesh((cfg.m,), ("data",))
jc = jje.EngineCaps(**{k: v for k, v in dataclasses.asdict(pipe.caps).items()
                       if k != "use_kernels"}, use_pallas=False)
ush = jsh.UpdateShapes(**dataclasses.asdict(pipe.ushapes))
g = rmat_graph(cfg.n_log2, cfg.n_edges, seed=cfg.graph_seed)
jpt = jsh.stack_partitions(build_np_storage(g, cfg.m), jc)
jpt = jax.device_put(jpt, jax.tree.map(lambda s: NamedSharding(mesh, s),
                                       jsh.partition_specs(mesh)))
same(jpt, pipe.pt, "partitions")
jst, jcarry, jsteps, specs = {}, {}, {}, []
for name, p in pipe.plans.items():
    jroot, jd = jsh.make_list_step(p.prog, mesh, jc)(jpt)
    troot, td = p.list_step(pipe.pt)
    same((jroot, jd), (troot, td), f"{name} list step")
    jst[name], jd = jsh.make_init_store_step(p.prog, mesh, jc, p.store_caps)(jroot)
    tst, td = p.init_step(troot)
    same((jst[name], jd), (tst, td), f"{name} init store")
    jcarry[name], jd = jsh.make_unit_refresh_step(p.prog, p.units, mesh, jc, p.unit_caps)(jpt)
    assert int(jd["overflow"]) == 0
    jsteps[name] = jsh.make_maintain_step(p.prog, p.units, mesh, jc, p.store_caps)
    specs.append(jsh.MaintainSpec(name=name, prog=p.prog, units=p.units, store=p.store_caps,
                                  unit_caps=p.unit_caps))
pipe.initial()
same((jst, jcarry), (pipe.stores, pipe.carries), "stage 1 stores and carries")
jmega_st = {n: jax.tree.map(jnp.copy, s) for n, s in jst.items()}
sstep = jsh.make_storage_update_step(mesh, jc, ush)
sfull = jsh.make_storage_update_step(mesh, jc, ush, mode="full")
jmega = jsh.make_maintain_mega_step(specs, mesh, jc)
tfull = tsh.make_storage_update_step(pipe.mesh, pipe.caps, pipe.ushapes, mode="full")
seen = {}
inner = pipe.maintain_step
def spy(*args):
    seen["out"] = inner(*args)
    return seen["out"]
pipe.maintain_step = spy
for b in range(3):
    upd = pipe.next_update()
    add, dele = upd.add.astype(np.int32), upd.delete.astype(np.int32)
    ja, jd_ = jnp.asarray(add), jnp.asarray(dele)
    same(sfull(jpt, ja, jd_), tfull(pipe.pt, torch.from_numpy(add), torch.from_numpy(dele)),
         f"batch {b} full storage update")
    jpt, jsd = sstep(jpt, ja, jd_)
    want = jmega(jpt, jmega_st, jcarry, jsd["part_dirty"], ja, jd_)
    jmega_st, jcarry = want[0], want[2]
    d = pipe.apply(upd)
    same(jpt, pipe.pt, f"batch {b} partitions")
    same(want, seen["out"], f"batch {b} megastep")
    for name in names:
        jst[name], _, jmd = jsteps[name](jpt, jst[name], ja, jd_)
        same(jst[name], pipe.stores[name], f"batch {b} {name} store")
        assert int(jmd["count"]) == d["patterns"][name]["count"], (b, name)
        assert int(jmd["overflow"]) == int(d["patterns"][name]["overflow"]) == 0
    assert int(jsd["overflow"]) == int(d["storage_overflow"]) == int(d["overflow"]) == 0
    assert int(jsd["cand_edges"]) == int(d["cand_edges"]), b
for name in names:
    print(f"{name}: m=8 port == JAX steps over 3 batches, count "
          f"{d['patterns'][name]['count']}, refreshes {d['patterns'][name]['unit_refreshes']}")
'''


@pytest.mark.slow
def test_m8_steps_byte_equal_to_jax_on_8_devices():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", _M8_SCRIPT], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    assert out.stdout.count("m=8 port == JAX steps") == 2
