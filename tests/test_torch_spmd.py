"""The port at m = 8 against the JAX steps on 8 fake CPU devices: stage 1
plus three stage-2 batches, byte for byte (slow: a subprocess that
compiles the JAX steps for an 8-device mesh)."""

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

for pname in ("q1_square", "q2_triangle"):
    cfg = dataclasses.replace(EXAMPLE_Q1, pattern=pname)
    pipe = Pipeline(cfg, "cpu", use_kernels=False)
    mesh = jax.make_mesh((cfg.m,), ("data",))
    jc = jje.EngineCaps(**{k: v for k, v in dataclasses.asdict(pipe.caps).items()
                           if k != "use_kernels"}, use_pallas=False)
    ush = jsh.UpdateShapes(**dataclasses.asdict(pipe.ushapes))
    g = rmat_graph(cfg.n_log2, cfg.n_edges, seed=cfg.graph_seed)
    jpt = jsh.stack_partitions(build_np_storage(g, cfg.m), jc)
    jpt = jax.device_put(jpt, jax.tree.map(lambda s: NamedSharding(mesh, s),
                                           jsh.partition_specs(mesh)))
    same(jpt, pipe.pt, "partitions")
    jroot, jd = jsh.make_list_step(pipe.prog, mesh, jc)(jpt)
    troot, td = pipe.list_step(pipe.pt)
    same((jroot, jd), (troot, td), "list step")
    jst, jd = jsh.make_init_store_step(pipe.prog, mesh, jc, pipe.store_caps)(jroot)
    pipe.store, td = pipe.init_step(troot)
    same((jst, jd), (pipe.store, td), "init store")
    sstep = jsh.make_storage_update_step(mesh, jc, ush)
    mstep = jsh.make_maintain_step(pipe.prog, pipe.units, mesh, jc, pipe.store_caps)
    for b in range(3):
        upd = pipe.next_update()
        add, dele = upd.add.astype(np.int32), upd.delete.astype(np.int32)
        jpt, jsd = sstep(jpt, jnp.asarray(add), jnp.asarray(dele))
        jst, jpatch, jmd = mstep(jpt, jst, jnp.asarray(add), jnp.asarray(dele))
        d = pipe.apply(upd)
        same(jpt, pipe.pt, f"batch {b} partitions")
        same(jst, pipe.store, f"batch {b} store")
        assert int(jmd["count"]) == int(d["count"]), b
        assert int(jsd["overflow"]) + int(jmd["overflow"]) == int(d["overflow"]) == 0
        assert int(jsd["cand_edges"]) == int(d["cand_edges"]), b
    print(f"{pname}: m=8 port == JAX steps over 3 batches, count {int(d['count'])}")
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
