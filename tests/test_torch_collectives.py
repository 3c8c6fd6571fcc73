"""The port's collectives and compression (``repro_torch.dist``) against
JAX's (``repro/dist/collectives.py``, ``compression.py``): 8 gloo ranks,
one partition a rank, against ``shard_map`` on 8 fake CPU devices, and the
same functions on a ``LocalMesh(8)`` in this process. Inputs are those of
``tests/spmd/run_collectives.py`` (numpy seed 0: 32 rows a device, 80 %
valid), at a bucket capacity of 16 and at 3, which overflows.

Tolerances: the exchanges, their valid masks, overflow counters and the
int32 ring sum exactly; the float32 ring sum within 1e-6 of max |sum|
(measured: bit-equal, the hops add in JAX's order); the compressed
butterfly bit for bit; ``ef_compress`` bit for bit against JAX's in one
process.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO, SRC

N, R, CAPS = 8, 32, (16, 3)

_INPUTS = r'''
import numpy as np
N, R, CAPS = 8, 32, (16, 3)
rng = np.random.default_rng(0)
rows = rng.integers(0, 1000, (N, R, 2)).astype(np.int32)
targets = rng.integers(0, N, (N, R)).astype(np.int32)
valid = rng.random((N, R)) < 0.8
x = rng.normal(size=(N, 16)).astype(np.float32)
xi = rng.integers(-2**31, 2**31 - 1, (N, 16)).astype(np.int32)   # sums wrap
'''

# Per device: for each capacity the bucketed exchange (rows, valid,
# overflow) and the routed exchange of the valid rows (rows, valid,
# restored x2, overflow); the ring sums of x and xi; the butterfly of x.
_JAX = _INPUTS + r'''
import sys
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.dist.collectives import bucketed_all_to_all, routed_exchange, ring_all_reduce
from repro.dist.compression import butterfly_compressed_all_reduce

mesh = jax.make_mesh((N,), ("d",), axis_types=(jax.sharding.AxisType.Auto,))
out = {}

def smap(body, n_in, n_out):
    return jax.shard_map(body, mesh=mesh, in_specs=(P("d"),) * n_in,
                         out_specs=(P("d"),) * n_out if n_out > 1 else P("d"),
                         check_vma=False)

for cap in CAPS:
    def b1(r, t, v):
        (rec,), rv, ovf = bucketed_all_to_all([r[0]], t[0], v[0], "d", N, cap)
        return rec[None], rv[None], ovf[None]
    res = smap(b1, 3, 3)(jnp.asarray(rows), jnp.asarray(targets), jnp.asarray(valid))
    for k, a in zip(("rows", "valid", "overflow"), res):
        out[f"a2a_{cap}_{k}"] = np.asarray(a)
    def b2(r, t, v):
        (rec,), rv, restore, ovf = routed_exchange([r[0]], t[0], v[0], "d", N, cap)
        return rec[None], rv[None], restore(rec * 2)[None], ovf[None]
    res = smap(b2, 3, 4)(jnp.asarray(rows), jnp.asarray(targets), jnp.asarray(valid))
    for k, a in zip(("rows", "valid", "restored", "overflow"), res):
        out[f"routed_{cap}_{k}"] = np.asarray(a)
out["ring_f32"] = np.asarray(smap(lambda v: ring_all_reduce(v[0], "d", N)[None], 1, 1)(
    jnp.asarray(x)))
out["ring_i32"] = np.asarray(smap(lambda v: ring_all_reduce(v[0], "d", N)[None], 1, 1)(
    jnp.asarray(xi)))
out["butterfly"] = np.asarray(smap(
    lambda v: butterfly_compressed_all_reduce(v[0], "d", N)[None], 1, 1)(jnp.asarray(x)))
np.savez(sys.argv[1], **out)
'''

_PORT = _INPUTS + r'''
import torch
from repro_torch.dist import (bucketed_all_to_all, butterfly_compressed_all_reduce,
                              ring_all_reduce, routed_exchange)

def run(mesh):
    """Every function on the mesh's partitions; per partition its results,
    stacked in mesh.indices() order."""
    ids = list(mesh.indices())
    t = lambda a: [torch.from_numpy(np.ascontiguousarray(a[i])) for i in ids]
    out = {}
    for cap in CAPS:
        rec, rv, ovf = bucketed_all_to_all([[r] for r in t(rows)], t(targets), t(valid),
                                           mesh, cap)
        out[f"a2a_{cap}_rows"] = [r[0] for r in rec]
        out[f"a2a_{cap}_valid"] = rv
        out[f"a2a_{cap}_overflow"] = [ovf.reshape(1)] * len(ids)
        rec, rv, restore, ovf = routed_exchange([[r] for r in t(rows)], t(targets), t(valid),
                                                mesh, cap)
        out[f"routed_{cap}_rows"] = [r[0] for r in rec]
        out[f"routed_{cap}_valid"] = rv
        out[f"routed_{cap}_restored"] = restore([r[0] * 2 for r in rec])
        out[f"routed_{cap}_overflow"] = [ovf.reshape(1)] * len(ids)
    out["ring_f32"] = ring_all_reduce(t(x), mesh)
    out["ring_i32"] = ring_all_reduce(t(xi), mesh)
    out["butterfly"] = butterfly_compressed_all_reduce(t(x), mesh)
    return {k: torch.stack(v).numpy() for k, v in out.items()}
'''

_RANK = _PORT + r'''
import os, sys
from repro_torch.launch.mesh import init_process_mesh
out = sys.argv[1]
mesh = init_process_mesh(N, "cpu", timeout_s=60, init_method=f"file://{out}/store")
np.savez(f"{out}/rank{mesh.rank}.npz", **run(mesh))
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on 8 fake devices and the port on 8 gloo ranks, side by side,
    and the port on a LocalMesh(8) here."""
    from repro_torch.mesh import LocalMesh

    tmp = str(tmp_path_factory.mktemp("collectives"))
    env = _env()
    env.update(XLA_FLAGS=f"--xla_force_host_platform_device_count={N}", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, f"{tmp}/jax.npz"], env=env,
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)]
    for r in range(N):
        env = _env()
        env.update(RANK=str(r), WORLD_SIZE=str(N))
        procs.append(subprocess.Popen([sys.executable, "-c", _RANK, tmp], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    try:
        ns = {}
        exec(_PORT, ns)
        local = ns["run"](LocalMesh(N))
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"{so}\n{se[-4000:]}"
    jx = dict(np.load(f"{tmp}/jax.npz"))
    ranks = [np.load(f"{tmp}/rank{r}.npz") for r in range(N)]
    mesh = {k: np.concatenate([z[k] for z in ranks]) for k in ranks[0].files}
    return jx, mesh, local


def _exact(jx, port, key):
    got, want = port[key].reshape(want_shape := jx[key].shape), jx[key]
    assert got.dtype == want.dtype or key.endswith("overflow"), (key, got.dtype, want.dtype)
    assert np.array_equal(got.astype(want.dtype), want), key
    return want_shape


@pytest.mark.parametrize("mesh_kind", ["process", "local"])
@pytest.mark.parametrize("cap", CAPS)
def test_bucketed_and_routed_exchange_equal_jax(runs, mesh_kind, cap):
    jx, mesh, local = runs
    port = mesh if mesh_kind == "process" else local
    for key in ("rows", "valid", "overflow"):
        _exact(jx, port, f"a2a_{cap}_{key}")
    for key in ("rows", "valid", "restored", "overflow"):
        _exact(jx, port, f"routed_{cap}_{key}")
    ovf = int(jx[f"a2a_{cap}_overflow"].reshape(-1)[0])
    # capacity 16 holds every bucket; 3 drops rows, counted the same on every device
    assert (ovf == 0) if cap == 16 else (ovf > 0), ovf
    assert len(set(jx[f"a2a_{cap}_overflow"].reshape(-1).tolist())) == 1


@pytest.mark.parametrize("mesh_kind", ["process", "local"])
def test_ring_all_reduce_equal_jax(runs, mesh_kind):
    jx, mesh, local = runs
    port = mesh if mesh_kind == "process" else local
    _exact(jx, port, "ring_i32")
    got, want = port["ring_f32"], jx["ring_f32"]
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    ns = {}
    exec(_INPUTS, ns)
    # the int32 sum wraps as psum's does
    assert all(np.array_equal(s, ns["xi"].sum(axis=0, dtype=np.int32)) for s in jx["ring_i32"])


@pytest.mark.parametrize("mesh_kind", ["process", "local"])
def test_butterfly_compressed_all_reduce_bit_equal_jax(runs, mesh_kind):
    jx, mesh, local = runs
    port = mesh if mesh_kind == "process" else local
    assert np.array_equal(port["butterfly"], jx["butterfly"])
    # every device ends with the same tensor, within a few percent of the sum
    assert all(np.array_equal(jx["butterfly"][0], b) for b in jx["butterfly"])
    ns = {}
    exec(_INPUTS, ns)
    want = ns["x"].sum(axis=0)
    assert np.abs(jx["butterfly"][0] - want).max() / np.abs(want).max() < 0.05


def test_butterfly_needs_a_power_of_two():
    from repro_torch.dist import butterfly_compressed_all_reduce
    from repro_torch.mesh import LocalMesh

    with pytest.raises(ValueError, match="power-of-two"):
        butterfly_compressed_all_reduce([torch.zeros(4)] * 6, LocalMesh(6))


def test_ef_compress_bit_equal_jax_and_drift_bound():
    """Twenty steps of error feedback (the loop of test_substrates.py's
    ``test_ef_compression_error_feedback``): every q, scale and residual
    bit for bit JAX's, and the decoded running sum within that test's
    bound of the true sum."""
    import jax.numpy as jnp
    from repro.dist.compression import ef_compress as jef, ef_residual_init as jinit
    from repro_torch.dist import ef_compress, ef_residual_init

    rng = np.random.default_rng(0)
    g0 = rng.normal(size=(256,)).astype(np.float32)
    res = ef_residual_init({"w": torch.from_numpy(g0), "b": [torch.zeros(3)]})
    jres = jinit({"w": jnp.asarray(g0), "b": [jnp.zeros(3)]})
    assert res["w"].dtype == torch.float32 and res["b"][0].shape == (3,)
    decoded_sum = np.zeros(256)
    true_sum = np.zeros(256)
    for _ in range(20):
        g = rng.normal(size=(256,)).astype(np.float32)
        b = rng.normal(size=(3,)).astype(np.float32) * 1e-3
        true_sum += g
        q, s, res = ef_compress({"w": torch.from_numpy(g), "b": [torch.from_numpy(b)]}, res)
        jq, js, jres = jef({"w": jnp.asarray(g), "b": [jnp.asarray(b)]}, jres)
        for got, want in ((q["w"], jq["w"]), (s["w"], js["w"]), (res["w"], jres["w"]),
                          (q["b"][0], jq["b"][0]), (s["b"][0], js["b"][0]),
                          (res["b"][0], jres["b"][0])):
            assert np.array_equal(got.numpy(), np.asarray(want))
        assert q["w"].dtype == torch.int8
        decoded_sum += q["w"].numpy().astype(np.float32) * float(s["w"])
    drift = np.abs(decoded_sum - true_sum).max()
    assert drift <= 2 * float(s["w"]) + np.abs(res["w"].numpy()).max() + 1e-6
