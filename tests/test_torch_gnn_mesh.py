"""GNN training on a two-axis ("data", "model") grid: the port against JAX on the CPU.

- ``param_specs``, ``graph_specs``, the ZeRO-1 moment specs and the padded
  node and edge counts equal JAX's (``param_specs``, ``graph_specs``,
  ``_zero1_specs`` / ``_fix_spec``, ``_gnn_counts``) for the four GNNs at
  ``(1, 1)``, ``(2, 2)``, ``(4, 1)`` and ``(1, 4)`` (``AbstractMesh``: no
  devices needed).
- On 4 gloo ranks at ``(2, 2)``, beside JAX on ``make_local_mesh(2, 2)``
  over 4 fake CPU devices: rank ``d·M + m`` holds JAX device ``(d, m)``'s
  node and edge rows (``convert.graph_shard``; ``graph_unshard`` puts the
  shards back together); each primitive (the gather and the segment sum, each
  with and without the channel split) and its gradient from a random
  cotangent against the one-process function on the whole arrays;
  ``forward(mesh=)`` of the four smoke configs against JAX's
  ``forward(mesh=)`` fed as ``tests/spmd/run_gnn_dist.py`` feeds it
  (EquiformerV2 in 8 edge chunks); two steps of ``gnn_train_step`` on a
  train graph built with ``mesh=`` against ``_gnn_cell``'s step for the
  four smoke configs on ``molecule`` and ``full_graph_sm`` at their smoke
  sizes, float32, padded nodes and edges included: the loss, the norm,
  every parameter, both moments and each rank's moment shard against the
  slice JAX's ``NamedSharding`` gives that device.

Tolerances (float32 throughout; the port sums a rank's rows in float64 and
the ranks' sums in float32, JAX in float32 in its own order): a gather is
exact and so is a segment sum's gradient (a gather); a segment sum and a
gather's gradient within 1e-6 of the largest value. Through a model, as
``tests/test_torch_train.py`` holds the one-device port: outputs within
1e-4 of the largest JAX output; loss and gradient norm within 1e-5
relative; each moment within 1e-4 (the second 2e-4) of its leaf's largest
JAX value plus 1e-6 of the model's largest, which covers gradients that
are zero in exact arithmetic (EquiformerV2's last attention bias); each
parameter within 1e-5 of its leaf's largest plus the slack AdamW's division
gives such a gradient gap (``_update_slack``).

Every rank and the JAX program run in subprocesses spawned once for the
module, single-threaded, side by side.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import AbstractMesh

from conftest import REPO, SRC
from repro.configs.registry import GNN_SHAPES as J_GNN_SHAPES
from repro.configs.registry import get_arch as j_get_arch
from repro.data.graphs import build_graph_data as j_build_graph_data
from repro.launch.steps import _fix_spec, _gnn_counts, _zero1_specs
from repro.models import gnn as jgnn
from repro_torch.configs import GNN_SHAPES, get_arch
from repro_torch.convert import graph_unshard
from repro_torch.launch import steps
from repro_torch.mesh import GridShape
from repro_torch.models import gnn

ARCHS = ("gatedgcn", "graphsage-reddit", "meshgraphnet", "equiformer-v2")
MESHES = {"1x1": (1, 1), "2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
# the forward cases (tests/spmd/run_gnn_dist.py's configs): N, E before
# padding, and the padded counts
FWD_N, FWD_E, FWD_PAD_N, FWD_PAD_E = 60, 120, 64, 128
FWD_KW = {"gatedgcn": dict(n_layers=2, d_hidden=16, d_in=8, d_out=4),
          "graphsage-reddit": dict(n_layers=2, d_hidden=16, d_in=8, d_out=4),
          "meshgraphnet": dict(n_layers=2, d_hidden=16, d_in=8, d_out=3, d_edge_in=4),
          "equiformer-v2": dict(n_layers=2, d_hidden=8, d_in=6, d_out=2, l_max=2, m_max=1,
                                edge_chunk=16)}
STEP_SHAPES = ("molecule", "full_graph_sm")
STEPS, LR, B1, B2, EPS = 2, 1e-3, 0.9, 0.95, 1e-8   # _gnn_cell's step: adamw_update's defaults
# the primitives: N nodes, E edges a rank, D channels
PRIM_N, PRIM_E, PRIM_D = 32, 24, 6


def _fwd_cfg(arch, lib=gnn):
    kind = j_get_arch(arch).smoke.arch
    return lib.GNNConfig(name=arch, arch=kind, remat=False, **FWD_KW[arch])


def _step_counts(shape_name):
    """``_gnn_cell``'s smoke node and edge counts on 4 devices."""
    js = next(s for s in J_GNN_SHAPES if s.name == shape_name)
    return _gnn_counts(js, 4, True)


def _graph(nodes, edges, d_in, d_edge, seed):
    """A padded graph: 4 padded nodes and 12 padded edges, which point at
    the last node."""
    return j_build_graph_data(nodes - 4, edges - 12, d_in, d_edge=d_edge, seed=seed,
                              pad_nodes=nodes, pad_edges=edges, geometric=True)


def _labels(raw, n, d_out):
    deg = np.bincount(raw["dst"][raw["edge_mask"]], minlength=n)
    return (np.minimum(deg, d_out - 1) if d_out > 1 else deg).astype(np.int32)


# ---------------------------------------------------------------------------
# specs and counts against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_counts_equal_jax(arch, mesh_name):
    sizes, names = MESHES[mesh_name], ("data", "model")
    amesh, grid = AbstractMesh(sizes, names), GridShape(sizes, names)
    for smoke in (False, True):
        jcfg = j_get_arch(arch).smoke if smoke else j_get_arch(arch).config
        cfg = get_arch(arch).smoke if smoke else get_arch(arch).config
        jshapes = jax.eval_shape(lambda: jgnn.init_params(jcfg, jax.random.PRNGKey(0)))
        jspecs = jgnn.param_specs(jcfg, amesh.axis_names)
        jz = _zero1_specs(jspecs, jshapes, amesh)
        specs = gnn.param_specs(cfg, grid.axis_names)
        place = gnn.gnn_placements(cfg, grid)
        assert sorted(specs) == sorted(jspecs) == sorted(place)
        for k, shp in jshapes.items():
            shape = tuple(shp.shape)
            assert gnn.param_shapes(cfg)[k] == shape == place[k].shape, k
            assert specs[k] == tuple(jspecs[k]) == place[k].spec, k
            assert place[k].moment_spec == tuple(_fix_spec(jz[k], shape, amesh)), k
            assert place[k].model_dim is None
    jg, g = jgnn.graph_specs(amesh.axis_names), gnn.graph_specs(grid.axis_names)
    for field in gnn.GraphData.__dataclass_fields__:
        assert getattr(g, field) == tuple(getattr(jg, field)), field
    world = grid.world
    for s, js in zip(GNN_SHAPES, J_GNN_SHAPES):
        assert steps.gnn_counts(s, world) == _gnn_counts(js, world, False), s.name
    assert steps.gnn_counts(get_arch(arch).shape("ogb_products"), 4) == (2_449_032, 123_718_280)


def test_eqv2_chunk_rule_is_jax_s():
    """``eqv2_chunks`` with ``shard_mult`` is ``_eqv2_forward``'s loop."""
    def jax_rule(e_total, edge_chunk, shard_mult):
        n = 1
        while (e_total % (n * 2) == 0 and e_total // (n * 2) >= max(edge_chunk, shard_mult)
               and (e_total // (n * 2)) % shard_mult == 0):
            n *= 2
        return n

    for e, chunk, mult in ((128, 16, 4), (512, 32768, 4), (16384, 4096, 1), (16384, 4096, 4),
                           (96, 8, 3), (123_718_280, 32768, 4), (6, 1, 4)):
        assert gnn.eqv2_chunks(e, chunk, mult) == jax_rule(e, chunk, mult), (e, chunk, mult)
    assert gnn.eqv2_chunks(16384, 32768) == 1 and gnn.eqv2_chunks(16384, 4096) == 4


# ---------------------------------------------------------------------------
# across processes: JAX on 4 fake devices, the port on 4 gloo ranks
# ---------------------------------------------------------------------------

_JAX = r'''
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, sys.argv[2])
from test_torch_gnn_mesh import ARCHS, STEP_SHAPES, STEPS, _fwd_cfg
from repro.configs.registry import get_arch
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import _gnn_cell
from repro.models import gnn as jgnn
from repro.optim import adamw_init

tmp = sys.argv[1]
mesh = make_local_mesh(2, 2)
out = {"devices": np.array([[d.id for d in row] for row in mesh.devices])}
specs = jgnn.graph_specs(mesh.axis_names)


def graph(z):
    return jgnn.GraphData(**{k: jnp.asarray(z[k]) for k in jgnn.GraphData.__dataclass_fields__})


# where graph_specs puts each field's rows on each device
z = np.load(f"{tmp}/fwd_gatedgcn.npz")
g_sh = jax.device_put(graph(z), jax.tree.map(lambda sp: NamedSharding(mesh, sp), specs))
for field in jgnn.GraphData.__dataclass_fields__:
    v = getattr(g_sh, field)
    idx = v.sharding.devices_indices_map(v.shape)
    for d in mesh.devices.flat:
        out[f"rows/{field}/{d.id}"] = np.array([idx[d][0].start or 0, idx[d][0].stop or v.shape[0]])

# forward(mesh=), as tests/spmd/run_gnn_dist.py feeds it
for arch in ARCHS:
    cfg = _fwd_cfg(arch, jgnn)
    z = np.load(f"{tmp}/fwd_{arch}.npz")
    params = {k[2:]: jnp.asarray(z[k]) for k in z.files if k.startswith("p/")}
    g_sh = jax.device_put(graph(z), jax.tree.map(lambda sp: NamedSharding(mesh, sp), specs))
    with jax.set_mesh(mesh):
        y = jax.jit(lambda p, gg: jgnn.forward(p, gg, cfg, mesh=mesh))(params, g_sh)
    out[f"fwd/{arch}"] = np.asarray(y)

# two steps of _gnn_cell's step
for arch in ARCHS:
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, smoke=dataclasses.replace(spec.smoke, dtype="float32"))
    for shape_name in STEP_SHAPES:
        case = f"{arch}/{shape_name}"
        z = np.load(f"{tmp}/step_{arch}_{shape_name}.npz")
        prog = _gnn_cell(spec, spec.shape(shape_name), mesh, smoke=True)
        scalar = NamedSharding(mesh, P())
        step = jax.jit(prog.fn, in_shardings=prog.in_shardings,
                       out_shardings=prog.in_shardings[:2] + (scalar, scalar))
        params = {k[2:]: jnp.asarray(z[k]) for k in z.files if k.startswith("p/")}
        params, opt = jax.device_put((params, adamw_init(params)), prog.in_shardings[:2])
        g, labels = graph(z), jnp.asarray(z["labels"])
        for i in range(STEPS):
            params, opt, loss, gnorm = step(params, opt, g, labels)
            out[f"{case}/loss{i}"], out[f"{case}/gnorm{i}"] = np.asarray(loss), np.asarray(gnorm)
            for name, tree in (("p", params), ("mu", opt.mu), ("nu", opt.nu)):
                for k, v in tree.items():
                    out[f"{case}/{name}{i}/{k}"] = np.asarray(v)
        for k, v in opt.mu.items():
            idx = v.sharding.devices_indices_map(v.shape)
            for d in mesh.devices.flat:
                out[f"{case}/mu_index/{k}/{d.id}"] = np.array(
                    [[s.start or 0, n if s.stop is None else s.stop]
                     for s, n in zip(idx[d], v.shape)], np.int64).reshape(-1, 2)
np.savez(f"{tmp}/jax.npz", **out)
'''

_RANK = r'''
import dataclasses, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[2])
from test_torch_gnn_mesh import (ARCHS, PRIM_N, STEP_SHAPES, STEPS, _fwd_cfg)
import torch.distributed as dist
from repro_torch.configs import get_arch
from repro_torch.convert import gnn_params_from_numpy, graph_from_numpy, graph_shard, node_rows
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import init_grid_mesh
from repro_torch.models import gnn

tmp = sys.argv[1]
mesh = init_grid_mesh(2, 2, "cpu", timeout_s=120, init_method=f"file://{tmp}/store")
r = mesh.rank
out = {"coords": np.array([mesh.coord("data"), mesh.coord("model")])}

# where this rank's shard of a graph comes from: its rows, tagged by index
z = np.load(f"{tmp}/fwd_gatedgcn.npz")
tagged = {k: z[k] for k in gnn.GraphData.__dataclass_fields__}
tagged["x"] = np.broadcast_to(np.arange(len(z["x"]), dtype=np.float32)[:, None],
                              z["x"].shape).copy()
tagged["src"] = np.arange(len(z["src"]), dtype=np.int32)
gs = graph_shard(tagged, mesh, device="cpu")
out["rows/x"], out["rows/src"] = gs.x[:, 0].numpy(), gs.src.numpy()
for k, v in vars(graph_shard(z, mesh, device="cpu")).items():
    out[f"shard/{k}"] = v.numpy()

# the primitives against the one-process functions on the whole arrays
z = np.load(f"{tmp}/prims.npz")
n, world = PRIM_N, mesh.world
h_all = torch.from_numpy(z["h"])                      # [N, 3, D]
ids = torch.from_numpy(z["ids"])                       # [world, E] global ids, n = dropped
ct_rows = torch.from_numpy(z["ct_rows"])               # [world, E, 3, D]
ct_nodes = torch.from_numpy(z["ct_nodes"])             # [N, 3 * D]
data_all = torch.from_numpy(z["data"])                 # [world, E, 3 * D]
line = [r2 for r2 in range(world) if r2 // 2 == mesh.coord("data")]
for cs in (False, True):
    tag = "cs" if cs else "plain"
    mine = ids[r]
    gather_ids = mine.clamp(0, n - 1)
    drop = torch.where(mine < n, mine, n).to(torch.int32)
    rows_ids = torch.cat([ids[q] for q in line]) if cs else mine
    g_ids = rows_ids.clamp(0, n - 1)
    g_plan = ops.segment_plan(torch.where(rows_ids < n, rows_ids, n).to(torch.int32), n)
    h = node_rows(z["h"], mesh).copy()
    h = torch.from_numpy(h).requires_grad_()
    y = gnn.mesh_gather_rows(h, g_ids, mesh, plan=g_plan, use_kernels=False, cs=cs)
    (y * ct_rows[r]).sum().backward()
    out[f"prim/{tag}/gather"], out[f"prim/{tag}/gather_grad"] = y.detach().numpy(), h.grad.numpy()
    # one process: every rank's rows from the whole table
    hw = h_all.clone().requires_grad_()
    rows = [hw.index_select(0, ids[q].clamp(0, n - 1)) for q in range(world)]
    keep = [(ids[q] < n)[:, None, None] for q in range(world)]
    want = rows[r]
    sum(((rq * keep[q]) * ct_rows[q]).sum() for q, rq in enumerate(rows)).backward()
    out[f"prim/{tag}/gather_want"], out[f"prim/{tag}/gather_grad_want"] = (
        want.detach().numpy(), node_rows(hw.grad.numpy(), mesh))
    # the segment sum of every rank's rows by their ids
    seg_ids = torch.cat([ids[q] for q in line]) if cs else mine
    s_plan = ops.segment_plan(seg_ids.to(torch.int32), n)
    d = data_all[r].clone().requires_grad_()
    s = gnn.mesh_segment_sum(d, seg_ids.to(torch.int32), s_plan, mesh, use_kernels=False, cs=cs)
    (s * torch.from_numpy(node_rows(ct_nodes.numpy(), mesh))).sum().backward()
    out[f"prim/{tag}/sum"], out[f"prim/{tag}/sum_grad"] = s.detach().numpy(), d.grad.numpy()
    dw = data_all.clone().requires_grad_()
    whole = ops.segment_sum(dw.reshape(-1, dw.shape[-1]), ids.reshape(-1).to(torch.int32), n,
                            use_kernels=False)
    (whole * ct_nodes).sum().backward()
    out[f"prim/{tag}/sum_want"] = node_rows(whole.detach().numpy(), mesh)
    out[f"prim/{tag}/sum_grad_want"] = dw.grad[r].numpy()
    out[f"prim/{tag}/calls"] = np.array(sorted(mesh.calls))
    mesh.reset_counts()
    # use_kernels=True on CPU tensors raises, before any collective
    for name, call in (("gather", lambda: gnn.mesh_gather_rows(h, g_ids, mesh, plan=g_plan,
                                                              use_kernels=True, cs=cs)),
                       ("sum", lambda: gnn.mesh_segment_sum(d, seg_ids.to(torch.int32), s_plan,
                                                            mesh, use_kernels=True, cs=cs))):
        try:
            call()
            out[f"prim/{tag}/{name}_raises"] = False
        except ValueError as exc:
            out[f"prim/{tag}/{name}_raises"] = "needs CUDA tensors" in str(exc)
    assert not mesh.calls, mesh.calls

# forward(mesh=)
for arch in ARCHS:
    cfg = _fwd_cfg(arch)
    z = np.load(f"{tmp}/fwd_{arch}.npz")
    params = gnn_params_from_numpy({k[2:]: z[k] for k in z.files if k.startswith("p/")}, "cpu")
    out[f"fwd/{arch}"] = gnn.forward(params, graph_shard(z, mesh, device="cpu"), cfg,
                                     use_kernels=False, mesh=mesh).numpy()
    # the same forward on one process, all of the graph
    out[f"fwd1/{arch}"] = gnn.forward(params, graph_from_numpy(z, "cpu"), cfg,
                                      use_kernels=False).numpy()

# two steps of gnn_train_step(mesh=)
for arch in ARCHS:
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype="float32")
    for shape_name in STEP_SHAPES:
        case = f"{arch}/{shape_name}"
        z = np.load(f"{tmp}/step_{arch}_{shape_name}.npz")
        params = gnn_params_from_numpy({k[2:]: z[k] for k in z.files if k.startswith("p/")},
                                       "cpu")
        tg = gnn.train_graph(graph_shard(z, mesh, device="cpu"), cfg, mesh=mesh)
        labels = torch.from_numpy(node_rows(z["labels"], mesh).copy())
        opt = steps.gnn_adamw_init(params, cfg, mesh)
        for i in range(STEPS):
            params, opt, loss, gnorm = steps.gnn_train_step(params, opt, tg, labels, cfg,
                                                            use_kernels=False)
            out[f"{case}/loss{i}"], out[f"{case}/gnorm{i}"] = float(loss), float(gnorm)
            for k in params:
                out[f"{case}/p{i}/{k}"] = params[k].numpy().copy()
                out[f"{case}/mu{i}/{k}"] = opt.mu[k].numpy().copy()
                out[f"{case}/nu{i}/{k}"] = opt.nu[k].numpy().copy()
        out[f"{case}/calls"] = np.array(sorted(mesh.calls))
        mesh.reset_counts()
np.savez(f"{tmp}/rank{r}.npz", **out)
dist.destroy_process_group()
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    return env


def _inputs(tmp):
    """The inputs every process reads: JAX's parameters, the graphs and
    labels, the primitives' arrays."""
    for i, arch in enumerate(ARCHS):
        jcfg = _fwd_cfg(arch, jgnn)
        raw = _graph(FWD_PAD_N, FWD_PAD_E, jcfg.d_in, jcfg.d_edge_in, seed=i)
        params = jgnn.init_params(jcfg, jax.random.PRNGKey(1))
        np.savez(f"{tmp}/fwd_{arch}.npz", **raw,
                 **{f"p/{k}": np.asarray(v) for k, v in params.items()})
        jspec = j_get_arch(arch)
        jsmoke = dataclasses.replace(jspec.smoke, dtype="float32")
        for j, shape_name in enumerate(STEP_SHAPES):
            nodes, edges = _step_counts(shape_name)
            raw = _graph(nodes, edges, jsmoke.d_in, jsmoke.d_edge_in, seed=10 * i + j)
            params = jgnn.init_params(jsmoke, jax.random.PRNGKey(0))
            np.savez(f"{tmp}/step_{arch}_{shape_name}.npz", **raw,
                     labels=_labels(raw, nodes, jsmoke.d_out),
                     **{f"p/{k}": np.asarray(v) for k, v in params.items()})
    rng = np.random.default_rng(5)
    ids = rng.integers(0, PRIM_N, (4, PRIM_E))
    ids[rng.random((4, PRIM_E)) < 0.2] = PRIM_N          # dropped rows
    np.savez(f"{tmp}/prims.npz", ids=ids.astype(np.int32),
             h=rng.normal(size=(PRIM_N, 3, PRIM_D)).astype(np.float32),
             ct_rows=rng.normal(size=(4, PRIM_E, 3, PRIM_D)).astype(np.float32),
             ct_nodes=rng.normal(size=(PRIM_N, 3 * PRIM_D)).astype(np.float32),
             data=rng.normal(size=(4, PRIM_E, 3 * PRIM_D)).astype(np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on 4 fake devices and the port on 4 gloo ranks, side by side."""
    tmp = str(tmp_path_factory.mktemp("gnn_mesh"))
    here = os.path.dirname(os.path.abspath(__file__))
    _inputs(tmp)
    env = _env()
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, tmp, here], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    for r in range(4):
        env = _env()
        env.update(RANK=str(r), WORLD_SIZE="4")
        procs.append(subprocess.Popen([sys.executable, "-c", _RANK, tmp, here], env=env,
                                      cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"{so}\n{se[-4000:]}"
    jx = dict(np.load(f"{tmp}/jax.npz"))
    ranks = [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(4)]
    return jx, ranks


def test_rank_holds_jax_device_rows(runs):
    """Rank ``d·M + m`` sits at ``(d, m)`` and holds the node and edge rows
    JAX's ``NamedSharding`` of ``graph_specs`` gives device ``(d, m)``."""
    jx, ranks = runs
    grid = GridShape((2, 2), ("data", "model"))
    for r, z in enumerate(ranks):
        c = grid.coords(r)
        dev = jx["devices"][c["data"], c["model"]]
        assert dev == r and tuple(z["coords"]) == (c["data"], c["model"])
        for field, got in (("x", z["rows/x"]), ("src", z["rows/src"])):
            lo, hi = jx[f"rows/{field}/{dev}"]
            assert np.array_equal(got, np.arange(lo, hi)), (field, r)
        for field in gnn.GraphData.__dataclass_fields__:
            lo, hi = jx[f"rows/{field}/{dev}"]
            total = FWD_PAD_N if field in ("x", "node_mask", "positions") else FWD_PAD_E
            assert (lo, hi) == (r * total // 4, (r + 1) * total // 4), field
    # graph_unshard puts the ranks' shards back together
    whole = graph_unshard([{k[6:]: z[k] for k in z if k.startswith("shard/")} for z in ranks])
    jcfg = _fwd_cfg("gatedgcn", jgnn)
    want = _graph(FWD_PAD_N, FWD_PAD_E, jcfg.d_in, jcfg.d_edge_in, seed=ARCHS.index("gatedgcn"))
    for field in gnn.GraphData.__dataclass_fields__:
        assert np.array_equal(whole[field], want[field]), field


@pytest.mark.parametrize("cs", ["plain", "cs"])
def test_primitives_and_gradients_match_one_process(runs, cs):
    _, ranks = runs
    for r, z in enumerate(ranks):
        assert np.array_equal(z[f"prim/{cs}/gather"], z[f"prim/{cs}/gather_want"]), r
        assert np.array_equal(z[f"prim/{cs}/sum_grad"], z[f"prim/{cs}/sum_grad_want"]), r
        for key in ("gather_grad", "sum"):
            want = z[f"prim/{cs}/{key}_want"]
            gap = np.abs(z[f"prim/{cs}/{key}"] - want).max()
            assert gap <= 1e-6 * np.abs(want).max(), (key, r, gap)
        assert z[f"prim/{cs}/gather_raises"] and z[f"prim/{cs}/sum_raises"], r
        calls = set(z[f"prim/{cs}/calls"].tolist())
        if cs == "cs":
            assert {"all_to_all/model", "all_gather/data", "reduce_scatter/data"} <= calls
        else:
            assert calls == {"all_gather/data,model", "reduce_scatter/data,model"}, calls


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_mesh(runs, arch):
    jx, ranks = runs
    want = jx[f"fwd/{arch}"]
    got = np.concatenate([z[f"fwd/{arch}"] for z in ranks])
    assert got.shape == want.shape == (FWD_PAD_N, FWD_KW[arch]["d_out"])
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert np.abs(got - ranks[0][f"fwd1/{arch}"]).max() <= 1e-4 * np.abs(want).max()
    if arch == "equiformer-v2":   # 128 edges on 4 ranks: 8 chunks of 4 a rank
        assert gnn.eqv2_chunks(FWD_PAD_E, FWD_KW[arch]["edge_chunk"], 4) == 8


def _update_slack(mu, nu, t: int, gamma: float) -> np.ndarray:
    """How far AdamW's step ``t`` update ``lr · m̂ / (√v̂ + eps)`` may move
    when every gradient of the leaf moves by up to ``gamma``: ``m̂`` and
    ``√v̂`` move by at most that much, so the quotient by ``γ / (√v̂ + eps)
    + |m̂| γ / (√v̂ + eps)²``, and never by more than 2 (its sign). From
    JAX's moments after step ``t``."""
    m = mu / (1 - B1 ** t)
    s = np.sqrt(nu / (1 - B2 ** t)) + EPS
    return LR * np.minimum(2.0, gamma / s + np.abs(m) * gamma / s ** 2)


def _grad_of(mu, mu_prev):
    return (mu - B1 * mu_prev) / (1 - B1)


@pytest.mark.parametrize("shape_name", STEP_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_two_steps_match_gnn_cell(runs, arch, shape_name):
    jx, ranks = runs
    case = f"{arch}/{shape_name}"
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype="float32")
    grid = GridShape((2, 2), ("data", "model"))
    place = gnn.gnn_placements(cfg, grid)
    slack = {k: 0.0 for k in place}
    mu_prev = {k: np.zeros(p.shape, np.float32) for k, p in place.items()}
    for i in range(STEPS):
        for what in ("loss", "gnorm"):
            want = float(jx[f"{case}/{what}{i}"])
            for z in ranks:
                assert abs(float(z[f"{case}/{what}{i}"]) - want) <= 1e-5 * abs(want), (what, i)
        top = {name: max(np.abs(jx[f"{case}/{name}{i}/{k}"]).max() for k in place)
               for name in ("mu", "nu")}
        g_top = max(np.abs(_grad_of(jx[f"{case}/mu{i}/{k}"], mu_prev[k])).max() for k in place)
        for k, p in place.items():
            mu, nu = jx[f"{case}/mu{i}/{k}"], jx[f"{case}/nu{i}/{k}"]
            for r, z in enumerate(ranks):   # each rank's ZeRO-1 slice of both moments
                sl = grid.slices(p.moment_spec, p.shape, r)
                assert (np.abs(z[f"{case}/mu{i}/{k}"] - mu[sl]).max()
                        <= 1e-4 * np.abs(mu).max() + 1e-6 * top["mu"]), ("mu", k, i, r)
                assert (np.abs(z[f"{case}/nu{i}/{k}"] - nu[sl]).max()
                        <= 2e-4 * np.abs(nu).max() + 1e-6 * top["nu"]), ("nu", k, i, r)
            gamma = 1e-4 * np.abs(_grad_of(mu, mu_prev[k])).max() + 1e-6 * g_top
            slack[k] = slack[k] + _update_slack(mu, nu, i + 1, gamma)
            want = jx[f"{case}/p{i}/{k}"]
            for z in ranks:   # the replicated weights, whole on every rank
                gap = np.abs(z[f"{case}/p{i}/{k}"] - want)
                assert (gap <= 1e-5 * np.abs(want).max() + slack[k]).all(), (k, i)
            mu_prev[k] = mu
    # each rank's moment slice is the one NamedSharding gives its device
    for k, p in place.items():
        for r in range(len(ranks)):
            idx = jx[f"{case}/mu_index/{k}/{r}"]
            sl = tuple(slice(int(a), int(b)) for a, b in idx)
            assert sl == grid.slices(p.moment_spec, p.shape, r), (k, r)
    calls = set(ranks[0][f"{case}/calls"].tolist())
    assert {"all_gather/data,model", "reduce_scatter/data,model", "all_reduce/data,model",
            "reduce_scatter/data", "all_reduce/model", "all_gather/data"} <= calls, calls
    if arch == "equiformer-v2":
        assert "all_to_all/model" in calls
