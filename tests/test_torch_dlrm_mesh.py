"""DLRM on a two-axis ("data", "model") grid: the port against JAX on the CPU.

- The sharding helpers (``dlrm.param_specs``, ``dlrm_placements``,
  ``sharding.batch_axes`` and the candidates' ``fix_spec``) equal JAX's
  ``param_specs`` + ``_fix_spec`` + ``_zero1_specs`` + ``_batch_axes`` leaf
  for leaf, for dlrm-rm2 at full size and at smoke size, on ``(1, 1)``,
  ``(2, 2)``, ``(1, 4)``, ``(4, 1)``, ``(16, 16)`` and ``(2, 16, 16)``
  (``jax.sharding.AbstractMesh``: no devices needed).
- On 4 gloo ranks at ``(2, 2)`` against ``_dlrm_cell(..., make_local_mesh(2,
  2), smoke=True)`` over 4 fake CPU devices, with JAX's parameters carried
  across by ``convert.dlrm_params_shard``: two ``train_batch`` steps (loss,
  norm, every parameter and both moments gathered whole, each rank's moment
  shard against the slice JAX's ``NamedSharding`` gives that device), the
  ``serve_p99`` logits and the ``retrieval_cand`` scores over 1,024
  candidates (split over every axis).
- Edge cases, each through the cell's program under ``jax.jit`` with the
  cell's shardings: 127 rows in 3 tables (``"model"`` dropped: the table
  whole on every rank, its moments split over data on dimension 2);
  ``multi_hot`` 3 (a bag's rows on both model ranks); ids outside ``[0, V)``
  in a request and among the candidates (NaN where JAX's outputs are NaN,
  finite and equal elsewhere); a batch of 63 (replicated over ``"data"``);
  1,023 candidates, which every rank scores whole.
- One step on a ``(1, 4)`` grid: the rows split four ways, no ZeRO split.

Every rank and the JAX program run in subprocesses spawned once for the
module, single-threaded, side by side. Tolerance: 1e-5 of the JAX value's
largest magnitude, as in
``tests/test_torch_dlrm_train.py::test_dlrm_train_step_matches_jax``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import AbstractMesh, PartitionSpec as P

from conftest import REPO, SRC
from repro.configs.registry import get_arch as j_get_arch
from repro.launch.steps import _batch_axes, _fix_spec, _zero1_specs
from repro.models import dlrm as jdlrm
from repro_torch import sharding
from repro_torch.configs import get_arch
from repro_torch.data import click_batches
from repro_torch.launch import steps
from repro_torch.mesh import GridShape
from repro_torch.models import dlrm

MESHES = {"1x1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")), "4x1": ((4, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
BATCHES = (1, 63, 64, 512, 65_536, 262_144)
CANDIDATES = (1_024, 1_000_000, 1_023)
# training cases: (config changes, grid, batch, steps)
TRAIN = {"main": ({}, (2, 2), 64, 2),
         "rows127": ({"rows_per_table": 127, "n_sparse": 3}, (2, 2), 64, 1),
         "multihot3": ({"multi_hot": 3}, (2, 2), 64, 1),
         "batch63": ({}, (2, 2), 63, 1),
         "grid1x4": ({}, (1, 4), 64, 1)}
# serving cases on the (2, 2) grid: (config changes, ids outside [0, V))
SERVE = {"main": ({}, False), "rows127": ({"rows_per_table": 127, "n_sparse": 3}, False),
         "multihot3": ({"multi_hot": 3}, False), "oob": ({}, True)}
SERVE_BATCH, N_CAND = 64, 1024
REL = 1e-5


def _jcfg(changes):
    return dataclasses.replace(j_get_arch("dlrm-rm2").smoke, **changes)


def _cfg(changes):
    return dataclasses.replace(get_arch("dlrm-rm2").smoke, **changes)


# ---------------------------------------------------------------------------
# the sharding helpers against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_specs_equal_jax(mesh_name):
    sizes, names = MESHES[mesh_name]
    amesh = AbstractMesh(sizes, names)
    grid = GridShape(sizes, names)
    for smoke in (False, True):
        jcfg = j_get_arch("dlrm-rm2").smoke if smoke else j_get_arch("dlrm-rm2").config
        cfg = get_arch("dlrm-rm2").smoke if smoke else get_arch("dlrm-rm2").config
        jshapes = jax.eval_shape(lambda: jdlrm.init_params(jcfg, jax.random.PRNGKey(0)))
        jspecs = jdlrm.param_specs(jcfg, amesh.axis_names)
        jz = _zero1_specs(jspecs, jshapes, amesh)
        specs = dlrm.param_specs(cfg, grid.axis_names)
        zero = sharding.zero1_specs(specs, dlrm.param_shapes(cfg), grid)
        place = dlrm.dlrm_placements(cfg, grid)
        assert sorted(specs) == sorted(jspecs) == sorted(place) == sorted(jshapes)
        for k, shp in jshapes.items():
            shape = tuple(shp.shape)
            assert dlrm.param_shapes(cfg)[k] == shape == place[k].shape, k
            assert specs[k] == tuple(jspecs[k]) and zero[k] == tuple(jz[k]), k
            assert sharding.fix_spec(specs[k], shape, grid) == tuple(
                _fix_spec(jspecs[k], shape, amesh)) == place[k].spec, k
            assert sharding.fix_spec(zero[k], shape, grid) == tuple(
                _fix_spec(jz[k], shape, amesh)) == place[k].moment_spec, k
        want_rows = "model" if cfg.rows_per_table % grid.shape["model"] == 0 else None
        assert place["tables"].spec == (None, want_rows, None)
        assert place["tables"].model_dim == (1 if want_rows else None)
    for b in BATCHES:
        assert sharding.batch_axes(b, grid) == _batch_axes(b, amesh), b
    axes = tuple(names)
    for n in CANDIDATES:
        assert sharding.fix_spec((axes,), (n,), grid) == tuple(_fix_spec(P(axes), (n,), amesh))


def test_placements_of_the_edge_cases():
    grid = GridShape((2, 2), ("data", "model"))
    place = dlrm.dlrm_placements(_cfg(TRAIN["rows127"][0]), grid)
    assert place["tables"].spec == (None, None, None) and place["tables"].model_dim is None
    assert place["tables"].moment_spec == (None, None, "data") and place["tables"].data_dim == 2
    place = dlrm.dlrm_placements(_cfg({}), grid)
    assert place["tables"].moment_spec == ("data", "model", None)
    place = dlrm.dlrm_placements(_cfg({}), GridShape((1, 4), ("data", "model")))
    assert place["tables"].spec == (None, "model", None) and place["tables"].data_dim is None
    assert sharding.batch_axes(63, grid) is None and sharding.batch_axes(64, grid) == "data"


# ---------------------------------------------------------------------------
# the cell's programs across processes
# ---------------------------------------------------------------------------

_JAX = r'''
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, sys.argv[2])
from test_torch_dlrm_mesh import TRAIN, SERVE, SERVE_BATCH, N_CAND, _jcfg
from repro.configs.registry import ShapeSpec, get_arch
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import _dlrm_cell
from repro.optim import adamw_init

tmp = sys.argv[1]
meshes = {(2, 2): make_local_mesh(2, 2), (1, 4): make_local_mesh(1, 4)}
out = {f"devices/{a}x{b}": np.array([[d.id for d in row] for row in m.devices])
       for (a, b), m in meshes.items()}


def spec_of(changes):
    return dataclasses.replace(get_arch("dlrm-rm2"), smoke=_jcfg(changes))


for case, (changes, grid, batch, n_steps) in TRAIN.items():
    mesh = meshes[grid]
    inp = np.load(f"{tmp}/train_{case}.npz")
    prog = _dlrm_cell(spec_of(changes), ShapeSpec(name="t", kind="recsys_train", batch=batch),
                      mesh, smoke=True)
    scalar = NamedSharding(mesh, P())
    step = jax.jit(prog.fn, in_shardings=prog.in_shardings,
                   out_shardings=prog.in_shardings[:2] + (scalar, scalar))
    params = {k[2:]: jnp.asarray(inp[k]) for k in inp.files if k.startswith("p/")}
    params, opt = jax.device_put((params, adamw_init(params)), prog.in_shardings[:2])
    for i in range(n_steps):
        params, opt, loss, gnorm = step(params, opt, inp["dense"][i], inp["sparse"][i],
                                        inp["labels"][i])
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

mesh = meshes[(2, 2)]
for case, (changes, _) in SERVE.items():
    inp = np.load(f"{tmp}/serve_{case}.npz")
    params = {k[2:]: jnp.asarray(inp[k]) for k in inp.files if k.startswith("p/")}
    prog = _dlrm_cell(spec_of(changes), ShapeSpec(name="s", kind="recsys_serve",
                                                  batch=SERVE_BATCH), mesh, smoke=True)
    out[f"{case}/logits"] = np.asarray(jax.jit(prog.fn, in_shardings=prog.in_shardings)(
        params, inp["dense"], inp["sparse"]))
    prog = _dlrm_cell(spec_of(changes), ShapeSpec(name="r", kind="retrieval", batch=1,
                                                  n_candidates=N_CAND), mesh, smoke=True)
    out[f"{case}/scores"] = np.asarray(jax.jit(prog.fn, in_shardings=prog.in_shardings)(
        params, inp["dense"][:1], inp["sparse"][:1], inp["cand"]))
# candidates the grid does not divide (replicated): the smoke config as the
# cell's full one, whose candidate count the shape sets
inp = np.load(f"{tmp}/serve_main.npz")
params = {k[2:]: jnp.asarray(inp[k]) for k in inp.files if k.startswith("p/")}
spec = dataclasses.replace(get_arch("dlrm-rm2"), config=_jcfg({}))
prog = _dlrm_cell(spec, ShapeSpec(name="r", kind="retrieval", batch=1,
                                  n_candidates=N_CAND - 1), mesh, smoke=False)
out["replicated/scores"] = np.asarray(jax.jit(prog.fn, in_shardings=prog.in_shardings)(
    params, inp["dense"][:1], inp["sparse"][:1], inp["cand"][:N_CAND - 1]))
np.savez(f"{tmp}/jax.npz", **out)
'''

_RANK = r'''
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[2])
from test_torch_dlrm_mesh import TRAIN, SERVE, _cfg
import torch.distributed as dist
from repro_torch.convert import dlrm_params_shard
from repro_torch.launch import steps
from repro_torch.launch.mesh import init_grid_mesh
from repro_torch.mesh import GridMesh

tmp = sys.argv[1]
meshes = {(2, 2): init_grid_mesh(2, 2, "cpu", timeout_s=120, init_method=f"file://{tmp}/store")}
meshes[(1, 4)] = GridMesh((1, 4), ("data", "model"), "cpu")
r = meshes[(2, 2)].rank
out = {"coords": np.array([meshes[(2, 2)].coord("data"), meshes[(2, 2)].coord("model")])}


def tensors(inp, *keys):
    return (torch.from_numpy(inp[k]) for k in keys)


for case, (changes, grid, batch, n_steps) in TRAIN.items():
    mesh, cfg = meshes[grid], _cfg(changes)
    inp = np.load(f"{tmp}/train_{case}.npz")
    params = dlrm_params_shard({k[2:]: inp[k] for k in inp.files if k.startswith("p/")}, cfg,
                               mesh, device="cpu")
    opt = steps.dlrm_adamw_init(params, cfg, mesh)
    mesh.reset_counts()
    for i in range(n_steps):
        dense, sparse, labels = (x[i] for x in tensors(inp, "dense", "sparse", "labels"))
        params, opt, loss, gnorm = steps.dlrm_train_step(params, opt, dense, sparse, labels,
                                                         cfg, use_kernels=False, mesh=mesh)
        out[f"{case}/loss{i}"], out[f"{case}/gnorm{i}"] = float(loss), float(gnorm)
        for k in params:
            out[f"{case}/p{i}/{k}"] = params[k].numpy().copy()
            out[f"{case}/mu{i}/{k}"] = opt.mu[k].numpy().copy()
            out[f"{case}/nu{i}/{k}"] = opt.nu[k].numpy().copy()
    for kind in ("all_reduce/model", "reduce_scatter/data"):
        out[f"{case}/calls/{kind}"] = mesh.calls[kind]

mesh = meshes[(2, 2)]
for case, (changes, _) in SERVE.items():
    cfg = _cfg(changes)
    inp = np.load(f"{tmp}/serve_{case}.npz")
    params = dlrm_params_shard({k[2:]: inp[k] for k in inp.files if k.startswith("p/")}, cfg,
                               mesh, device="cpu")
    dense, sparse, cand = tensors(inp, "dense", "sparse", "cand")
    out[f"{case}/logits"] = steps.dlrm_serve_step(params, dense, sparse, cfg, use_kernels=False,
                                                  mesh=mesh).numpy()
    out[f"{case}/scores"] = steps.dlrm_retrieval_step(params, dense[:1], sparse[:1], cand, cfg,
                                                      use_kernels=False, mesh=mesh).numpy()
    if case == "main":
        mesh.reset_counts()
        out["replicated/scores"] = steps.dlrm_retrieval_step(
            params, dense[:1], sparse[:1], cand[:-1], cfg, use_kernels=False, mesh=mesh).numpy()
        out["replicated/calls"] = np.array([mesh.calls["all_gather/model"],
                                            mesh.calls["all_reduce/model"]])
np.savez(f"{tmp}/rank{r}.npz", **out)
dist.destroy_process_group()
'''


def _params(changes):
    return {f"p/{k}": np.asarray(v) for k, v in
            jdlrm.init_params(_jcfg(changes), jax.random.PRNGKey(0)).items()}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on 4 fake devices and the port on 4 gloo ranks, side by side, on
    the same inputs: JAX's initial parameters, the click stream, requests
    and candidates."""
    tmp = str(tmp_path_factory.mktemp("dlrm_mesh"))
    here = os.path.dirname(os.path.abspath(__file__))
    for case, (changes, _, batch, n_steps) in TRAIN.items():
        cfg = _cfg(changes)
        stream = click_batches(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table, batch,
                               multi_hot=cfg.multi_hot, seed=5)
        dense, sparse, labels = (np.stack(x) for x in zip(*(next(stream)
                                                            for _ in range(n_steps))))
        np.savez(f"{tmp}/train_{case}.npz", dense=dense, sparse=sparse, labels=labels,
                 **_params(changes))
    for case, (changes, oob) in SERVE.items():
        cfg = _cfg(changes)
        dense, sparse = steps.recsys_requests(cfg, SERVE_BATCH, 7)
        cand = steps.retrieval_candidates(cfg, N_CAND, 7)
        if oob:   # past the last row: JAX's gathers fill NaN
            sparse[3, 1, 0] = cfg.rows_per_table
            sparse[40, 2, 0] = cfg.rows_per_table + 5
            cand[[7, 900]] = cfg.rows_per_table
        np.savez(f"{tmp}/serve_{case}.npz", dense=dense, sparse=sparse, cand=cand,
                 **_params(changes))
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


def _gap(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_grid_layout_is_make_mesh(runs):
    jx, ranks = runs
    grid = GridShape((2, 2), ("data", "model"))
    for r, z in enumerate(ranks):
        c = grid.coords(r)
        assert jx["devices/2x2"][c["data"], c["model"]] == r
        assert tuple(z["coords"]) == (c["data"], c["model"])


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_train_steps_match_dlrm_cell(runs, case):
    from repro_torch.convert import dlrm_params_unshard

    jx, ranks = runs
    changes, sizes, _, n_steps = TRAIN[case]
    cfg = _cfg(changes)
    grid = GridShape(sizes, ("data", "model"))
    place = dlrm.dlrm_placements(cfg, grid)
    for i in range(n_steps):
        for what in ("loss", "gnorm"):
            want = float(jx[f"{case}/{what}{i}"])
            for z in ranks:
                assert abs(float(z[f"{case}/{what}{i}"]) - want) <= REL * abs(want), (what, i)
        for name in ("p", "mu", "nu"):
            whole = dlrm_params_unshard([{k: z[f"{case}/{name}{i}/{k}"] for k in place}
                                         for z in ranks], cfg, grid, moments=name != "p")
            for k in place:
                assert _gap(whole[k], jx[f"{case}/{name}{i}/{k}"]) <= REL, (name, k, i)
    # each rank's moment shard is the slice NamedSharding gives its device
    jdev = jx[f"devices/{sizes[0]}x{sizes[1]}"]
    for k, p in place.items():
        want = jx[f"{case}/mu{n_steps - 1}/{k}"]
        for r, z in enumerate(ranks):
            c = grid.coords(r)
            idx = jx[f"{case}/mu_index/{k}/{int(jdev[c['data'], c['model']])}"]
            sl = tuple(slice(int(a), int(b)) for a, b in idx)
            assert sl == grid.slices(p.moment_spec, p.shape, r), (k, r)
            got = z[f"{case}/mu{n_steps - 1}/{k}"]
            assert np.abs(got - want[sl]).max() <= REL * np.abs(want).max(), (k, r)
    # the bags' sum over "model" where the tables split, none where whole
    split = place["tables"].model_dim is not None
    for z in ranks:
        assert (int(z[f"{case}/calls/all_reduce/model"]) > 0) == split, case
        assert (int(z[f"{case}/calls/reduce_scatter/data"]) > 0) == (sizes[0] > 1), case


def _assemble(ranks, key, parts_by_rank):
    """The whole output from each rank's part: ``parts_by_rank[r]`` is the
    part's index; ranks with the same index hold the same values."""
    parts = {}
    for r, z in enumerate(ranks):
        j = parts_by_rank[r]
        if j in parts:
            np.testing.assert_array_equal(parts[j], z[key])
        else:
            parts[j] = z[key]
    return np.concatenate([parts[j] for j in sorted(parts)])


def _close_with_nans(got, want):
    assert got.shape == want.shape
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.isfinite(got[~nan]).all()
    assert np.abs(got[~nan] - want[~nan]).max() <= REL * np.abs(want[~nan]).max()


@pytest.mark.parametrize("case", sorted(SERVE))
def test_serving_matches_dlrm_cell(runs, case):
    jx, ranks = runs
    grid = GridShape((2, 2), ("data", "model"))
    logits = _assemble(ranks, f"{case}/logits", [grid.coords(r)["data"] for r in range(4)])
    scores = _assemble(ranks, f"{case}/scores", list(range(4)))
    assert ranks[0][f"{case}/logits"].shape == (SERVE_BATCH // 2,)
    assert ranks[0][f"{case}/scores"].shape == (N_CAND // 4,)
    _close_with_nans(logits, jx[f"{case}/logits"])
    _close_with_nans(scores, jx[f"{case}/scores"])
    oob = SERVE[case][1]
    assert bool(np.isnan(jx[f"{case}/logits"]).any()) == oob
    assert bool(np.isnan(jx[f"{case}/scores"]).any()) == oob
    if oob:
        assert np.flatnonzero(np.isnan(logits)).tolist() == [3, 40]
        assert np.flatnonzero(np.isnan(scores)).tolist() == [7, 900]


def test_replicated_candidates_match_dlrm_cell(runs):
    """1,023 candidates do not split over 4 ranks: every rank scores all of
    them, the candidates' rows summed over ``model`` (no gather)."""
    jx, ranks = runs
    want = jx["replicated/scores"]
    assert want.shape == (N_CAND - 1,)
    for z in ranks:
        _close_with_nans(z["replicated/scores"], want)
        assert z["replicated/calls"].tolist() == [0, 2]
