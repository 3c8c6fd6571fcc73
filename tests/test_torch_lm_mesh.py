"""LM training on a two-axis ("data", "model") grid: the port against JAX on the CPU.

- The sharding helpers (``param_specs``, ``fix_spec``, ``zero1_specs``,
  ``batch_axes``) equal JAX's leaf for leaf, for the five LMs at full width
  and at smoke size, on ``(1, 1)``, ``(2, 2)``, ``(1, 4)``, ``(4, 1)``,
  ``(16, 16)`` and ``(2, 16, 16)`` (``jax.sharding.AbstractMesh``: no
  devices needed); the grid's rank layout equals ``jax.make_mesh``'s.
- Two training steps on 4 gloo ranks at ``(2, 2)`` against ``_lm_cell``'s
  step on ``make_local_mesh(2, 2)`` over 4 fake CPU devices: the
  phi4-mini, minicpm3 (MLA), granite-moe (MoE, ep = 2, the sequence
  split) and deepseek-v2-lite-16b (MLA without q-LoRA, a dense first layer,
  MoE at ep = 2 with its shared experts tensor-parallel) smoke configs in
  float32, and granite with a vocabulary of 255, whose embedding and head
  stay whole. Loss, gradient norm, every parameter
  and both moments gathered whole, and each rank's moment shard against
  the slice JAX's ``NamedSharding`` gives that device.
- One MoE layer at ep = 2 against JAX's ``_moe_routed`` under
  ``shard_map``, its router skewed so that the exchange drops rows and an
  expert's rows pass its window: the output, the dropped rows (against a
  count of the buckets in NumPy) and the gradients of ``x``, the routing
  weights and the experts; once with the sequence split and the batch over
  data, once with neither (``L % ep ≠ 0``, an odd batch).
- The sharded step at ``n_micro = 2`` (with remat, whose recompute repeats
  the collectives and the exchange) against the one-process step at
  ``n_micro = 2``.
- deepseek's first step again with ``optim.adamw.BLOCK_BYTES`` at 1 KiB, so
  that ZeRO-1 reduces every larger leaf a block of rows at a time: bit for
  bit the whole-leaf step.

Every rank and the JAX program run in subprocesses spawned once for the
module, single-threaded, side by side. Tolerances are the float32 ones of
``test_torch_lm_train_mla_moe.py``: 1e-5 of the JAX value's largest
magnitude (the second moment twice that), the parameters that plus the
slack AdamW's division gives a gradient's gap (``_update_slack``).
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
from repro.configs.registry import get_arch as j_get_arch
from repro.launch.steps import _batch_axes, _fix_spec, _zero1_specs
from repro.models import transformer as jtf
from repro_torch import sharding
from repro_torch.configs import get_arch
from repro_torch.data import token_batches
from repro_torch.mesh import GridShape
from repro_torch.models import transformer as tf
from test_torch_lm_train_mla_moe import _update_slack

LMS = ("phi4-mini-3.8b", "minicpm3-4b", "granite-moe-3b-a800m", "deepseek-v2-lite-16b",
       "command-r-35b")
MESHES = {"1x1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")), "4x1": ((4, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
BATCHES = (1, 2, 3, 4, 8, 16, 24, 256, 512)
# the (2, 2) training cases: (arch, vocabulary or None)
CASES = {"phi4": ("phi4-mini-3.8b", None), "minicpm3": ("minicpm3-4b", None),
         "granite": ("granite-moe-3b-a800m", None),
         "granite_v255": ("granite-moe-3b-a800m", 255),
         "deepseek": ("deepseek-v2-lite-16b", None)}
BATCH, SEQ, STEPS = 4, 12, 2
REL = 1e-5
# the MoE layer: granite smoke widths with 20 experts (32 padded, 16 a rank
# at ep = 2, both ranks active) at capacity factor 1; (batch, sequence)
MOE_CASES = {"seq_split": (2, 400), "replicated": (3, 201)}
MOE_EXPERTS, MOE_CF = 20, 1.0


# ---------------------------------------------------------------------------
# the sharding helpers against JAX's
# ---------------------------------------------------------------------------

def _flat_tree(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LMS)
def test_specs_equal_jax(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    amesh = AbstractMesh(sizes, names)
    grid = GridShape(sizes, names)
    assert dict(amesh.shape) == grid.shape and tuple(amesh.axis_names) == grid.axis_names
    for smoke in (False, True):
        jcfg = j_get_arch(arch).smoke if smoke else j_get_arch(arch).config
        cfg = get_arch(arch).smoke if smoke else get_arch(arch).config
        jshapes = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0)))
        jspecs = jtf.param_specs(jcfg, amesh.axis_names)
        jz = _zero1_specs(jspecs, jshapes, amesh)
        jshapes, jspecs, jz = (_flat_tree(t) for t in (jshapes, jspecs, jz))
        specs = _flat_tree(tf.param_specs(cfg, grid.axis_names))
        shapes = _flat_tree(tf.param_shapes(cfg))
        zero = _flat_tree(sharding.zero1_specs(tf.param_specs(cfg, grid.axis_names),
                                            tf.param_shapes(cfg), grid))
        place = tf.lm_placements(cfg, grid)
        assert sorted(specs) == sorted(jspecs) == sorted(place)
        for k, shp in jshapes.items():
            shape = tuple(shp.shape)
            assert shapes[k] == shape, k
            assert specs[k] == tuple(jspecs[k]), k
            assert zero[k] == tuple(jz[k]), k
            assert sharding.fix_spec(specs[k], shape, grid) == tuple(
                _fix_spec(jspecs[k], shape, amesh)) == place[k].spec, k
            assert sharding.fix_spec(zero[k], shape, grid) == tuple(
                _fix_spec(jz[k], shape, amesh)) == place[k].moment_spec, k
        for b in BATCHES:
            assert sharding.batch_axes(b, grid) == _batch_axes(b, amesh), b
        if arch == "granite-moe-3b-a800m" and not smoke and sizes == (2, 2):
            # the odd vocabulary of 49,155 keeps the embedding and head whole
            # while their moments split over data on d_model
            assert place["embed"].spec == (None, None) == place["lm_head"].spec
            assert place["embed"].moment_spec == (None, "data")
            assert place["moe/e_wg"].moment_spec == ("data", "model", None, None)
    for axes in ("model", "data", ("pod", "data") if "pod" in names else "data"):
        assert sharding.axis_size(grid, axes) == sharding.axis_size(amesh, axes)


def test_production_mesh_needs_its_world(monkeypatch):
    from repro_torch.launch.mesh import init_grid_mesh, make_production_mesh

    monkeypatch.setenv("WORLD_SIZE", "4")
    for multi, want in ((False, "256"), (True, "512")):
        with pytest.raises(ValueError, match=f"needs {want} ranks, the world has 4"):
            make_production_mesh(multi_pod=multi, device="cpu")
    with pytest.raises(ValueError, match=r"\(3, 1\) grid needs 3 ranks, the world has 4"):
        init_grid_mesh(3, 1, "cpu")


def test_grid_slices_cover_each_leaf_once():
    """Each element of a leaf lies in exactly the slices of the ranks that
    replicate it: ``prod`` of the axes its spec leaves out."""
    grid = GridShape((2, 2, 2), ("pod", "data", "model"))
    shape, spec = (8, 6, 4), (("pod", "data"), None, "model")
    hits = np.zeros(shape, np.int32)
    for r in range(grid.world):
        hits[grid.slices(spec, shape, r)] += 1
    assert (hits == 1).all()
    assert [s.stop - s.start for s in grid.slices(spec, shape, 3)] == [2, 6, 2]
    assert [grid.coords(r) for r in (0, 5, 7)] == [
        {"pod": 0, "data": 0, "model": 0}, {"pod": 1, "data": 0, "model": 1},
        {"pod": 1, "data": 1, "model": 1}]
    assert grid.lines("model")[1] == [2, 3] and grid.lines(("pod", "data"))[0] == [0, 2, 4, 6]


# ---------------------------------------------------------------------------
# the training steps, the MoE layer and the microbatches across processes
# ---------------------------------------------------------------------------

def _jcfg(case):
    arch, vocab = CASES[case]
    spec = j_get_arch(arch)
    smoke = dataclasses.replace(spec.smoke, dtype="float32")
    if vocab:
        smoke = dataclasses.replace(smoke, vocab=vocab)
    return dataclasses.replace(spec, smoke=smoke)


def _cfg(case):
    arch, vocab = CASES[case]
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype="float32")
    return dataclasses.replace(cfg, vocab=vocab) if vocab else cfg


def _moe_cfg():
    return dataclasses.replace(get_arch("granite-moe-3b-a800m").smoke, dtype="float32",
                               n_experts=MOE_EXPERTS, moe_capacity_factor=MOE_CF)


_JAX = r'''
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, sys.argv[2])
from test_torch_lm_mesh import (CASES, MOE_CASES, MOE_CF, MOE_EXPERTS, SEQ, STEPS, BATCH, _jcfg,
                                _flat_tree)
from repro.configs.registry import ShapeSpec, get_arch
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import _lm_cell
from repro.models import transformer as jtf
from repro.optim import adamw_init

tmp = sys.argv[1]
mesh = make_local_mesh(2, 2)
out = {"devices": np.array([[d.id for d in row] for row in mesh.devices])}
TRAIN = ShapeSpec(name="train_small", kind="train", seq_len=SEQ, global_batch=BATCH)


def unflat(flat):
    tree = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


for case in CASES:
    spec = _jcfg(case)
    inp = np.load(f"{tmp}/inputs_{case}.npz")
    prog = _lm_cell(spec, TRAIN, mesh, smoke=True)
    scalar = NamedSharding(mesh, P())
    step = jax.jit(prog.fn, in_shardings=prog.in_shardings,
                   out_shardings=prog.in_shardings[:2] + (scalar, scalar))
    params = unflat({k[2:]: inp[k] for k in inp.files if k.startswith("p/")})
    params, opt = jax.device_put((params, adamw_init(params)), prog.in_shardings[:2])
    for i in range(STEPS):
        params, opt, loss, gnorm = step(params, opt, inp["tokens"][i], inp["labels"][i])
        out[f"{case}/loss{i}"], out[f"{case}/gnorm{i}"] = np.asarray(loss), np.asarray(gnorm)
        for name, tree in (("p", params), ("mu", opt.mu), ("nu", opt.nu)):
            for k, v in _flat_tree(tree).items():
                out[f"{case}/{name}{i}/{k}"] = np.asarray(v)
    for k, v in _flat_tree(opt.mu).items():
        idx = v.sharding.devices_indices_map(v.shape)
        for d in mesh.devices.flat:
            out[f"{case}/mu_index/{k}/{d.id}"] = np.array(
                [[s.start or 0, n if s.stop is None else s.stop]
                 for s, n in zip(idx[d], v.shape)], np.int64).reshape(-1, 2)

# the MoE layer under shard_map
base = get_arch("granite-moe-3b-a800m").smoke
c = dataclasses.replace(base, dtype="float32", n_experts=MOE_EXPERTS, moe_capacity_factor=MOE_CF)
for name in MOE_CASES:
    z = np.load(f"{tmp}/moe_{name}.npz")
    lp = {k: jnp.asarray(z[k]) for k in ("e_wg", "e_wu", "e_wd")}

    def f(x, w, e_wg, e_wu, e_wd, sel=jnp.asarray(z["sel"])):
        return jtf._moe_routed({"e_wg": e_wg, "e_wu": e_wu, "e_wd": e_wd}, x, sel, w, c, mesh)

    y, vjp = jax.vjp(jax.jit(f), jnp.asarray(z["x"]), jnp.asarray(z["w"]), lp["e_wg"],
                     lp["e_wu"], lp["e_wd"])
    out[f"moe/{name}/y"] = np.asarray(y)
    for k, g in zip(("x", "w", "e_wg", "e_wu", "e_wd"), vjp(jnp.asarray(z["ct"]))):
        out[f"moe/{name}/d_{k}"] = np.asarray(g)
np.savez(f"{tmp}/jax.npz", **out)
'''

_RANK = r'''
import dataclasses, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[2])
from test_torch_lm_mesh import (CASES, MOE_CASES, STEPS, _cfg, _moe_cfg)
import torch.distributed as dist
from repro_torch.convert import lm_params_shard
from repro_torch.launch import steps
from repro_torch.launch.mesh import init_grid_mesh
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_init

tmp = sys.argv[1]
mesh = init_grid_mesh(2, 2, "cpu", timeout_s=120, init_method=f"file://{tmp}/store")
r = mesh.rank
out = {"coords": np.array([mesh.coord("data"), mesh.coord("model")])}


def nested(inp):
    tree = {}
    for k in inp.files:
        if k.startswith("p/"):
            *path, leaf = k[2:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(inp[k])
    return tree


for case in CASES:
    cfg = _cfg(case)
    inp = np.load(f"{tmp}/inputs_{case}.npz")
    params = lm_params_shard(nested(inp), cfg, mesh, device="cpu")
    opt = steps.lm_adamw_init(params, cfg, mesh)
    stats = tf.RoutedStats()
    for i in range(STEPS):
        params, opt, loss, gnorm = steps.lm_train_step(
            params, opt, torch.from_numpy(inp["tokens"][i]), torch.from_numpy(inp["labels"][i]),
            cfg, use_kernels=False, mesh=mesh, stats=stats)
        out[f"{case}/loss{i}"], out[f"{case}/gnorm{i}"] = float(loss), float(gnorm)
        for k, v in steps.flat_params(params).items():
            out[f"{case}/p{i}/{k}"] = v.numpy().copy()
        for k in opt.mu:
            out[f"{case}/mu{i}/{k}"] = opt.mu[k].numpy().copy()
            out[f"{case}/nu{i}/{k}"] = opt.nu[k].numpy().copy()
    out[f"{case}/overflow"] = stats.summary()["overflow"]
    out[f"{case}/calls"] = np.array([v for k, v in sorted(mesh.calls.items())])
    out[f"{case}/reduce_scatters"] = mesh.calls["reduce_scatter/data"]
    mesh.reset_counts()

# the MoE layer: this rank's tokens and experts
c = _moe_cfg()
ax = mesh.axis("model")
e_per = c.n_experts_padded // ax.size
for name in MOE_CASES:
    z = np.load(f"{tmp}/moe_{name}.npz")
    b = z["x"].shape[0]
    rows = slice(None) if b % 2 else slice(mesh.coord("data") * (b // 2),
                                            (mesh.coord("data") + 1) * (b // 2))
    x = torch.from_numpy(z["x"][rows]).requires_grad_()
    w = torch.from_numpy(z["w"][rows]).requires_grad_()
    lp = {k: torch.from_numpy(z[k][ax.rank * e_per:(ax.rank + 1) * e_per]).requires_grad_()
          for k in ("e_wg", "e_wu", "e_wd")}
    stats = tf.RoutedStats()
    y = tf._moe_routed_ep(lp, x, w, torch.from_numpy(z["sel"][rows]).long(), c, mesh, stats)
    (y * torch.from_numpy(z["ct"][rows])).sum().backward()
    s = stats.summary()
    out[f"moe/{name}/y"] = y.detach().numpy()
    out[f"moe/{name}/overflow"] = s["overflow"]
    out[f"moe/{name}/masked"] = s["masked"]
    out[f"moe/{name}/d_x"], out[f"moe/{name}/d_w"] = x.grad.numpy(), w.grad.numpy()
    for k in lp:
        out[f"moe/{name}/d_{k}"] = lp[k].grad.numpy()

# ZeRO-1 by blocks of rows: deepseek's first step with every leaf over
# 1 KiB of float32 reduced a block at a time
from repro_torch.optim import adamw as adamw_module
cfg = _cfg("deepseek")
inp = np.load(f"{tmp}/inputs_deepseek.npz")
params = lm_params_shard(nested(inp), cfg, mesh, device="cpu")
opt = steps.lm_adamw_init(params, cfg, mesh)
whole_bytes, adamw_module.BLOCK_BYTES = adamw_module.BLOCK_BYTES, 1024
mesh.reset_counts()
params, opt, loss, gnorm = steps.lm_train_step(
    params, opt, torch.from_numpy(inp["tokens"][0]), torch.from_numpy(inp["labels"][0]), cfg,
    use_kernels=False, mesh=mesh)
adamw_module.BLOCK_BYTES = whole_bytes
out["blocks/loss"], out["blocks/gnorm"] = float(loss), float(gnorm)
out["blocks/reduce_scatters"] = mesh.calls["reduce_scatter/data"]
for k, v in steps.flat_params(params).items():
    out[f"blocks/p/{k}"] = v.numpy().copy()
    out[f"blocks/mu/{k}"], out[f"blocks/nu/{k}"] = opt.mu[k].numpy(), opt.nu[k].numpy()

# microbatches: granite with remat at n_micro = 2, and on one process
cfg = dataclasses.replace(_cfg("granite"), remat=True)
inp = np.load(f"{tmp}/inputs_granite.npz")
tok, lab = (torch.from_numpy(inp[k][0]) for k in ("tokens", "labels"))
whole = nested(inp)
params = lm_params_shard(whole, cfg, mesh, device="cpu")
opt = steps.lm_adamw_init(params, cfg, mesh)
stats = tf.RoutedStats()
params, opt, loss, gnorm = steps.lm_train_step(params, opt, tok, lab, cfg, use_kernels=False,
                                               mesh=mesh, stats=stats, n_micro=2)
out["micro/loss"], out["micro/gnorm"] = float(loss), float(gnorm)
out["micro/routed_calls"] = stats.summary()["calls"]
for k, v in steps.flat_params(params).items():
    out[f"micro/p/{k}"] = v.numpy().copy()
    out[f"micro/mu/{k}"], out[f"micro/nu/{k}"] = opt.mu[k].numpy(), opt.nu[k].numpy()
if r == 0:
    opt1 = adamw_init(steps.flat_params(whole))
    whole, opt1, loss1, gnorm1 = steps.lm_train_step(whole, opt1, tok, lab, cfg,
                                                     use_kernels=False, n_micro=2)
    out["micro1/loss"], out["micro1/gnorm"] = float(loss1), float(gnorm1)
    for k, v in steps.flat_params(whole).items():
        out[f"micro1/p/{k}"] = v.numpy().copy()
        out[f"micro1/mu/{k}"], out[f"micro1/nu/{k}"] = opt1.mu[k].numpy(), opt1.nu[k].numpy()
np.savez(f"{tmp}/rank{r}.npz", **out)
dist.destroy_process_group()
'''


def _moe_inputs(b: int, l: int, seed: int):
    """The MoE layer's inputs: x, routing (two distinct experts a token, 80 %
    of first choices on expert 0), weights, the experts and the output's
    cotangent."""
    c = _moe_cfg()
    rng = np.random.default_rng(seed)
    d, k, fe, e = c.d_model, c.top_k, c.d_expert, c.n_experts_padded
    hot = rng.random((b, l)) < 0.8
    first = np.where(hot, 0, rng.integers(0, c.n_experts, (b, l)))
    second = (first + 1 + rng.integers(0, c.n_experts - 1, (b, l))) % c.n_experts
    sel = np.stack([first, second], -1).astype(np.int32)
    w = rng.random((b, l, k)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    return {"x": rng.normal(size=(b, l, d)).astype(np.float32), "sel": sel, "w": w,
            "e_wg": (rng.normal(size=(e, d, fe)) / np.sqrt(d)).astype(np.float32),
            "e_wu": (rng.normal(size=(e, d, fe)) / np.sqrt(d)).astype(np.float32),
            "e_wd": (rng.normal(size=(e, fe, d)) / np.sqrt(fe)).astype(np.float32),
            "ct": rng.normal(size=(b, l, d)).astype(np.float32)}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on 4 fake devices and the port on 4 gloo ranks, side by side, on
    the same inputs: JAX's initial parameters and the token stream."""
    tmp = str(tmp_path_factory.mktemp("lm_mesh"))
    here = os.path.dirname(os.path.abspath(__file__))
    for case in CASES:
        jcfg = _jcfg(case).smoke
        params = _flat_tree(jtf.init_params(jcfg, jax.random.PRNGKey(0)))
        stream = token_batches(jcfg.vocab, BATCH, SEQ, seed=3)
        toks, labels = zip(*(next(stream) for _ in range(STEPS)))
        np.savez(f"{tmp}/inputs_{case}.npz", tokens=np.stack(toks), labels=np.stack(labels),
                 **{f"p/{k}": np.asarray(v) for k, v in params.items()})
    for i, (name, (b, l)) in enumerate(MOE_CASES.items()):
        np.savez(f"{tmp}/moe_{name}.npz", **_moe_inputs(b, l, 20 + i))
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
        assert jx["devices"][c["data"], c["model"]] == r
        assert tuple(z["coords"]) == (c["data"], c["model"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_steps_match_lm_cell(runs, case):
    from repro_torch.convert import lm_params_unshard

    jx, ranks = runs
    cfg = _cfg(case)
    grid = GridShape((2, 2), ("data", "model"))
    place = tf.lm_placements(cfg, grid)
    slack = {k: 0.0 for k in place}
    mu_prev = {k: np.zeros(p.shape, np.float32) for k, p in place.items()}
    for i in range(STEPS):
        for what in ("loss", "gnorm"):
            want = float(jx[f"{case}/{what}{i}"])
            for z in ranks:
                assert abs(float(z[f"{case}/{what}{i}"]) - want) <= REL * abs(want), (what, i)
        whole = {name: lm_params_unshard(
            [{k: z[f"{case}/{name}{i}/{k}"] for k in place} for z in ranks], cfg, grid,
            moments=name != "p") for name in ("p", "mu", "nu")}
        for k, p in place.items():
            mu, nu = jx[f"{case}/mu{i}/{k}"], jx[f"{case}/nu{i}/{k}"]
            assert _gap(whole["mu"][k], mu) <= REL, ("mu", k, i)
            assert _gap(whole["nu"][k], nu) <= 2 * REL, ("nu", k, i)
            slack[k] = slack[k] + _update_slack(mu, nu, mu_prev[k], i + 1, REL)
            want = jx[f"{case}/p{i}/{k}"]
            gap = np.abs(whole["p"][k] - want)
            limit = REL * np.abs(want).max() + slack[k]
            assert (gap <= limit).all(), (k, i, float((gap / limit).max()))
            mu_prev[k] = mu
    # each rank's moment shard is the slice NamedSharding gives its device
    for k, p in place.items():
        for r, z in enumerate(ranks):
            idx = jx[f"{case}/mu_index/{k}/{r}"]
            sl = tuple(slice(int(a), int(b)) for a, b in idx)
            assert sl == grid.slices(p.moment_spec, p.shape, r), (k, r)
            want = jx[f"{case}/mu{STEPS - 1}/{k}"]
            got = z[f"{case}/mu{STEPS - 1}/{k}"]
            assert np.abs(got - want[sl]).max() <= REL * np.abs(want).max(), (k, r)
    if cfg.moe:
        assert all(int(z[f"{case}/overflow"]) == 0 for z in ranks)
    if case == "granite_v255":
        assert place["embed"].spec == (None, None) and place["lm_head"].spec == (None, None)
    else:
        assert place["embed"].spec == ("model", None) and place["lm_head"].spec == (None, "model")


def _dropped(sel: np.ndarray, data_split: bool, seq_split: bool) -> list:
    """Rows the exchange drops, by data rank: each (data, model) sender's
    routed rows a destination past its capacity, summed over the model
    ranks (``route_rows``'s count, from the buckets in NumPy)."""
    c = _moe_cfg()
    ep = 2
    e_per = c.n_experts_padded // ep
    ep_active = max(1, -(-c.n_experts // e_per))
    b, l, k = sel.shape
    out = []
    for dr in range(2):
        rows = sel[dr * b // 2:(dr + 1) * b // 2] if data_split else sel
        total = 0
        for m in range(ep):
            part = rows[:, m * l // ep:(m + 1) * l // ep] if seq_split else rows
            t = part.shape[0] * part.shape[1]
            cap = max(1, int(t * k * c.moe_capacity_factor) // ep_active)
            per = np.bincount((part.reshape(-1) // e_per), minlength=ep)
            total += int(np.maximum(per - cap, 0).sum())
        out.append(total)
    return out


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_layer_at_ep2_matches_shard_map(runs, name):
    jx, ranks = runs
    b, l = MOE_CASES[name]
    data_split, seq_split = b % 2 == 0, l % 2 == 0
    grid = GridShape((2, 2), ("data", "model"))
    c = _moe_cfg()
    e_per = c.n_experts_padded // 2
    by = {r: grid.coords(r) for r in range(4)}

    def assemble(key):
        """The data ranks' rows, whole: model rank 0's, which the other
        model rank's equal, except the output of the replicated tokens,
        where each rank's windows mask the rows it received from the other
        last (JAX's ``shard_map`` output, declared replicated over
        ``model``, is its first device's)."""
        parts = []
        for dr in range(2):
            mine = [ranks[r][f"moe/{name}/{key}"] for r in range(4) if by[r]["data"] == dr]
            assert np.array_equal(mine[0], mine[1]) or (key == "y" and not seq_split), key
            parts.append(mine[0])
        if not data_split:
            assert np.array_equal(parts[0], parts[1]), key
            return parts[0]
        return np.concatenate(parts)

    for key in ("y", "d_x", "d_w"):
        assert _gap(assemble(key), jx[f"moe/{name}/{key}"]) <= REL, key
    for key in ("d_e_wg", "d_e_wu", "d_e_wd"):
        per_data = [np.concatenate([ranks[r][f"moe/{name}/{key}"] for r in range(4)
                                    if by[r]["data"] == dr]) for dr in range(2)]
        got = per_data[0] + per_data[1] if data_split else per_data[0]
        if not data_split:
            assert np.array_equal(per_data[0], per_data[1]), key
        assert got.shape[0] == 2 * e_per
        assert _gap(got, jx[f"moe/{name}/{key}"]) <= REL, key
    want = _dropped(_moe_inputs(b, l, 20 + list(MOE_CASES).index(name))["sel"], data_split,
                    seq_split)
    got = [int(ranks[r][f"moe/{name}/overflow"]) for r in range(4) if by[r]["model"] == 0]
    assert got == want and min(want) > 0, (got, want)
    if seq_split:
        # the hot expert's rows pass their window of 128 on model rank 0
        assert all(int(ranks[r][f"moe/{name}/masked"]) > 0 for r in range(4)
                   if by[r]["model"] == 0)


def test_microbatched_mesh_step_matches_one_process(runs):
    _, ranks = runs
    one = ranks[0]
    for z in ranks:
        assert abs(float(z["micro/loss"]) - float(one["micro1/loss"])) <= REL * abs(
            float(one["micro1/loss"]))
        assert abs(float(z["micro/gnorm"]) - float(one["micro1/gnorm"])) <= REL * abs(
            float(one["micro1/gnorm"]))
        # remat: each MoE layer routes in its forward and again in its
        # recompute, once a microbatch
        assert int(z["micro/routed_calls"]) == 2 * 2 * _cfg("granite").n_moe_layers
    from repro_torch.convert import lm_params_unshard

    cfg = _cfg("granite")
    grid = GridShape((2, 2), ("data", "model"))
    keys = list(tf.lm_placements(cfg, grid))
    whole = {name: lm_params_unshard([{k: z[f"micro/{name}/{k}"] for k in keys} for z in ranks],
                                     cfg, grid, moments=name != "p") for name in ("p", "mu", "nu")}
    for k in keys:
        mu, nu = one[f"micro1/mu/{k}"], one[f"micro1/nu/{k}"]
        assert _gap(whole["mu"][k], mu) <= REL and _gap(whole["nu"][k], nu) <= 2 * REL, k
        want = one[f"micro1/p/{k}"]
        limit = REL * np.abs(want).max() + _update_slack(mu, nu, np.zeros_like(mu), 1, REL)
        assert (np.abs(whole["p"][k] - want) <= limit).all(), k


def test_zero1_by_blocks_is_bitwise_whole(runs):
    """ZeRO-1 reducing each leaf over ``BLOCK_BYTES`` of float32 a block of
    rows at a time (more reduce-scatters) gives deepseek's first step bit
    for bit: loss, norm, every parameter shard and both moments."""
    _, ranks = runs
    for z in ranks:
        assert int(z["blocks/reduce_scatters"]) > int(z["deepseek/reduce_scatters"]) // STEPS
        assert float(z["blocks/loss"]) == float(z["deepseek/loss0"])
        assert float(z["blocks/gnorm"]) == float(z["deepseek/gnorm0"])
        keys = [k[len("blocks/p/"):] for k in z if k.startswith("blocks/p/")]
        assert keys
        for k in keys:
            for name in ("p", "mu", "nu"):
                assert np.array_equal(z[f"blocks/{name}/{k}"], z[f"deepseek/{name}0/{k}"]), (name, k)
