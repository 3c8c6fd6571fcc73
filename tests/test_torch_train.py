"""The port's GNN training against the JAX package, on the CPU.

AdamW and its clipping against ``repro.optim`` on identical gradients; the
gradients of ``ops.segment_sum`` and ``ops.gather_rows`` against
``jax.grad`` through ``jax.ops.segment_sum`` and ``jnp.take``; the loss and
every gradient of ``_gnn_cell``'s loss (``forward(..., backend="ref")``
under ``jax.value_and_grad``) for the four smoke GNNs, the JAX parameters
carried across; an ``AdamWState`` carried across; remat on against off,
EquiformerV2's edge chunks, padded edges and a node without in-edges;
the example; the dispatch rules. Inputs come from NumPy with a seed.

Tolerances. The optimizer: 1e-6 relative (float32 sums in another
order). A segment sum's gradient is a gather: exact. A gather's gradient
is a segment sum, float32 rows summed in float64 here and in float32 by
XLA: 1e-6 of the largest; in bfloat16 XLA adds in bfloat16, the port
once rounded: 2e-2 of the largest. Through a model in float32: the loss
within 1e-5 relative, each gradient within 1e-4 of its largest JAX
value plus 1e-6 of the largest JAX gradient of the model, which covers
gradients that are zero in exact arithmetic and rounding noise in both
packages (EquiformerV2's last attention bias shifts every logit of a
head, which the softmax cancels). gatedgcn in bfloat16: the loss within
3e-2 relative; each gradient against its own largest value, with the
ReLU decisions that the packages' roundings flip made equal (see
``test_gatedgcn_bf16_loss_and_grads_match_jax``).
"""

import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

from conftest import REPO, SRC
from repro.configs.registry import GNN_SHAPES as J_GNN_SHAPES
from repro.configs.registry import get_arch as j_get_arch
from repro.data.graphs import build_graph_data as j_build_graph_data
from repro.launch.steps import _gnn_counts, _gnn_flops
from repro.models import gnn as jgnn
from repro.optim import AdamWState as JAdamWState
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import global_norm_clip as j_global_norm_clip
from repro_torch.configs import GNN_SHAPES, get_arch
from repro_torch.convert import adamw_state_from_numpy, gnn_params_from_numpy, graph_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import gnn
from repro_torch.optim import adamw_init, adamw_update, global_norm_clip

ARCHS = ["gatedgcn", "graphsage-reddit", "meshgraphnet", "equiformer-v2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

_SHAPES = {"a_w": (17, 5), "b_b": (5,), "c_w": (3, 4, 2), "d_w": (40, 33)}
_TYPES = {"a_w": jnp.float32, "b_b": jnp.bfloat16, "c_w": jnp.float32, "d_w": jnp.bfloat16}


def _leaves(rng, scale):
    return {k: jnp.asarray(rng.normal(size=s).astype(np.float32) * scale).astype(_TYPES[k])
            for k, s in _SHAPES.items()}


def _close(got: torch.Tensor, want, rel: float) -> None:
    want = _f32(want)
    assert np.abs(_np(got) - want).max() <= rel * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("lr", [1e-3, "tensor"])
def test_adamw_matches_jax(lr):
    rng = np.random.default_rng(0)
    jp = _leaves(rng, 1.0)
    tp = gnn_params_from_numpy(jp, "cpu")
    jo, to = j_adamw_init(jp), adamw_init(tp)
    t_lr = torch.tensor(3e-3) if lr == "tensor" else lr
    j_lr = jnp.float32(3e-3) if lr == "tensor" else lr
    for it, scale in enumerate((3.0, 0.3, 0.05)):   # clipped, then not
        jg = _leaves(rng, scale)
        jp, jo, jn = j_adamw_update(jp, jg, jo, j_lr)
        tp, to, tn = adamw_update(tp, gnn_params_from_numpy(jg, "cpu"), to, t_lr)
        assert int(to.step) == int(jo.step) == it + 1 and to.step.dtype == torch.int32
        _close(tn, jn, 1e-6)
        for k in _SHAPES:
            assert tp[k].dtype == (torch.bfloat16 if _TYPES[k] == jnp.bfloat16 else torch.float32)
            assert to.mu[k].dtype == to.nu[k].dtype == torch.float32
            _close(tp[k], jp[k], 1e-6)
            _close(to.mu[k], jo.mu[k], 1e-6)
            _close(to.nu[k], jo.nu[k], 1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_clip_matches_jax(max_norm):
    jg = _leaves(np.random.default_rng(1), 1.0)
    want, wnorm = j_global_norm_clip(jg, max_norm)
    got, norm = global_norm_clip(gnn_params_from_numpy(jg, "cpu"), max_norm)
    _close(norm, wnorm, 1e-6)
    assert list(got) == sorted(_SHAPES)
    for k in _SHAPES:
        assert got[k].dtype == (torch.bfloat16 if _TYPES[k] == jnp.bfloat16 else torch.float32)
        _close(got[k], want[k], 1e-6)


def test_adamw_update_rejects_mismatched_leaves():
    p = {"w": torch.zeros(2)}
    with pytest.raises(ValueError, match="different leaves"):
        adamw_update(p, {"v": torch.zeros(2)}, adamw_init(p), 1e-3)


# ---------------------------------------------------------------------------
# differentiable segment sum and row gather
# ---------------------------------------------------------------------------

def _ids(rng, kind, e, n):
    if kind == "unsorted":            # random order, duplicates, some segments empty
        return rng.integers(0, n // 2, e).astype(np.int32)
    if kind == "out_of_range":        # id n and id -1 mixed in
        ids = rng.integers(0, n, e)
        ids[rng.random(e) < 0.15] = n
        ids[rng.random(e) < 0.15] = -1
        return ids.astype(np.int32)
    return np.sort(rng.integers(n // 2, n, e)).astype(np.int32)   # sorted, low half empty


@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["unsorted", "out_of_range", "sorted_empty_segments"])
def test_segment_sum_grad_matches_jax(kind, dtype, with_plan):
    rng = np.random.default_rng([len(kind), len(dtype), with_plan])
    e, n, d = 200, 40, 6
    data = rng.normal(size=(e, d)).astype(np.float32)
    cot = rng.normal(size=(n, d)).astype(np.float32)
    ids = _ids(rng, kind, e, n)
    jdt = jnp.dtype(dtype)

    def f(x):
        return jnp.sum(jax.ops.segment_sum(x, jnp.asarray(ids), n).astype(jnp.float32) * cot)

    want = _f32(jax.grad(f)(jnp.asarray(data).astype(jdt)))
    x = torch.from_numpy(data).to(getattr(torch, dtype)).requires_grad_()
    seg = torch.from_numpy(ids)
    plan = ops.segment_plan(seg, n) if with_plan else None
    out = ops.segment_sum(x, seg, n, use_kernels=False, plan=plan)
    assert out.dtype == x.dtype and out.requires_grad
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert x.grad.dtype == x.dtype
    np.testing.assert_array_equal(_np(x.grad), want)
    assert not _np(x.grad)[(ids < 0) | (ids >= n)].any()


def test_segment_sum_keeps_the_float64_sum_on_request():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(50, 4)).astype(np.float32)).requires_grad_()
    seg = torch.from_numpy(rng.integers(0, 9, 50).astype(np.int32))
    out = ops.segment_sum(x, seg, 9, use_kernels=False, dtype=ops.ACC_DTYPE)
    assert out.dtype == ops.ACC_DTYPE
    want = ops.segment_sum(x.detach(), seg, 9, use_kernels=False, acc=torch.zeros(
        (9, 4), dtype=ops.ACC_DTYPE))
    assert torch.equal(out.detach(), want)
    out.sum().backward()
    assert x.grad.dtype == torch.float32 and torch.equal(x.grad, torch.ones_like(x))


@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_grad_matches_jax(dtype, with_plan):
    rng = np.random.default_rng([len(dtype), with_plan])
    n, e = 30, 400
    h = rng.normal(size=(n, 3, 5)).astype(np.float32)
    idx = rng.integers(0, n - 4, e).astype(np.int32)       # the last 4 rows never read
    cot = rng.normal(size=(e, 3, 5)).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def f(x):
        return jnp.sum(jnp.take(x, jnp.asarray(idx), axis=0).astype(jnp.float32) * cot)

    want = _f32(jax.grad(f)(jnp.asarray(h).astype(jdt)))
    x = torch.from_numpy(h).to(getattr(torch, dtype)).requires_grad_()
    t_idx = torch.from_numpy(idx)
    plan = ops.segment_plan(t_idx, n) if with_plan else None
    got = ops.gather_rows(x, t_idx, plan=plan, use_kernels=False)
    assert torch.equal(got.detach(), x.detach()[t_idx.long()])
    (got.float() * torch.from_numpy(cot)).sum().backward()
    assert x.grad.dtype == x.dtype and not x.grad[n - 4:].any()
    tol = 1e-6 if dtype == "float32" else 2e-2
    assert np.abs(_np(x.grad) - want).max() <= tol * np.abs(want).max()


def test_gather_rows_plan_drops_rows_of_zero_gradient():
    rng = np.random.default_rng(4)
    n, e = 20, 120
    x = torch.from_numpy(rng.normal(size=(n, 7)).astype(np.float32)).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dead = torch.from_numpy(rng.random(e) < 0.3)
    cot = torch.from_numpy(rng.normal(size=(e, 7)).astype(np.float32)) * ~dead[:, None]
    grads = []
    for ids in (idx, torch.where(dead, n, idx).to(torch.int32)):
        x.grad = None
        (ops.gather_rows(x, idx, plan=ops.segment_plan(ids, n), use_kernels=False)
         * cot).sum().backward()
        grads.append(x.grad.clone())
    assert torch.equal(grads[0], grads[1])


# ---------------------------------------------------------------------------
# the training step's loss and gradients against JAX
# ---------------------------------------------------------------------------

def _j_value_and_grad(jcfg):
    """``jax.value_and_grad`` of the loss of ``_gnn_cell``'s step, jitted."""
    def loss_fn(p, g, labels):
        out = jgnn.forward(p, g, jcfg, backend="ref")
        if jcfg.d_out > 1:
            lse = jax.nn.logsumexp(out.astype(jnp.float32), axis=-1)
            ll = jnp.take_along_axis(out.astype(jnp.float32), labels[:, None], axis=-1)[:, 0]
            per = lse - ll
        else:
            per = (out[:, 0].astype(jnp.float32) - labels.astype(jnp.float32)) ** 2
        return jnp.sum(per * g.node_mask) / jnp.maximum(g.node_mask.sum(), 1)

    return jax.jit(jax.value_and_grad(loss_fn))


def _case(jcfg, seed=0):
    """The JAX parameters, graph and labels and their port copies (CPU):
    64 nodes and 240 edges padded to 72 and 256; the 16 padded edges point
    at node 71, which has no other in-edge; labels the degree bucket."""
    raw = j_build_graph_data(64, 240, jcfg.d_in, d_edge=jcfg.d_edge_in, seed=seed,
                             pad_nodes=72, pad_edges=256, geometric=True)
    jparams = jgnn.init_params(jcfg, jax.random.PRNGKey(seed))
    jg = jgnn.GraphData(**{k: jnp.asarray(v) for k, v in raw.items()})
    deg = np.bincount(raw["dst"][raw["edge_mask"]], minlength=72)
    labels = (np.minimum(deg, jcfg.d_out - 1) if jcfg.d_out > 1 else deg).astype(np.int32)
    return (jparams, jg, jnp.asarray(labels), gnn_params_from_numpy(jparams, "cpu"),
            graph_from_numpy(raw, "cpu"), torch.from_numpy(labels))


def _port_cfg(jcfg, **kw):
    return gnn.GNNConfig(**{**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(gnn.GNNConfig)}, **kw})


def _grads_close(got, want, share: float, floor: float = 0.0) -> None:
    top = max(np.abs(_f32(v)).max() for v in want.values())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        w = _f32(v)
        assert got[k].dtype == gnn_params_from_numpy({k: v}, "cpu")[k].dtype, k
        assert np.isfinite(_np(got[k])).all(), k
        err = np.abs(_np(got[k]) - w).max()
        assert err <= share * np.abs(w).max() + floor * top, (k, err, np.abs(w).max(), top)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(name):
    jcfg = j_get_arch(name).smoke
    assert jcfg.remat
    jparams, jg, jlabels, params, g, labels = _case(jcfg)
    assert (np.bincount(np.asarray(jg.dst)[np.asarray(jg.edge_mask)], minlength=72)[:64]
            == 0).any(), "no real node without in-edges"
    wloss, wgrads = _j_value_and_grad(jcfg)(jparams, jg, jlabels)
    cfg = get_arch(name).smoke
    assert cfg.remat
    loss, grads = steps.gnn_value_and_grad(params, gnn.train_graph(g, cfg), labels, cfg,
                                           use_kernels=False)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - float(wloss)) <= 1e-5 * abs(float(wloss))
    _grads_close(grads, wgrads, 1e-4, 1e-6)


class _ReluInputs(TorchFunctionMode):
    """Records the input of every ``torch.relu`` call, in call order."""

    def __init__(self):
        super().__init__()
        self.x = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.relu:
            self.x.append(_np(args[0]))
        return func(*args, **(kwargs or {}))


def _j_relu_inputs(jparams, jg, jcfg, monkeypatch):
    """The input of every ``jax.nn.relu`` call of JAX's forward, run op by
    op (``jax.disable_jit``), in call order."""
    got, relu = [], jax.nn.relu

    def recorded(x):
        got.append(_f32(x))
        return relu(x)

    monkeypatch.setattr(jax.nn, "relu", recorded)
    with jax.disable_jit():
        jgnn.forward(jparams, jg, dataclasses.replace(jcfg, remat=False), backend="ref")
    monkeypatch.setattr(jax.nn, "relu", relu)
    return got


def _j_value_and_grad_decided(jcfg, masks, monkeypatch, *args):
    """:func:`_j_value_and_grad` of ``args`` with the i-th ``jax.nn.relu``
    call of the forward (each layer is traced once, remat or not) passing
    its input where ``masks[i]`` holds and 0 elsewhere, its gradient
    likewise."""
    relu, it = jax.nn.relu, iter(masks)
    monkeypatch.setattr(jax.nn, "relu", lambda x: jnp.where(jnp.asarray(next(it)), x, 0))
    out = _j_value_and_grad(jcfg)(*args)
    monkeypatch.setattr(jax.nn, "relu", relu)
    return out


_GATES = ("_A", "_B", "_C")  # gatedgcn's edge-gate weights


def test_gatedgcn_bf16_loss_and_grads_match_jax(monkeypatch):
    """gatedgcn in bfloat16 against JAX, leaf by leaf.

    The two packages round at different points (the port sums segments
    in float64 and rounds once; XLA adds edge by edge in bfloat16), so a
    ReLU input within a rounding of zero can fall on opposite sides, and
    that element's whole gradient then differs. The test shows that this
    is what differs: (1) where the packages' ReLU decisions differ, both
    inputs lie within one bfloat16 spacing of that tensor's largest
    |input|; (2) with JAX's ReLUs taking the port's decisions, every
    gradient but the edge gates' is within 3e-2 of its own largest JAX
    value; (3) the edge gates' gradients (``l*_A``, ``l*_B``, ``l*_C``)
    are differences of terms up to 90 times their size (the gated mean's
    ``(m_k - agg/den) / den``), so a bfloat16 rounding of those terms
    moves them by up to ~18 % in either package: they are held to the
    float32 gradient of the same bfloat16 parameters under the same
    decisions, within 15e-2 of its largest value, the accuracy JAX's own
    bfloat16 gradient has there (up to 14.4e-2 over seeds 0 to 12; the
    port's up to 12.8e-2). ``tests/gatedgcn_bf16_sweep.py`` prints these
    numbers seed by seed."""
    jcfg = dataclasses.replace(j_get_arch("gatedgcn").smoke, dtype="bfloat16")
    jparams, jg, jlabels, params, g, labels = _case(jcfg, seed=1)
    wloss, _ = _j_value_and_grad(jcfg)(jparams, jg, jlabels)
    cfg = _port_cfg(jcfg)
    tg = gnn.train_graph(g, cfg)
    loss, grads = steps.gnn_value_and_grad(params, tg, labels, cfg, use_kernels=False)
    assert all(v.dtype == torch.bfloat16 for v in grads.values())
    assert abs(float(loss) - float(wloss)) <= 3e-2 * abs(float(wloss))

    # (1) the ReLU inputs of both forwards; the port's edges are sorted
    with _ReluInputs() as rec:
        gnn.train_forward(params, tg, dataclasses.replace(cfg, remat=False), use_kernels=False)
    jx = _j_relu_inputs(jparams, jg, jcfg, monkeypatch)
    assert len(rec.x) == len(jx) == 2 * cfg.n_layers
    order = torch.sort(torch.where(g.edge_mask, g.dst, g.n), stable=True)[1].numpy()
    masks, flips = [], 0
    for px, wx in zip(rec.x, jx):
        if px.shape[0] != g.n:     # edge rows: back to JAX's order
            px = px[np.argsort(order)]
        differ = (px > 0) != (wx > 0)
        spacing = 2.0 ** (np.floor(np.log2(np.abs(wx).max())) - 7)
        assert np.abs(px[differ]).max(initial=0) <= spacing
        assert np.abs(wx[differ]).max(initial=0) <= spacing
        flips += int(differ.sum())
        masks.append(px > 0)
    assert flips > 0, "no decision differs: the seed tests nothing of (1)"

    # (2) JAX with the port's decisions; (3) the same in float32
    _, wgrads = _j_value_and_grad_decided(jcfg, masks, monkeypatch, jparams, jg, jlabels)
    _, fgrads = _j_value_and_grad_decided(
        dataclasses.replace(jcfg, dtype="float32"), masks, monkeypatch,
        {k: v.astype(jnp.float32) for k, v in jparams.items()}, jg, jlabels)
    for k in wgrads:
        gate = k.endswith(_GATES)
        want = _f32(fgrads[k] if gate else wgrads[k])
        err = np.abs(_np(grads[k]) - want).max()
        assert err <= (15e-2 if gate else 3e-2) * np.abs(want).max(), (k, err)


def test_adamw_state_carries_across():
    jcfg = j_get_arch("gatedgcn").smoke
    jparams, jg, jlabels, _, _, _ = _case(jcfg, seed=2)
    vg = _j_value_and_grad(jcfg)
    _, jgrads = vg(jparams, jg, jlabels)
    jp1, jo1, _ = j_adamw_update(jparams, jgrads, j_adamw_init(jparams), 1e-3)
    opt = adamw_state_from_numpy(jo1, "cpu")
    assert int(opt.step) == 1 and opt.step.dtype == torch.int32
    back = JAdamWState(step=opt.step.numpy(), mu={k: v.numpy() for k, v in opt.mu.items()},
                       nu={k: v.numpy() for k, v in opt.nu.items()})
    assert back.step.dtype == np.int32 and int(back.step) == 1
    for k in jo1.mu:
        np.testing.assert_array_equal(back.mu[k], np.asarray(jo1.mu[k]))
        np.testing.assert_array_equal(back.nu[k], np.asarray(jo1.nu[k]))
    # the second update on the same gradients, in both packages
    _, jgrads2 = vg(jp1, jg, jlabels)
    jp2, jo2, jn2 = j_adamw_update(jp1, jgrads2, JAdamWState(
        step=jnp.asarray(back.step), mu=back.mu, nu=back.nu), 1e-3)
    tp2, to2, tn2 = adamw_update(gnn_params_from_numpy(jp1, "cpu"),
                                 gnn_params_from_numpy(jgrads2, "cpu"), opt, 1e-3)
    _close(tn2, jn2, 1e-6)
    assert int(to2.step) == int(jo2.step) == 2
    for k in jp2:
        _close(tp2[k], jp2[k], 1e-6)
        _close(to2.mu[k], jo2.mu[k], 1e-6)
        _close(to2.nu[k], jo2.nu[k], 1e-6)


# ---------------------------------------------------------------------------
# remat, chunks, padding, the inference forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_remat_on_equals_off(name):
    _, _, _, params, g, labels = _case(j_get_arch(name).smoke, seed=3)
    cfg = get_arch(name).smoke
    tg = gnn.train_graph(g, cfg)
    on = steps.gnn_value_and_grad(params, tg, labels, cfg, use_kernels=False)
    off = steps.gnn_value_and_grad(params, tg, labels, dataclasses.replace(cfg, remat=False),
                                   use_kernels=False)
    assert torch.equal(on[0], off[0])
    for k in on[1]:
        assert torch.equal(on[1][k], off[1][k]), k


def test_eqv2_chunked_grads_equal_one_chunk():
    _, _, _, params, g, labels = _case(j_get_arch("equiformer-v2").smoke, seed=4)
    cfg = get_arch("equiformer-v2").smoke
    chunked = dataclasses.replace(cfg, edge_chunk=32)
    tg = gnn.train_graph(g, chunked)
    assert len(tg.ed.plans) == 8 and tg.ed.slice_rows == 32
    loss1, g1 = steps.gnn_value_and_grad(params, gnn.train_graph(g, cfg), labels, cfg,
                                         use_kernels=False)
    loss8, g8 = steps.gnn_value_and_grad(params, tg, labels, chunked, use_kernels=False)
    assert abs(float(loss8) - float(loss1)) <= 1e-6 * abs(float(loss1))
    top = max(float(v.abs().max()) for v in g1.values())
    for k in g1:
        assert float((g8[k] - g1[k]).abs().max()) <= 1e-6 * top, k


@pytest.mark.parametrize("name", ARCHS)
def test_padded_edges_carry_zero_gradient(name, monkeypatch):
    """Every gather's gradient is exactly zero on the padded edges' rows,
    so both transposes may drop them; keeping them in the source gathers'
    transpose (ids from the clipped source column, not set to n) changes
    no gradient. For meshgraphnet, whose edges have features, the padded
    edges' features get zero gradient too."""
    _, _, _, params, g, labels = _case(j_get_arch(name).smoke, seed=5)
    cfg = get_arch(name).smoke
    tg = gnn.train_graph(g, cfg)
    pad = tg.ed.seg == g.n
    assert int(pad.sum()) == 16
    padded_rows, backward = [], ops._GatherRows.backward

    def spy(ctx, grad):
        padded_rows.append(grad[pad])
        return backward(ctx, grad)

    monkeypatch.setattr(ops._GatherRows, "backward", staticmethod(spy))
    loss, grads = steps.gnn_value_and_grad(params, tg, labels, cfg, use_kernels=False)
    monkeypatch.undo()
    assert padded_rows and not any(r.any() for r in padded_rows)
    kept = dataclasses.replace(tg, src_plan=ops.segment_plan(tg.ed.src, g.n))
    loss_k, grads_k = steps.gnn_value_and_grad(params, kept, labels, cfg, use_kernels=False)
    assert torch.equal(loss, loss_k)
    for k in grads:
        assert torch.isfinite(grads[k]).all() and torch.equal(grads[k], grads_k[k]), k
    if cfg.d_edge_in:
        attr = g.edge_attr.clone().requires_grad_()
        ga = gnn.train_graph(dataclasses.replace(g, edge_attr=attr), cfg)
        steps.gnn_loss(gnn.train_forward(params, ga, cfg, use_kernels=False), labels,
                       g.node_mask, cfg).backward()
        assert not attr.grad[~g.edge_mask].any() and attr.grad[g.edge_mask].abs().sum() > 0


@pytest.mark.parametrize("name", ARCHS)
def test_train_forward_equals_inference_forward(name):
    _, _, _, params, g, _ = _case(j_get_arch(name).smoke, seed=6)
    cfg = get_arch(name).smoke
    out = gnn.train_forward(params, gnn.train_graph(g, cfg), cfg, use_kernels=False)
    want = gnn.forward(params, g, cfg, use_kernels=False)
    assert out.shape == want.shape and out.dtype == want.dtype
    assert float((out.detach() - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ---------------------------------------------------------------------------
# counts, FLOP, the example, the dispatch rules
# ---------------------------------------------------------------------------

def test_gnn_counts_and_train_flops_match_jax():
    for s, js in zip(GNN_SHAPES, J_GNN_SHAPES):
        assert steps.gnn_counts(s) == _gnn_counts(js, 1, False), s.name
    assert steps.gnn_counts(get_arch("gatedgcn").shape("molecule")) == (3840, 16384)
    assert steps.gnn_counts(get_arch("gatedgcn").shape("minibatch_lg")) == (169_984, 168_960)
    for name in ARCHS:
        cfg = get_arch(name).config
        for train in (False, True):
            assert steps.gnn_flops(cfg, 3840, 16384, train=train) == _gnn_flops(
                j_get_arch(name).config, 3840, 16384, train)
    assert steps.gnn_flops(get_arch("equiformer-v2").config, 3840, 16384,
                           train=True)["model_flops"] == 14_577_202_888_704.0


def test_train_step_moves_params_and_keeps_types():
    _, _, _, params, g, labels = _case(j_get_arch("gatedgcn").smoke, seed=7)
    cfg = dataclasses.replace(get_arch("gatedgcn").smoke, dtype="bfloat16")
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    before = {k: v.clone() for k, v in params.items()}
    p2, o2, loss, gnorm = steps.gnn_train_step(params, adamw_init(params),
                                               gnn.train_graph(g, cfg), labels, cfg,
                                               use_kernels=False)
    assert all(torch.equal(params[k], before[k]) for k in params)   # arguments untouched
    assert all(p2[k].dtype == torch.bfloat16 for k in p2) and int(o2.step) == 1
    assert any(not torch.equal(p2[k], params[k]) for k in params)
    assert bool(torch.isfinite(loss)) and float(gnorm) > 0


@pytest.mark.parametrize("arch", ["gatedgcn", "equiformer-v2"])
def test_example_lowers_the_loss(arch):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, os.path.join(REPO, "examples", "torch_train_gnn.py"),
                          "--device", "cpu", "--arch", arch, "--steps", "8"],
                         env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    first, last = (float(v) for v in out.stdout.strip().splitlines()[-1].split()[1::2])
    assert last < first


def test_kernels_on_cpu_raise():
    _, _, _, params, g, labels = _case(j_get_arch("gatedgcn").smoke, seed=8)
    cfg = get_arch("gatedgcn").smoke
    with pytest.raises(ValueError, match="CUDA"):
        steps.gnn_value_and_grad(params, gnn.train_graph(g, cfg), labels, cfg, use_kernels=True)
    x = torch.ones((4, 2), requires_grad=True)
    ids = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.segment_sum(x, ids, 3, use_kernels=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.gather_rows(x, ids, use_kernels=True)
    # each backward checks the gradient it is handed
    ctx = types.SimpleNamespace(saved_tensors=(ids,), n=3, dtype=torch.float32, plan=None,
                                use_kernels=True)
    for fn in (ops._SegmentSum, ops._GatherRows):
        with pytest.raises(ValueError, match="CUDA"):
            fn.backward(ctx, torch.ones((3 if fn is ops._SegmentSum else 4, 2)))
