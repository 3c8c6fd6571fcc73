"""The port's DLRM training and in-place AdamW against the JAX package, on the CPU.

``click_batches`` against JAX's stream bit for bit; the differentiable
``ops.embedding_bag`` against ``jax.vjp`` of ``_embedding_bags`` (repeated
rows, out-of-range ids, multi-hot bags); the touched-row segment sum
against the dense one; one ``dlrm_train_step`` on ``dlrm-smoke`` against
the ``step`` of ``_dlrm_cell(..., smoke=True)`` on a one-device mesh;
``dlrm_flops(train=True)`` against ``_dlrm_flops``; ``adamw_update_``
against ``adamw_update`` bit for bit. Inputs come from NumPy with a seed.

Tolerances. The embedding bag's table gradient: each touched row is a
float64 sum of float32 rows rounded once, where XLA adds in float32 in
its own order: 1e-6 of the largest. A training step in float32:
parameters, moments, loss and gradient norm within 1e-5 relative of each
JAX leaf's largest value (float32 products and sums in another order,
then one AdamW step). ``adamw_update_``: bit for bit (the same arithmetic).
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_arch as j_get_arch
from repro.data.recsys import click_batches as j_click_batches
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import _dlrm_cell, _dlrm_flops
from repro.models import dlrm as jdlrm
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_arch
from repro_torch.convert import dlrm_params_from_numpy
from repro_torch.data import click_batches
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import dlrm
from repro_torch.optim import adamw as adamw_module
from repro_torch.optim import adamw_init, adamw_update, adamw_update_


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


def _close(got: torch.Tensor, want, rel: float) -> None:
    want = _f32(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# the click stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_hot,seed", [(1, 0), (3, 7)])
def test_click_batches_match_jax_bit_for_bit(multi_hot, seed):
    mine = click_batches(13, 5, 1000, 64, multi_hot=multi_hot, seed=seed)
    theirs = j_click_batches(13, 5, 1000, 64, multi_hot=multi_hot, seed=seed)
    for _ in range(3):
        for a, b in zip(next(mine), next(theirs)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


def test_click_ids_are_skewed_toward_row_zero():
    _, ids, _ = next(click_batches(13, 26, 1_000_000, 65_536, seed=0))
    share = float((ids == 0).mean())
    assert 0.028 < share < 0.036   # (1 / 10**6) ** 0.25 = 3.2 %


# ---------------------------------------------------------------------------
# the differentiable embedding bag
# ---------------------------------------------------------------------------

_BAG_CFG = dict(name="bags", n_dense=13, n_sparse=3, embed_dim=4, rows_per_table=20,
                bot_mlp=(8, 4), top_mlp=(8, 1))


def _bag_case(multi_hot, seed, out_of_range):
    rng = np.random.default_rng(seed)
    jcfg = jdlrm.DLRMConfig(multi_hot=multi_hot, **_BAG_CFG)
    v = jcfg.rows_per_table
    tables = rng.normal(size=(jcfg.n_sparse, v, jcfg.embed_dim)).astype(np.float32)
    ids = rng.integers(0, 4, (6, jcfg.n_sparse, multi_hot)).astype(np.int32)  # repeats
    if out_of_range:
        ids[1, 0, 0] = v            # JAX's gather fills NaN; nothing flows back
        ids[4, 2, -1] = v + 3
    cot = rng.normal(size=(6, jcfg.n_sparse, jcfg.embed_dim)).astype(np.float32)
    return jcfg, tables, ids, cot


@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("multi_hot", [1, 3])
def test_embedding_bag_grad_matches_jax(multi_hot, out_of_range):
    jcfg, tables, ids, cot = _bag_case(multi_hot, 3, out_of_range)
    out_j, vjp = jax.vjp(lambda t: jdlrm._embedding_bags({"tables": t}, jnp.asarray(ids), jcfg),
                         jnp.asarray(tables))
    (want,) = vjp(jnp.asarray(cot))
    cfg = dlrm.DLRMConfig(multi_hot=multi_hot, **_BAG_CFG)
    t = torch.from_numpy(tables).requires_grad_()
    out = dlrm._embedding_bags({"tables": t}, torch.from_numpy(ids), cfg, use_kernels=False)
    assert np.array_equal(np.isnan(out.detach().numpy()), np.isnan(np.asarray(out_j)))
    fin = ~np.isnan(np.asarray(out_j))
    assert np.allclose(out.detach().numpy()[fin], np.asarray(out_j)[fin], rtol=1e-6, atol=1e-6)
    out.backward(torch.from_numpy(cot))
    _close(t.grad, want, 1e-6)
    touched = np.zeros(tables.shape[:2], bool)
    for f in range(cfg.n_sparse):
        ok = ids[:, f].ravel() < cfg.rows_per_table
        touched[f, ids[:, f].ravel()[ok]] = True
    assert not t.grad[torch.from_numpy(~touched)].any()   # untouched rows stay zero


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_touched_sum_equals_dense_segment_sum(dtype):
    rng = np.random.default_rng(4)
    n = 500
    ids = rng.integers(-3, n + 3, 3000).astype(np.int32)
    ids[:700] = 7                                               # one heavy row
    rows = torch.from_numpy(rng.normal(size=(3000, 5)).astype(np.float32)).to(dtype)
    ids_t = torch.from_numpy(ids)
    dense = ops.segment_sum(rows, ids_t, n, use_kernels=False)
    touched = ops._touched_sum(rows, ids_t, n, False)
    assert touched.dtype == dtype and torch.equal(touched, dense)


def test_embedding_bag_backward_on_cpu_with_kernels_raises():
    t = torch.zeros((10, 4), requires_grad=True)
    idx = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.embedding_bag(t, idx, idx, 3, use_kernels=True)


def test_serving_forward_keeps_no_graph():
    cfg = get_arch("dlrm-rm2").smoke
    p = dlrm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = {k: v.requires_grad_() for k, v in p.items()}
    dense, sparse = steps.recsys_requests(cfg, 4, 0)
    d, s = torch.from_numpy(dense), torch.from_numpy(sparse)
    served = dlrm.forward(p, d, s, cfg, use_kernels=False)
    trained = dlrm.train_forward(p, d, s, cfg, use_kernels=False)
    assert served.grad_fn is None and trained.grad_fn is not None
    assert torch.equal(served, trained.detach())


# ---------------------------------------------------------------------------
# one training step against _dlrm_cell
# ---------------------------------------------------------------------------

def _j_step_inputs(jcfg, seed):
    params = jdlrm.init_params(jcfg, jax.random.PRNGKey(seed))
    dense, ids, labels = next(j_click_batches(jcfg.n_dense, jcfg.n_sparse, jcfg.rows_per_table,
                                              64, multi_hot=jcfg.multi_hot, seed=seed))
    return params, dense, ids, labels


def test_dlrm_train_step_matches_jax():
    spec = j_get_arch("dlrm-rm2")
    prog = _dlrm_cell(spec, spec.shape("train_batch"), make_local_mesh(1, 1), smoke=True)
    assert prog.args[2].shape[0] == 64
    jparams, dense, ids, labels = _j_step_inputs(spec.smoke, 0)
    jopt = j_adamw_init(jparams)
    cfg = get_arch("dlrm-rm2").smoke
    tparams = dlrm_params_from_numpy(jparams, "cpu")
    topt = adamw_init(tparams)
    step = jax.jit(prog.fn)
    for it in range(2):
        if it:
            _, dense, ids, labels = _j_step_inputs(spec.smoke, it)
        jparams, jopt, jloss, jnorm = step(jparams, jopt, dense, ids, labels)
        tparams, topt, loss, gnorm = steps.dlrm_train_step(
            tparams, topt, torch.from_numpy(dense), torch.from_numpy(ids),
            torch.from_numpy(labels), cfg, use_kernels=False)
        assert int(topt.step) == int(jopt.step) == it + 1
        _close(loss, jloss, 1e-5)
        _close(gnorm, jnorm, 1e-5)
        for k in jparams:
            _close(tparams[k], jparams[k], 1e-5)
            _close(topt.mu[k], jopt.mu[k], 1e-5)
            _close(topt.nu[k], jopt.nu[k], 1e-5)


def test_dlrm_train_step_is_in_place_and_lowers_the_loss():
    cfg = get_arch("dlrm-rm2").smoke
    p = dlrm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    tables = p["tables"]
    opt = adamw_init(p)
    dense, ids, labels = (torch.from_numpy(a) for a in next(click_batches(
        cfg.n_dense, cfg.n_sparse, cfg.rows_per_table, 64, seed=3)))
    losses = []
    for _ in range(20):
        p2, opt2, loss, _ = steps.dlrm_train_step(p, opt, dense, ids, labels, cfg,
                                                  use_kernels=False)
        assert p2 is p and opt2 is opt and p["tables"] is tables
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_dlrm_train_flops_match_jax():
    for cfg, jcfg in ((get_arch("dlrm-rm2").config, j_get_arch("dlrm-rm2").config),
                      (get_arch("dlrm-rm2").smoke, j_get_arch("dlrm-rm2").smoke)):
        for train in (False, True):
            assert steps.dlrm_flops(cfg, 65_536, train=train) == _dlrm_flops(jcfg, 65_536, train)
    shape = get_arch("dlrm-rm2").shape("train_batch")
    assert (shape.kind, shape.batch) == ("recsys_train", 65_536)


# ---------------------------------------------------------------------------
# in-place AdamW
# ---------------------------------------------------------------------------

def _tree(rng, scale, dtypes):
    shapes = {"a_w": (33, 7), "b_b": (5,), "c_w": (40, 3, 2), "d_s": ()}
    return {k: torch.from_numpy(np.asarray(rng.normal(size=s) * scale, dtype=np.float32)).to(dtypes[k])
            for k, s in shapes.items()}


@pytest.mark.parametrize("block_bytes", [64, 1 << 28])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "mixed"])
def test_adamw_update_in_place_is_bitwise_functional(kind, block_bytes, monkeypatch):
    monkeypatch.setattr(adamw_module, "BLOCK_BYTES", block_bytes)
    bf, f = torch.bfloat16, torch.float32
    dtypes = {"float32": dict.fromkeys(("a_w", "b_b", "c_w", "d_s"), f),
              "bfloat16": dict.fromkeys(("a_w", "b_b", "c_w", "d_s"), bf),
              "mixed": {"a_w": f, "b_b": bf, "c_w": bf, "d_s": f}}[kind]
    rng = np.random.default_rng(5)
    p_fun = _tree(rng, 1.0, dtypes)
    p_inp = {k: v.clone() for k, v in p_fun.items()}
    o_fun, o_inp = adamw_init(p_fun), adamw_init(p_inp)
    leaves = {k: v for k, v in p_inp.items()}
    for it, (scale, lr) in enumerate(((3.0, 1e-3), (0.2, torch.tensor(2e-3)), (0.01, 5e-4))):
        g = _tree(rng, scale, dtypes)   # the first clipped, then not
        g_inp = {k: v.clone() for k, v in g.items()}
        p_fun, o_fun, n_fun = adamw_update(p_fun, g, o_fun, lr)
        n_inp = adamw_update_(p_inp, g_inp, o_inp, lr)
        assert torch.equal(n_fun, n_inp) and torch.equal(o_fun.step, o_inp.step)
        clipped = {k: (v.float() * min(1.0, 1.0 / (float(n_fun) + 1e-9))).to(v.dtype)
                   for k, v in g.items()}
        for k in p_fun:
            assert p_inp[k] is leaves[k] and p_inp[k].dtype == dtypes[k]
            assert torch.equal(p_fun[k], p_inp[k]), (it, k)
            assert torch.equal(o_fun.mu[k], o_inp.mu[k]) and torch.equal(o_fun.nu[k], o_inp.nu[k])
            assert torch.allclose(g_inp[k].float(), clipped[k].float(), rtol=1e-2, atol=0)


def test_adamw_update_in_place_rejects_mismatched_leaves():
    p = {"w": torch.zeros(2)}
    with pytest.raises(ValueError, match="different leaves"):
        adamw_update_(p, {"v": torch.zeros(2)}, adamw_init(p), 1e-3)


def test_dlrm_rows_blocked_like_the_tables(monkeypatch):
    """A [F, V, D] leaf is cut along its first axis: the block spans whole
    [V, D] tables, as the 26 x 1,000,000 x 64 tables are at full size."""
    rng = np.random.default_rng(6)
    p = {"tables": torch.from_numpy(rng.normal(size=(6, 50, 4)).astype(np.float32))}
    g = {"tables": torch.from_numpy(rng.normal(size=(6, 50, 4)).astype(np.float32))}
    want, o, n = adamw_update(dict(p), dict(g), adamw_init(p), 1e-3)
    o2 = adamw_init(p)
    monkeypatch.setattr(adamw_module, "BLOCK_BYTES", 50 * 4 * 4 * 2)   # two tables a block
    n2 = adamw_update_(p, g, o2, 1e-3)
    assert torch.equal(n, n2) and torch.equal(want["tables"], p["tables"])
    assert torch.equal(o.mu["tables"], o2.mu["tables"])


def test_norm_of_a_leaf_over_the_norm_block_sums_its_blocks(monkeypatch):
    """Past ``NORM_BLOCK_BYTES`` of float32 a leaf's squares are summed a
    block of rows at a time, the blocks' sums added in order, in the
    functional and the in-place AdamW alike (bit for bit), and the norm
    stays within float32 rounding of the whole-leaf sum."""
    rng = np.random.default_rng(7)
    p = {"w": torch.from_numpy(rng.normal(size=(10, 30, 4)).astype(np.float32)).to(torch.bfloat16),
         "b": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))}
    g = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)).to(v.dtype)
         for k, v in p.items()}
    whole = torch.sqrt(sum(torch.sum(torch.square(g[k].float())) for k in sorted(g)))
    monkeypatch.setattr(adamw_module, "NORM_BLOCK_BYTES", 3 * 30 * 4 * 4)   # three rows a block
    want = torch.sqrt(sum(torch.sum(torch.square(g["w"][i:i + 3].float()))
                          for i in range(0, 10, 3)) + torch.sum(torch.square(g["b"])))
    p_fun, o_fun, n_fun = adamw_update(dict(p), dict(g), adamw_init(p), 1e-3)
    p_inp, g_inp, o_inp = ({k: v.clone() for k, v in t.items()} for t in (p, g, p))
    o_inp = adamw_init(o_inp)
    n_inp = adamw_update_(p_inp, g_inp, o_inp, 1e-3)
    assert torch.equal(n_fun, want) and torch.equal(n_inp, want)
    assert float(abs(n_fun - whole)) <= 1e-6 * float(whole)
    for k in p:
        assert torch.equal(p_fun[k], p_inp[k]) and torch.equal(o_fun.mu[k], o_inp.mu[k])
