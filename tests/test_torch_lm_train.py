"""The port's LM training and its stack against the JAX package, on the CPU.

The plain attention backward against ``jax.vjp`` of JAX's ``_attention``
(ref backend, query chunks that do not divide the length) and torch
autograd of ``flash_attention_ref``; one ``lm_train_step`` on the
phi4-mini smoke config against ``_lm_cell``'s step (a small train shape,
a one-device mesh) in float32 and bfloat16; the microbatch path at
``n_micro`` 2 and 4 against the same accumulation written with JAX's
``forward`` and ``cross_entropy``; ``warmup_cosine``, ``token_batches``,
``prefetch`` and ``StragglerMonitor`` against JAX's; checkpoints written by
each package restored by the other, bf16 leaves included, and a torn file
falling back; the training driver run and resumed. Inputs come from NumPy
with a seed.

Tolerances. The attention backward in float32: 1e-5 of each gradient's
largest value (float32 products and sums in another order; JAX masks with
-1e30 where the port uses -inf, which gives the same zero probabilities).
A training step in float32: every parameter, the first moment, the loss
and the norm within 1e-5 relative of the JAX leaf's largest value; in
bfloat16 within 3e-2 of it (the two packages round products and sums to
bfloat16 in different places, and XLA adds the embedding's transpose in
bfloat16 where the port sums in float64 and rounds once, as in
tests/test_torch_train.py). The second moment is (1 - b2) g² at the first
step: it is held to twice the limit, the relative gap of a square. The
microbatched gradients: 1e-5, as one step. ``warmup_cosine``: 1e-6 relative (float32
cosines of two libraries); the token stream and the monitor: exact.
"""

import dataclasses
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import REPO, SRC
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import restore_pytree as j_restore_pytree
from repro.checkpoint import save_pytree as j_save_pytree
from repro.configs.registry import ShapeSpec as JShapeSpec
from repro.configs.registry import get_arch as j_get_arch
from repro.data.pipeline import prefetch as j_prefetch
from repro.data.tokens import token_batches as j_token_batches
from repro.dist.straggler import StragglerMonitor as JStragglerMonitor
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import _lm_cell, _lm_flops
from repro.models import transformer as jtf
from repro.models.common import cross_entropy as j_cross_entropy
from repro.optim import adamw_init as j_adamw_init
from repro.optim import warmup_cosine as j_warmup_cosine
from repro_torch.checkpoint import CheckpointManager, restore_pytree, save_pytree
from repro_torch.configs import LM_SHAPES, get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import prefetch, token_batches
from repro_torch.dist import StragglerMonitor
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.launch import train as train_driver
from repro_torch.models import transformer as tf
from repro_torch.models.common import cross_entropy
from repro_torch.optim import adamw_init, warmup_cosine


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


def _flat_j(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat_j(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tree[k]
    return out


# ---------------------------------------------------------------------------
# the attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hq,hkv,l,chunk", [(2, 6, 2, 37, 16), (1, 4, 4, 50, 16),
                                              (1, 8, 1, 23, 8), (2, 3, 3, 1, 16)])
def test_attention_bwd_ref_matches_jax_and_autograd(b, hq, hkv, l, chunk):
    dh = 8
    rng = np.random.default_rng(l)
    q, dout = (rng.normal(size=(b, hq, l, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, hkv, l, dh)).astype(np.float32) for _ in range(2))
    jcfg = dataclasses.replace(j_get_arch("phi4-mini-3.8b").smoke, q_chunk=chunk)
    _, vjp = jax.vjp(lambda a, b_, c: jtf._attention(a, b_, c, jcfg, q_offset=0),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    got = ref.flash_attention_bwd_ref(*(torch.from_numpy(x) for x in (q, k, v, dout)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ref.flash_attention_ref(*ts).backward(torch.from_numpy(dout))
    for g, w, a in zip(got, want, ts):
        _close(g, w, 1e-5)
        _close(g, a.grad.numpy(), 1e-5)


@pytest.mark.parametrize("causal,q_offset,lk", [(True, 5, 30), (False, 0, 19)])
def test_attention_bwd_ref_with_offsets_matches_autograd(causal, q_offset, lk):
    rng = np.random.default_rng(1)
    q, dout = (torch.from_numpy(rng.normal(size=(1, 4, 17, 8)).astype(np.float32))
               for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(1, 2, lk, 8)).astype(np.float32))
            for _ in range(2))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*ts, causal=causal, q_offset=q_offset,
                        use_kernels=False).backward(dout)
    want = [t.grad for t in ts]
    ts2 = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.flash_attention_ref(*ts2, causal=causal, q_offset=q_offset).backward(dout)
    for a, b_ in zip(want, ts2):
        assert torch.allclose(a, b_.grad, rtol=0, atol=1e-5 * float(b_.grad.abs().max()))


def test_attention_grad_needs_cuda_for_kernels():
    q = torch.zeros((1, 2, 20, 64), requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q, use_kernels=True)


def test_serving_launches_no_backward():
    assert "flash_attention_bwd" in ops.launch_counts()
    cfg = get_arch("phi4-mini-3.8b").smoke
    p = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for t in steps.flat_params(p).values():
        t.requires_grad_()
    out = tf.forward(p, torch.randint(0, cfg.vocab, (2, 9)), cfg, use_kernels=False)
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# one training step against _lm_cell
# ---------------------------------------------------------------------------

_SMALL_TRAIN = JShapeSpec(name="train_small", kind="train", seq_len=12, global_batch=2)


def _lm_step_case(dtype: str):
    jspec = j_get_arch("phi4-mini-3.8b")
    jspec = dataclasses.replace(jspec, smoke=dataclasses.replace(jspec.smoke, dtype=dtype))
    prog = _lm_cell(jspec, _SMALL_TRAIN, make_local_mesh(1, 1), smoke=True)
    jparams = jtf.init_params(jspec.smoke, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_arch("phi4-mini-3.8b").smoke, dtype=dtype)
    return prog, jparams, cfg


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_lm_train_step_matches_jax(dtype, rel):
    prog, jparams, cfg = _lm_step_case(dtype)
    jopt = j_adamw_init(jparams)
    tparams = lm_params_from_numpy(jparams, "cpu")
    topt = adamw_init(steps.flat_params(tparams))
    step = jax.jit(prog.fn)
    stream = token_batches(cfg.vocab, 2, _SMALL_TRAIN.seq_len, seed=3)
    for it in range(2):
        toks, labels = next(stream)
        jparams, jopt, jloss, jnorm = step(jparams, jopt, toks, labels)
        tparams, topt, loss, gnorm = steps.lm_train_step(
            tparams, topt, torch.from_numpy(toks), torch.from_numpy(labels), cfg,
            use_kernels=False)
        assert int(topt.step) == int(jopt.step) == it + 1
        _close(loss, jloss, rel)
        _close(gnorm, jnorm, rel)
        flat_t, flat_j = steps.flat_params(tparams), _flat_j(jparams)
        mu_j, nu_j = _flat_j(jopt.mu), _flat_j(jopt.nu)
        assert sorted(flat_t) == sorted(flat_j) == sorted(topt.mu)
        for k in flat_j:
            assert flat_t[k].dtype == cfg.tdtype and topt.mu[k].dtype == torch.float32
            _close(flat_t[k], flat_j[k], rel)
            _close(topt.mu[k], mu_j[k], rel)
            _close(topt.nu[k], nu_j[k], 2 * rel)   # squares the gradient: twice its gap


def test_lm_micro_batches_and_flops_match_jax():
    cfg, jcfg = get_arch("phi4-mini-3.8b").config, j_get_arch("phi4-mini-3.8b").config
    for b, want in ((2, 1), (256, 128), (8, 4)):
        assert steps.lm_micro_batches(cfg, b, 4096) == want
    assert steps.lm_micro_batches(get_arch("phi4-mini-3.8b").smoke, 2, 12) == 1
    for shape in LM_SHAPES:
        jshape = j_get_arch("phi4-mini-3.8b").shape(shape.name)
        assert steps.lm_flops(cfg, shape) == _lm_flops(jcfg, jshape)
    mla = (get_arch("minicpm3-4b").config, j_get_arch("minicpm3-4b").config)
    for shape in LM_SHAPES:
        assert steps.lm_flops(mla[0], shape) == _lm_flops(mla[1], shape)


@pytest.mark.parametrize("n_micro", [2, 4])
def test_microbatched_gradient_matches_jax(n_micro):
    _, jparams, cfg = _lm_step_case("float32")
    jcfg = j_get_arch("phi4-mini-3.8b").smoke
    toks, labels = next(j_token_batches(cfg.vocab, 4, 10, seed=5))

    def loss_fn(p, t, lab):
        return j_cross_entropy(jtf.forward(p, t, jcfg, None), lab)

    acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jparams)
    losses = []
    for t, lab in zip(np.split(toks, n_micro), np.split(labels, n_micro)):
        li, gi = jax.value_and_grad(loss_fn)(jparams, t, lab)
        acc = jax.tree.map(lambda a, g: a + g.astype(jnp.float32), acc, gi)
        losses.append(li)
    want = jax.tree.map(lambda g, p: (g / n_micro).astype(p.dtype), acc, jparams)
    loss, grads = steps.lm_value_and_grad(lm_params_from_numpy(jparams, "cpu"),
                                          torch.from_numpy(toks), torch.from_numpy(labels), cfg,
                                          use_kernels=False, n_micro=n_micro)
    _close(loss, jnp.mean(jnp.stack(losses)), 1e-5)
    flat_w = _flat_j(want)
    assert sorted(grads) == sorted(flat_w)
    for k, w in flat_w.items():
        _close(grads[k], w, 1e-5)


def test_train_forward_equals_serving_forward_and_remat():
    cfg = get_arch("phi4-mini-3.8b").smoke
    p = tf.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 11), generator=torch.Generator().manual_seed(3))
    served = tf.forward(p, toks, cfg, use_kernels=False)
    trained = tf.train_forward(p, toks, cfg, use_kernels=False)
    assert torch.equal(served, trained)
    labels = torch.roll(toks, -1, 1)
    on = steps.lm_value_and_grad(p, toks, labels, dataclasses.replace(cfg, remat=True),
                                 use_kernels=False)
    off = steps.lm_value_and_grad(p, toks, labels, cfg, use_kernels=False)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(on[1][k], off[1][k]) for k in off[1])


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    got = cross_entropy(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    want = j_cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)


# ---------------------------------------------------------------------------
# schedule, token stream, prefetcher, straggler monitor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total,floor", [(10, 100, 0.0), (0, 7, 1e-5), (5, 5, 0.0)])
def test_warmup_cosine_matches_jax(warmup, total, floor):
    for step in (0, 1, 4, 5, 9, 10, 11, 50, 99, 100, 140):
        want = float(j_warmup_cosine(step, peak=3e-4, warmup=warmup, total=total, floor=floor))
        got = warmup_cosine(step, peak=3e-4, warmup=warmup, total=total, floor=floor)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12)
        t = warmup_cosine(torch.tensor(step), peak=3e-4, warmup=warmup, total=total, floor=floor)
        assert t.dim() == 0 and t.dtype == torch.float32 and float(t) == got


def test_token_batches_match_jax_bit_for_bit():
    mine, theirs = token_batches(1000, 3, 17, seed=4), j_token_batches(1000, 3, 17, seed=4)
    for _ in range(3):
        (a, b_), (c, d) = next(mine), next(theirs)
        assert a.dtype == c.dtype == np.int32
        assert np.array_equal(a, c) and np.array_equal(b_, d)
        assert np.array_equal(a[:, 1:], b_[:, :-1])


def test_prefetch_matches_jax():
    assert list(prefetch(iter(range(10)), depth=2)) == list(j_prefetch(iter(range(10)), depth=2))
    slow = (time.sleep(0.01) or i for i in range(5))
    assert list(prefetch(slow, depth=1)) == list(range(5))


def test_straggler_monitor_matches_jax():
    mine, theirs = StragglerMonitor(4, window=3, threshold=1.5), JStragglerMonitor(4, 3, 1.5)
    assert mine.stragglers() == theirs.stragglers() == []
    rng = np.random.default_rng(2)
    for i in range(6):
        t = rng.uniform(0.9, 1.1, 4)
        if i >= 3:
            t[2] = 2.0
        mine.record(t)
        theirs.record(t)
        assert np.array_equal(mine.means(), theirs.means())
        assert mine.stragglers() == theirs.stragglers()
    assert mine.stragglers() == [2]


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------

def _j_state():
    jcfg = dataclasses.replace(j_get_arch("phi4-mini-3.8b").smoke, dtype="bfloat16")
    params = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    opt = j_adamw_init(params)
    opt = type(opt)(step=jnp.int32(7), mu=jax.tree.map(lambda z: z + 0.5, opt.mu),
                    nu=jax.tree.map(lambda z: z + 0.25, opt.nu))
    return {"params": params, "opt": opt}


def _t_template():
    cfg = dataclasses.replace(get_arch("phi4-mini-3.8b").smoke, dtype="bfloat16")
    params = tf.init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    return {"params": params, "opt": adamw_init(steps.flat_params(params))}


def _assert_same_state(t_state, j_state):
    flat_t, flat_j = steps.flat_params(t_state["params"]), _flat_j(j_state["params"])
    assert sorted(flat_t) == sorted(flat_j)
    for k, w in flat_j.items():
        assert flat_t[k].dtype == torch.bfloat16
        assert np.array_equal(flat_t[k].float().numpy(), _f32(w))
    assert int(t_state["opt"].step) == int(j_state["opt"].step)
    for mom_t, mom_j in ((t_state["opt"].mu, j_state["opt"].mu),
                         (t_state["opt"].nu, j_state["opt"].nu)):
        for k, w in _flat_j(mom_j).items():
            assert np.array_equal(mom_t[k].numpy(), _f32(w))


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    j_state = _j_state()
    path = str(tmp_path / "step_7.npz")
    j_save_pytree(j_state, path)
    _assert_same_state(restore_pytree(_t_template(), path), j_state)


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    j_state = _j_state()
    t_state = restore_pytree(_t_template(), _save_j(j_state, tmp_path))
    path = str(tmp_path / "port.npz")
    save_pytree(t_state, path)
    with np.load(path) as data:
        keys = sorted(data.files)
    j_path = str(tmp_path / "jax.npz")
    j_save_pytree(j_state, j_path)
    with np.load(j_path) as data:
        assert keys == sorted(data.files)       # the same keys, '::bf16' included
    back = j_restore_pytree(jax.tree.map(jnp.zeros_like, j_state), path)
    for a, b_ in zip(jax.tree.leaves(back), jax.tree.leaves(j_state)):
        assert a.dtype == b_.dtype and np.array_equal(_f32(a), _f32(b_))


def _save_j(j_state, tmp_path):
    path = str(tmp_path / "from_jax.npz")
    j_save_pytree(j_state, path)
    return path


def test_torn_checkpoint_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _t_template()
    for s in (1, 2, 3):
        state["opt"].step.fill_(s)
        mgr.save(s, state)
    assert sorted(os.listdir(tmp_path)) == ["step_2.npz", "step_3.npz"]   # keep-last-2
    with open(mgr.path(3), "r+b") as f:
        f.truncate(100)
    step, back = mgr.restore_latest(_t_template())
    assert step == 2 and int(back["opt"].step) == 2
    # JAX's manager reads the port's files and makes the same choice
    j_step, _ = JCheckpointManager(str(tmp_path), keep=2).restore_latest(
        jax.tree.map(jnp.zeros_like, _j_state()))
    assert j_step == 2
    with pytest.raises(ValueError, match="shape"):
        bad = _t_template()
        bad["params"]["embed"] = torch.zeros((3, 3), dtype=torch.bfloat16)
        restore_pytree(bad, mgr.path(2))


# ---------------------------------------------------------------------------
# the training driver
# ---------------------------------------------------------------------------

def test_train_driver_runs_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
           "--ckpt-dir", str(tmp_path), "--ckpt-every", "1", "--batch", "2", "--seq", "16"]
    first = subprocess.run(cmd + ["--steps", "2"], env=env, cwd=REPO, capture_output=True,
                           text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    assert "step 1: loss=" in first.stdout and first.stdout.rstrip().endswith("done")
    assert sorted(os.listdir(tmp_path)) == ["step_1.npz", "step_2.npz"]
    again = subprocess.run(cmd + ["--steps", "3"], env=env, cwd=REPO, capture_output=True,
                           text=True, timeout=300)
    assert again.returncode == 0, again.stderr
    assert "resumed from checkpoint step 2" in again.stdout
    assert "step 2: loss=" in again.stdout and "step 1:" not in again.stdout


def test_train_driver_refuses_other_families(capsys):
    with pytest.raises(SystemExit):
        train_driver.main(["--arch", "dlrm-rm2", "--smoke", "--device", "cpu"])
    assert "LM archs" in capsys.readouterr().err


def test_train_driver_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_driver.main(["--smoke", "--ckpt-dir", str(tmp_path)])
    assert math.isfinite(train_driver.main(["--smoke", "--device", "cpu", "--steps", "1",
                                            "--ckpt-dir", str(tmp_path), "--batch", "2",
                                            "--seq", "8"])[0])
