"""The port's MLA and mixture-of-experts training against the JAX package, on the CPU.

Two ``lm_train_step``s of the minicpm3-4b (MLA), granite-moe-3b-a800m (GQA +
MoE) and deepseek-v2-lite-16b (MLA + MoE, a dense first layer, shared
experts) smoke configs against ``_lm_cell``'s step on a one-device mesh
(``make_local_mesh(1, 1)``), whose MoE layers take ``_moe_routed`` at ep =
1; one MoE layer with an expert loaded past its window against JAX's
``_moe_ffn`` on that mesh and against the dense serving sum; the plain
attention backward at MLA's widths (V narrower than Q and K) against
``jax.vjp`` of JAX's ``_attention`` and torch autograd, and the tensor-core
backward's mirror at (96, 64) within the card's limits; ``bwd_route`` at
those widths; remat against no remat, and the recompute's routing; the
training driver on MLA and MoE archs. Inputs come from NumPy or JAX with a
seed.

Tolerances. Loss, gradient norm and the first moment (the gradient) as
``test_torch_lm_train.py`` holds them: 1e-5 relative of the JAX value's
largest magnitude in float32, 3e-2 in bf16; the second moment twice that
(a square). The parameters to the same share of the leaf's largest value
plus what AdamW's division makes of the gradient's share, step by step
(:func:`_update_slack`): where an element's gradient is near AdamW's eps,
``g / (|g| + eps)`` turns a gap of float32 rounding in ``g`` into a large
one in the update (deepseek's ``moe/s_wd`` has an element whose gradient,
-2.65e-8 here and -2.34e-8 in JAX out of a largest 0.155, moves the first
update by 7.6e-6 of a largest parameter 0.4). In bf16 each moment is held
to 3e-2 (twice for the second), or, where JAX's own bf16 moment lies further
from the float32 reference (the port's float32 step from the same
parameters on the same routing decisions, itself held to JAX's float32 step
in the float32 cases), to 1.5 times that gap: both packages round the
gradient to bf16 in many places, and in these MLA models their bf16
gradients lie up to ~4e-2 of a leaf's largest value from float32 (JAX's
``dense/wq_b`` of minicpm3 3.4e-2, the port's 2.7e-2 at the first step),
so 3e-2 between the two is not owed where either is further than that from
the exact value (1.5 is ``test_torch_mla_moe.BF16_NO_WORSE``). The bf16 MoE
runs take the port's routing decisions in JAX too, through an ordered host
callback, and every decision JAX would take otherwise must be a near-tie
(``test_torch_mla_moe.TIE_SPACINGS``). The attention backward: 1e-5 of each
gradient's largest value, as in ``test_torch_lm_train.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import io_callback
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs.registry import ShapeSpec as JShapeSpec
from repro.configs.registry import get_arch as j_get_arch
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import _lm_cell
from repro.models import transformer as jtf
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import token_batches
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import bwd_route
from repro_torch.launch import steps
from repro_torch.launch import train as train_driver
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_init
from test_torch_mla_moe import BF16_NO_WORSE, _check_near_ties, _jit, _near_tie

ARCHS = ("minicpm3-4b", "granite-moe-3b-a800m", "deepseek-v2-lite-16b")
TRAIN = JShapeSpec(name="train_small", kind="train", seq_len=12, global_batch=2)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
LR, B1, B2, EPS = 3e-4, 0.9, 0.95, 1e-8  # _lm_cell's step: adamw_update's defaults


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _gap(got, want) -> float:
    """max |got − want| over the largest |want|."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close(got, want, rel: float, what: str = "") -> None:
    gap = _gap(got, want)
    assert gap <= rel, f"{what}: {gap} > {rel}"


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = _f32(tree[k])
    return out


def _update_slack(mu, nu, mu_prev, t: int, rel: float) -> np.ndarray:
    """How far AdamW's step ``t`` update ``lr · m̂ / (√v̂ + eps)`` of each
    element may move when every gradient of the leaf moves by up to ``rel``
    of the leaf's largest gradient: ``m̂`` and ``√v̂`` move by at most that
    much, ``γ``, so the quotient by ``γ / (√v̂ + eps) + |m̂| γ / (√v̂ +
    eps)²``, and never by more than 2 (its sign). From JAX's moments after
    step ``t`` (and ``t − 1``, whose difference gives the step's gradient)."""
    g = (mu - B1 * mu_prev) / (1 - B1)
    gamma = rel * max(np.abs(g).max(), np.abs(mu_prev).max() / (1 - B1))
    m = mu / (1 - B1 ** t)
    s = np.sqrt(nu / (1 - B2 ** t)) + EPS
    return LR * np.minimum(2.0, gamma / s + np.abs(m) * gamma / s ** 2)


class _PortRouting:
    """The port's ``_moe_route``, spied: it records each call's router
    logits (in the model's type) and chosen experts while ``replay`` is
    None, and otherwise takes the decisions of ``replay``, an iterator of
    such records, weighted by its own probabilities of those experts (the
    float32 reference run on the bf16 run's decisions)."""

    def __init__(self, monkeypatch):
        self.calls, self.replay, self.inner = [], None, tf._moe_route
        monkeypatch.setattr(tf, "_moe_route", self)

    def __call__(self, lp, x, c):
        if self.replay is None:
            w, sel = self.inner(lp, x, c)
            self.calls.append(((x @ lp["router"]).detach().float().numpy(),
                               sel.numpy().astype(np.int32)))
            return w, sel
        sel = torch.from_numpy(next(self.replay)[1]).long()
        return tf._route_weights(tf._router_probs(lp, x), sel), sel


def _force_jax_decisions(monkeypatch, calls, flips):
    """JAX's ``top_k`` takes the recorded decisions, call by call, through an
    ordered host callback on the probabilities with their gradient stopped
    (the decisions are integers); its weights are its own probabilities of
    those experts, so the router's gradient flows through them as through
    ``top_k``'s values. Rows where JAX would choose otherwise go into
    ``flips``."""
    queue = iter(calls)

    def host(probs):
        probs = np.asarray(probs)
        logits, sel = next(queue)
        own = np.argsort(-probs, axis=-1, kind="stable")[:, :sel.shape[1]]
        _near_tie(np.log(probs.astype(np.float64)), own, logits, sel, flips)
        return sel

    def top_k(probs, k):
        flat = jax.lax.stop_gradient(probs.reshape(-1, probs.shape[-1]))
        sel = io_callback(host, jax.ShapeDtypeStruct((flat.shape[0], k), jnp.int32), flat,
                          ordered=True).reshape(probs.shape[:-1] + (k,))
        return jnp.take_along_axis(probs, sel, axis=-1), sel

    monkeypatch.setattr(jax.lax, "top_k", top_k)


# ---------------------------------------------------------------------------
# two training steps against _lm_cell's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_step_matches_jax(monkeypatch, arch, dtype):
    rel = TOL[dtype]
    bf16 = dtype == "bfloat16"
    jspec = j_get_arch(arch)
    jspec = dataclasses.replace(jspec, smoke=dataclasses.replace(jspec.smoke, dtype=dtype))
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=dtype)
    routing, flips = _PortRouting(monkeypatch), []
    if bf16 and cfg.moe:
        _force_jax_decisions(monkeypatch, routing.calls, flips)
    mesh = make_local_mesh(1, 1)
    prog = _lm_cell(jspec, TRAIN, mesh, smoke=True)
    jparams = jtf.init_params(jspec.smoke, jax.random.PRNGKey(0))
    tparams = lm_params_from_numpy(jparams, "cpu")
    # the step's outputs are placed on the mesh: so are its first inputs, or
    # the second call compiles again
    jparams, jopt = jax.device_put((jparams, j_adamw_init(jparams)), NamedSharding(mesh, P()))
    topt = adamw_init(steps.flat_params(tparams))
    # bf16: the float32 reference, the port's float32 step (held to JAX's
    # below) from the same parameters on the bf16 run's routing decisions
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ref_params = {g: ({n: t.float() for n, t in v.items()} if isinstance(v, dict) else v.float())
                  for g, v in tparams.items()}
    ref_opt = adamw_init(steps.flat_params(ref_params))
    step = _jit(prog.fn)
    stream = token_batches(cfg.vocab, TRAIN.global_batch, TRAIN.seq_len, seed=3)
    slack = {k: 0.0 for k in steps.flat_params(tparams)}
    mu_prev = {k: np.zeros(v.shape, np.float32) for k, v in steps.flat_params(tparams).items()}
    for it in range(2):
        toks, labels = next(stream)
        tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)
        first = len(routing.calls)
        tparams, topt, loss, gnorm = steps.lm_train_step(tparams, topt, tt, tl, cfg,
                                                         use_kernels=False)
        jparams, jopt, jloss, jnorm = step(jparams, jopt, toks, labels)
        if bf16:
            routing.replay = iter(routing.calls[first:])
            steps.lm_train_step(ref_params, ref_opt, tt, tl, cfg32, use_kernels=False)
            routing.replay = None
        assert int(topt.step) == int(jopt.step) == it + 1
        _close(loss, jloss, rel, "loss")
        _close(gnorm, jnorm, rel, "gnorm")
        flat_t, flat_j = steps.flat_params(tparams), _flat(jparams)
        mu_j, nu_j = _flat(jopt.mu), _flat(jopt.nu)
        assert sorted(flat_t) == sorted(flat_j) == sorted(topt.mu)
        for k in flat_j:
            assert flat_t[k].dtype == cfg.tdtype and topt.mu[k].dtype == torch.float32
            for name, got, want, tol in (("mu", topt.mu[k], mu_j[k], rel),
                                         ("nu", topt.nu[k], nu_j[k], 2 * rel)):
                if bf16:
                    # no closer to JAX is owed than JAX lies to the float32
                    # reference: BF16_NO_WORSE times its gap where larger
                    want32 = getattr(ref_opt, name)[k]
                    tol = max(tol, BF16_NO_WORSE * _gap(want, want32))
                _close(got, want, tol, f"{name} {k}")
            slack[k] = slack[k] + _update_slack(mu_j[k], nu_j[k], mu_prev[k], it + 1, rel)
            gap = np.abs(_f32(flat_t[k]) - flat_j[k])
            limit = rel * np.abs(flat_j[k]).max() + slack[k]
            assert (gap <= limit).all(), (k, float((gap / limit).max()))
        mu_prev = mu_j
    if bf16 and cfg.moe:
        # two steps, each MoE layer routed once a step (no remat at smoke size)
        assert len(routing.calls) == 2 * cfg.n_moe_layers
        _check_near_ties(flips)


# ---------------------------------------------------------------------------
# the expert window of _moe_routed
# ---------------------------------------------------------------------------

def test_moe_window_masks_the_rows_jax_masks():
    """One granite smoke MoE layer on 200 tokens (400 routed rows: 800 with
    the exchange's padding, a window of 128) whose router sends nearly every
    token to expert 0 first and expert 1 second: the rows of each past its
    window are zero in JAX's ``_moe_routed`` and in the port's, which agree
    within 1e-5; the dense serving sum (JAX's without a mesh and the
    port's) differs from them by exactly those rows' weighted outputs."""
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m").smoke, dtype="float32")
    jcfg = dataclasses.replace(j_get_arch("granite-moe-3b-a800m").smoke, dtype="float32")
    rng = np.random.default_rng(11)
    jlp = {n: rng.normal(size=s[1:]).astype(np.float32) / np.float32(math.sqrt(s[-2]))
           for n, s in tf.param_shapes(cfg)["moe"].items() if n in ("router", "e_wg", "e_wu",
                                                                    "e_wd")}
    jlp["router"][0] += np.array([2.0, 1.0, 0.0, 0.0, 0.0], np.float32)
    t, d, k = 200, cfg.d_model, cfg.top_k
    x = rng.normal(size=(1, t, d)).astype(np.float32)
    x[..., 0] = 4.0
    lp = {n: torch.from_numpy(a) for n, a in jlp.items()}
    xt = torch.from_numpy(x)
    mesh = make_local_mesh(1, 1)
    j_routed = jax.jit(lambda p, a: jtf._moe_ffn(p, a, jcfg, mesh))(jlp, x)
    j_dense = jax.jit(lambda p, a: jtf._moe_ffn(p, a, jcfg, None))(jlp, x)
    routed = tf._moe_ffn(lp, xt, cfg, routed=True)
    dense = tf._moe_ffn(lp, xt, cfg)
    _close(routed, j_routed, 1e-5, "routed")
    _close(dense, j_dense, 1e-5, "dense")

    # the rows past each expert's window, from the routing
    weights, sel = tf._moe_route(lp, xt[0], cfg)
    total, window = tf.moe_window(cfg, t)
    assert (total, window) == (2 * t * k, 128)
    counts = np.bincount(sel.reshape(-1).numpy(), minlength=cfg.n_experts_padded).tolist()
    kept = tf.moe_windows(counts, total, window)
    assert counts[0] > window and counts[1] > window and sum(counts) - sum(kept) > 0
    missing = torch.zeros(t, d)
    for e, nk in enumerate(kept):
        rows = [r for r in range(t * k) if int(sel.reshape(-1)[r]) == e][nk:]
        for r in rows:
            tok, j = divmod(r, k)
            y = (torch.nn.functional.silu(xt[0, tok] @ lp["e_wg"][e]) * (xt[0, tok] @ lp["e_wu"][e])
                 ) @ lp["e_wd"][e]
            missing[tok] += weights[tok, j] * y
    masked = missing.abs().amax(-1) > 0
    assert 0 < int(masked.sum()) < t
    scale = float(np.abs(_f32(j_dense)).max())
    for got, want in ((routed, dense), (_f32(j_routed), _f32(j_dense))):
        diff = torch.from_numpy(_f32(want) - _f32(got))[0]
        assert float((diff - missing).abs().max()) <= 1e-5 * scale
        assert bool((diff.abs().amax(-1)[masked] > 1e-3 * scale).all())
        assert float(diff[~masked].abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# the attention backward at MLA's widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dqk,dv,b,hq,hkv,l", [(24, 16, 2, 4, 4, 37), (96, 64, 1, 4, 4, 50),
                                               (96, 64, 2, 6, 2, 23)])
def test_attention_bwd_ref_at_mla_widths_matches_jax_and_autograd(dqk, dv, b, hq, hkv, l):
    rng = np.random.default_rng([dqk, dv, l])
    q = rng.normal(size=(b, hq, l, dqk)).astype(np.float32)
    k = rng.normal(size=(b, hkv, l, dqk)).astype(np.float32)
    v = rng.normal(size=(b, hkv, l, dv)).astype(np.float32)
    dout = rng.normal(size=(b, hq, l, dv)).astype(np.float32)
    jcfg = dataclasses.replace(j_get_arch("minicpm3-4b").smoke, q_chunk=16)
    _, vjp = jax.vjp(lambda a, b_, c: jtf._attention(a, b_, c, jcfg, q_offset=0),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    got = ref.flash_attention_bwd_ref(*(torch.from_numpy(x) for x in (q, k, v, dout)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ref.flash_attention_ref(*ts).backward(torch.from_numpy(dout))
    for g, w, a in zip(got, want, ts):
        assert g.shape == a.shape
        _close(g, w, 1e-5)
        _close(g, a.grad, 1e-5)


@pytest.mark.parametrize("b,hq,hkv,l", [(1, 4, 4, 130), (1, 3, 1, 300)])
def test_tc_mirror_at_96_64_within_limits(b, hq, hkv, l):
    """The tensor-core backward's arithmetic at minicpm3's widths (S over
    96 columns, dP and D over V's 64, P from the forward mirror's
    log-sum-exp) within ``ref.flash_attention_bwd_limits``, as the card
    holds the kernel."""
    rng = np.random.default_rng([b, hq, hkv, l])
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
                     for s in ((b, hq, l, 96), (b, hkv, l, 96), (b, hkv, l, 64),
                               (b, hq, l, 64)))
    out, lse = ref.flash_attention_hilo_ref(q, k, v, causal=True, return_lse=True)
    got = ref.flash_attention_bwd_tc_ref(q, k, v, out, dout, lse)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    want, limit = ref.flash_attention_bwd_limits(q, k, v, dout)
    worst = [float(((g.float() - w).abs() / lim).max()) for g, w, lim in zip(got, want, limit)]
    assert max(worst) <= 1.0, worst


@pytest.mark.parametrize("dtype,dqk,dv,want", [
    (torch.bfloat16, 96, 64, "tc"), (torch.float32, 96, 64, None),
    (torch.bfloat16, 192, 128, None), (torch.bfloat16, 64, 64, "tc"),
])
def test_bwd_route_at_mla_widths(dtype, dqk, dv, want):
    assert bwd_route(dtype, dqk, dv) == want


# ---------------------------------------------------------------------------
# remat, the recompute's routing, unrouted experts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_and_routes_alike(monkeypatch, arch):
    """With remat the loss and every gradient equal those without, bit for
    bit; each MoE layer's recompute reads the same per-expert row counts as
    its forward; the padded experts' gradients are exact zeros."""
    cfg = get_arch(arch).smoke
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks, labels = (torch.from_numpy(a) for a in next(token_batches(cfg.vocab, 2, 20, seed=1)))
    counts, inner = [], tf._expert_rows
    monkeypatch.setattr(tf, "_expert_rows", lambda e, n: counts.append(inner(e, n)) or counts[-1])
    runs = {}
    for remat in (False, True):
        counts.clear()
        c = dataclasses.replace(cfg, remat=remat)
        runs[remat] = steps.lm_value_and_grad(params, toks, labels, c, use_kernels=False)
        runs[remat] += (list(counts),)
    (loss0, g0, c0), (loss1, g1, c1) = runs[False], runs[True]
    assert torch.equal(loss0, loss1)
    assert sorted(g0) == sorted(g1) and all(torch.equal(g0[k], g1[k]) for k in g0)
    n = cfg.n_moe_layers
    assert len(c0) == n and len(c1) == 2 * n
    assert c1[:n] == c0 and c1[n:] == c0[::-1]   # the recompute runs the layers backwards
    if cfg.moe:
        for name in ("e_wg", "e_wu", "e_wd"):
            assert not g1[f"moe/{name}"][:, cfg.n_experts:].any()


@pytest.mark.parametrize("arch", ["minicpm3-4b", "granite-moe-3b-a800m"])
def test_train_driver_trains_mla_and_moe(tmp_path, arch):
    losses = train_driver.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                                "--batch", "2", "--seq", "16", "--ckpt-every", "100",
                                "--ckpt-dir", str(tmp_path / "ck")])
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
