"""The port's transformer serving slice against the JAX package, on the CPU.

``flash_attention_ref`` against the JAX reference and the Pallas kernel in
interpret mode; the kernel wrapper's contracts and dispatch; the shared
model pieces (``rms_norm``, ``rope``/``apply_rope``, ``swiglu``); the
phi4-mini configurations and parameter shapes; and the smoke model's
``prefill``, ``decode_step``, ``prefill_chunked`` and ``forward``, with the
JAX parameters carried across, against the JAX functions with
``attn_backend="pallas_interpret"``, plus the serving loop's ids. Inputs
come from NumPy with a seed. Tolerances, as max |port − JAX| over the
largest |JAX| value (at least 1): float32 2e-5 for one attention call and
1e-5 through the model (the same float32 arithmetic in another order);
bfloat16 2e-2 (both round the same float32 values once, and bf16 has 8
significant bits).
"""

import dataclasses
import math
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import LM_SHAPES as J_LM_SHAPES
from repro.configs.registry import get_arch as j_get_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro_torch.configs import LM_SHAPES, get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import check_contract, flash_attention_cuda
from repro_torch.launch import serve as tserve
from repro_torch.models import common, transformer as tf

ARCH = "phi4-mini-3.8b"
FULL_PARAMS = 4_450_618_368


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol: float, what: str = "") -> None:
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    lim = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{what}: max |port - jax| {err} > {lim}"


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # the four cases of tests/test_kernels.py test_flash_attention_sweep
    "train_gqa": (2, 4, 2, 96, 96, 32, 0, 32, 32, True),
    "mha": (1, 8, 8, 64, 64, 16, 0, 16, 16, True),
    "decode": (2, 4, 4, 1, 96, 32, 95, 1, 32, True),
    "ragged_tail": (1, 4, 2, 40, 40, 32, 0, 16, 16, True),
    # GQA group 3 with lk % 128 != 0 (the default 128 tiles pad the keys)
    "gqa3_padded_keys": (2, 6, 2, 50, 200, 16, 150, 128, 128, True),
    # a later chunk of chunked prefill: Lq > 1, q_offset > 0, keys past the chunk
    "chunk": (2, 6, 2, 24, 90, 8, 32, 8, 16, True),
    # non-causal with lk a multiple of the key tile
    "noncausal": (1, 4, 2, 20, 64, 16, 0, 16, 32, False),
}


def _attn_inputs(case, dtype):
    b, hq, hkv, lq, lk, dh = ATTN_CASES[case][:6]
    rng = np.random.default_rng([b, hq, lq, lk, dh])
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, hq, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh)))
    jx = [jnp.asarray(x).astype(jnp.dtype(dtype)) for x in (q, k, v)]
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_ref_matches_jax(case, dtype):
    off, tq, tk, causal = ATTN_CASES[case][6:]
    (jq, jk, jv), (q, k, v) = _attn_inputs(case, dtype)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, q_offset=off)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, q_offset=off,
                                  backend="pallas_interpret", tile_q=tq, tile_k=tk)
    got = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=off)
    assert got.dtype == q.dtype and got.shape == q.shape
    via_ops = ops.flash_attention(q, k, v, causal=causal, q_offset=off, use_kernels=False)
    assert torch.equal(via_ops, got)
    tol = 2e-5 if dtype == "float32" else 2e-2
    _close(got, want, tol, "vs ref")
    _close(got, pallas, tol, "vs pallas")


def test_flash_attention_ref_slices_queries(monkeypatch):
    """Slicing the query axis (down to 3 rows a slice) gives the unsliced
    result: each query row's arithmetic is the same."""
    (_, _, _), (q, k, v) = _attn_inputs("gqa3_padded_keys", "float32")
    whole = ref.flash_attention_ref(q, k, v, causal=True, q_offset=150)
    b, hq, _, _ = q.shape
    monkeypatch.setattr(ref, "_ATTN_CELLS", 3 * b * hq * k.shape[2])
    sliced = ref.flash_attention_ref(q, k, v, causal=True, q_offset=150)
    np.testing.assert_allclose(sliced.numpy(), whole.numpy(), rtol=0, atol=1e-6)


def test_flash_attention_contracts():
    """The TPU kernel's two contracts, raised by the port's wrapper as by
    the Pallas kernel; the plain version, like the JAX reference, takes
    both inputs."""
    (jq, jk, jv), (q, k, v) = _attn_inputs("gqa3_padded_keys", "float32")   # lk = 200
    with pytest.raises(NotImplementedError):
        jops.flash_attention(jq, jk, jv, causal=False, backend="pallas_interpret")
    with pytest.raises(NotImplementedError):
        flash_attention_cuda(q, k, v, causal=False)
    assert ops.flash_attention(q, k, v, causal=False, use_kernels=False).shape == q.shape
    (jq, jk, jv), (q, k, v) = _attn_inputs("ragged_tail", "float32")   # lq = lk = 40
    with pytest.raises(ValueError, match="past the last"):
        jops.flash_attention(jq, jk, jv, causal=True, q_offset=1, backend="pallas_interpret")
    with pytest.raises(ValueError, match="past the last"):
        flash_attention_cuda(q, k, v, causal=True, q_offset=1)
    check_contract(40, 40, causal=True, q_offset=0)
    check_contract(20, 128, causal=False, q_offset=0)
    with pytest.raises(NotImplementedError):
        check_contract(20, 130, causal=False, q_offset=0)
    assert ops.flash_attention(q, k, v, q_offset=1, use_kernels=False).shape == q.shape


def test_flash_attention_dispatch_rules():
    (_, _, _), (q, k, v) = _attn_inputs("mha", "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, use_kernels=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="group"):
        flash_attention_cuda(q, k[:, :3], v[:, :3])
    with pytest.raises(ValueError, match="Dh"):
        flash_attention_cuda(torch.zeros(1, 2, 4, 300), torch.zeros(1, 2, 4, 300),
                             torch.zeros(1, 2, 4, 300))
    with pytest.raises(ValueError, match="16-byte"):   # Dh 20 in bfloat16
        flash_attention_cuda(*(torch.zeros(1, 2, 4, 20, dtype=torch.bfloat16),) * 3)
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["flash_decode"] == 0


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_common_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 7, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.dtype(dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    tol = 1e-6 if dtype == "float32" else 1e-2
    got = common.rms_norm(tx, torch.from_numpy(scale).to(tx.dtype))
    assert got.dtype == tx.dtype
    _close(got, jcommon.rms_norm(jx, jnp.asarray(scale).astype(jx.dtype)), tol, "rms_norm")

    pos = np.array([0, 1, 5, 17, 1000, 8191, 8206], np.int32)
    cos, sin = common.rope(torch.from_numpy(pos), 16, 1e4)
    jcos, jsin = jcommon.rope(jnp.asarray(pos), 16, 1e4)
    assert cos.dtype == torch.float32 and cos.shape == (7, 8)
    _close(cos, jcos, 1e-5, "cos")
    _close(sin, jsin, 1e-5, "sin")
    rot = common.apply_rope(tx, cos, sin)
    assert rot.dtype == tx.dtype
    _close(rot, jcommon.apply_rope(jx, jcos, jsin), 1e-5 if dtype == "float32" else 1e-2, "rope")

    w = [rng.normal(size=s).astype(np.float32) / 4 for s in ((16, 24), (16, 24), (24, 16))]
    got = common.swiglu(tx, *(torch.from_numpy(a).to(tx.dtype) for a in w))
    want = jcommon.swiglu(jx, *(jnp.asarray(a).astype(jx.dtype) for a in w))
    _close(got, want, 1e-5 if dtype == "float32" else 2e-2, "swiglu")


def test_phi4_configs_match_jax():
    mine, theirs = get_arch(ARCH), j_get_arch(ARCH)
    assert mine.family == theirs.family == "lm"
    for cfg, jcfg in ((mine.config, theirs.config), (mine.smoke, theirs.smoke)):
        assert [f.name for f in dataclasses.fields(cfg)] == \
            [f.name for f in dataclasses.fields(jcfg)]
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), (cfg.name, f.name)
        assert cfg.param_count() == jcfg.param_count()
    for s, js in zip(LM_SHAPES, J_LM_SHAPES, strict=True):
        for f in dataclasses.fields(s):
            assert getattr(s, f.name) == getattr(js, f.name), (s.name, f.name)


def _shape_tree(tree):
    return {k: _shape_tree(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("which", ["config", "smoke"])
def test_param_shapes_match_jax(which):
    cfg, jcfg = getattr(get_arch(ARCH), which), getattr(j_get_arch(ARCH), which)
    want = _shape_tree(jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0))))
    assert tf.param_shapes(cfg) == want
    if which == "config":
        assert cfg.param_count() == FULL_PARAMS


def test_init_params_law():
    cfg = get_arch(ARCH).smoke
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _shape_tree(params) == tf.param_shapes(cfg)
    assert torch.equal(params["final_norm"], torch.ones(cfg.d_model))
    assert torch.equal(params["dense"]["attn_norm"], torch.ones(cfg.n_layers, cfg.d_model))
    assert abs(float(params["embed"].std()) - 0.02) < 2e-3
    assert abs(float(params["dense"]["wd"].std()) - 1 / math.sqrt(cfg.d_ff)) < 1e-2
    again = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["dense"]["wq"], params["dense"]["wq"])


# ---------------------------------------------------------------------------
# the smoke model against the JAX functions
# ---------------------------------------------------------------------------

def _model_case(dtype, seed=0):
    """JAX config (Pallas in interpret mode), parameters and their port copies."""
    cfg = dataclasses.replace(get_arch(ARCH).smoke, dtype=dtype)
    jcfg = dataclasses.replace(j_get_arch(ARCH).smoke, dtype=dtype,
                               attn_backend="pallas_interpret")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, jparams, lm_params_from_numpy(jparams, "cpu")


def test_lm_params_carry_across_exactly():
    cfg, _, jparams, params = _model_case("bfloat16")
    assert params["dense"]["wq"].dtype == torch.bfloat16
    for name in ("embed", "lm_head"):
        np.testing.assert_array_equal(_f32(params[name]), _f32(jparams[name]))
    for name, leaf in jparams["dense"].items():
        np.testing.assert_array_equal(_f32(params["dense"][name]), _f32(leaf), err_msg=name)


def _cache_close(cache, jcache, tol, what):
    for i in range(2):
        _close(cache["dense"][i], jcache["dense"][i], tol, f"{what} cache {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """``prefill`` then three ``decode_step`` s: logits and caches."""
    cfg, jcfg, jparams, params = _model_case(dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    b, s, max_len = 2, 16, 20
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (b, s + 3)).astype(np.int32)
    jcache = jtf.init_cache(jcfg, b, max_len)
    cache = tf.init_cache(cfg, b, max_len, "cpu")
    jlog, jcache = jtf.prefill(jparams, jnp.asarray(toks[:, :s]), jcache, jcfg)
    log, cache2 = tf.prefill(params, torch.from_numpy(toks[:, :s]), cache, cfg, use_kernels=False)
    assert cache2 is cache and log.shape == (b, 1, cfg.vocab) and log.dtype == cfg.tdtype
    _close(log, jlog, tol, "prefill logits")
    _cache_close(cache, jcache, tol, "prefill")
    for i in range(3):
        tok = toks[:, s + i:s + i + 1]
        jlog, jcache = jtf.decode_step(jparams, jnp.asarray(tok), jcache, s + i, jcfg)
        log, _ = tf.decode_step(params, torch.from_numpy(tok), cache, s + i, cfg,
                                use_kernels=False)
        _close(log, jlog, tol, f"decode {i} logits")
    _cache_close(cache, jcache, tol, "decode")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_chunked_matches_jax(dtype):
    cfg, jcfg, jparams, params = _model_case(dtype, seed=2)
    tol = 1e-5 if dtype == "float32" else 2e-2
    b, s, chunk, max_len = 2, 24, 8, 27
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (b, s)).astype(np.int32)
    jlog, jcache = jtf.prefill_chunked(jparams, jnp.asarray(toks), jtf.init_cache(jcfg, b, max_len),
                                       jcfg, chunk=chunk)
    cache = tf.init_cache(cfg, b, max_len, "cpu")
    log, _ = tf.prefill_chunked(params, torch.from_numpy(toks), cache, cfg, chunk=chunk,
                                use_kernels=False)
    _close(log, jlog, tol, "chunked logits")
    _cache_close(cache, jcache, tol, "chunked")
    # and the port's chunked prefill against its own unchunked one
    whole = tf.init_cache(cfg, b, max_len, "cpu")
    log1, _ = tf.prefill(params, torch.from_numpy(toks), whole, cfg, use_kernels=False)
    _close(log, log1, tol, "chunked vs whole")
    with pytest.raises(ValueError, match="multiple"):
        tf.prefill_chunked(params, torch.from_numpy(toks[:, :20]), cache, cfg, chunk=8,
                           use_kernels=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    cfg, jcfg, jparams, params = _model_case(dtype, seed=4)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    want = jtf.forward(jparams, jnp.asarray(toks), jcfg)
    got = tf.forward(params, torch.from_numpy(toks), cfg, use_kernels=False)
    assert got.shape == (2, 12, cfg.vocab) and got.is_inference()
    _close(got, want, 1e-5 if dtype == "float32" else 2e-2, "forward")


def test_use_kernels_on_cpu_raises():
    cfg, _, _, params = _model_case("float32")
    cache = tf.init_cache(cfg, 1, 8, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tf.prefill(params, torch.zeros((1, 4), dtype=torch.int32), cache, cfg, use_kernels=True)


# ---------------------------------------------------------------------------
# the serving loop
# ---------------------------------------------------------------------------

def _printed_ids(text: str, batch: int, gen: int) -> np.ndarray:
    tail = text.split("generated ids:", 1)[1]
    return np.array([int(t) for t in re.findall(r"-?\d+", tail)]).reshape(batch, gen)


def test_serve_matches_jax_serve_loop(monkeypatch, capsys):
    """The JAX serving loop's ids (its own PRNGKey(0) parameters) from the port's
    ``serve`` on those parameters, and from its chunked prefill too."""
    b, s, gen = 2, 16, 8
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke", "--batch", str(b),
                                     "--prompt-len", str(s), "--gen", str(gen)])
    jserve.main()
    want = _printed_ids(capsys.readouterr().out, b, gen)

    cfg = get_arch(ARCH).smoke
    params = lm_params_from_numpy(jtf.init_params(j_get_arch(ARCH).smoke,
                                                  jax.random.PRNGKey(0)), "cpu")
    prompt = torch.from_numpy(tserve.prompt_tokens(cfg.vocab, b, s, 0))
    res = tserve.serve(cfg, params, prompt, gen, use_kernels=False)
    np.testing.assert_array_equal(res.ids.numpy(), want)
    assert [r["stage"] for r in res.records] == ["prefill"] + ["decode"] * (gen - 1)
    assert res.logits.shape == (b, gen, cfg.vocab)
    assert torch.equal(res.ids, res.logits.argmax(-1))
    chunked = tserve.serve(cfg, params, prompt, gen, use_kernels=False, chunk=8)
    np.testing.assert_array_equal(chunked.ids.numpy(), want)
    # teacher forcing feeds the given tokens and reports its own choices
    forced = tserve.serve(cfg, params, prompt, gen, use_kernels=False, forced=res.ids)
    assert torch.equal(forced.ids, res.ids)


def test_serve_cli_smoke_on_cpu(capsys):
    res = tserve.main(["--arch", ARCH, "--device", "cpu", "--smoke", "--gen", "4"])
    out = capsys.readouterr().out
    assert res.ids.shape == (2, 4)
    np.testing.assert_array_equal(_printed_ids(out, 2, 4), res.ids.numpy())
    assert out.count('"stage": "decode"') == 3
