"""The port's GNN slice against the JAX package, on the CPU.

``segment_sum_ref`` against the JAX reference and the Pallas kernel in
interpret mode; ``build_graph_data`` array for array; the three smoke
configurations' forwards (the JAX parameters carried across) against
``forward(..., backend="pallas_interpret")``; the edge-sliced gatedgcn
against the unsliced one; ``sage_minibatch_forward``; and the dispatch
rules. The inputs come from NumPy with a seed. Tolerances: float32 sums
taken in another order and precision (the port sums in float64: 1e-5 for
one segment sum, 1e-4 through a model); bfloat16, where JAX's Pallas
kernel sums in bfloat16 and the port in float64 rounded once, within a
share of the largest output.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import GNN_SHAPES as J_GNN_SHAPES
from repro.configs.registry import get_arch as j_get_arch
from repro.data.graphs import build_graph_data as j_build_graph_data
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import gnn as jgnn
from repro_torch.configs import GNN_SHAPES, get_arch
from repro_torch.convert import gnn_params_from_numpy, graph_from_numpy
from repro_torch.data import build_graph_data
from repro_torch.kernels import ops, ref
from repro_torch.models import gnn

ARCHS = ["gatedgcn", "graphsage-reddit", "meshgraphnet"]


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


def _ids(rng, kind, e, n):
    if kind == "sorted":          # ascending, padding id n at the tail
        ids = np.sort(rng.integers(0, n, e))
        ids[-e // 8:] = n
    elif kind == "unsorted":      # random order, many duplicates
        ids = rng.integers(0, n // 4, e)
    else:                         # out of range: id n and id -1 mixed in
        ids = rng.integers(0, n, e)
        ids[rng.random(e) < 0.1] = n
        ids[rng.random(e) < 0.1] = -1
    return ids.astype(np.int32)


# ---------------------------------------------------------------------------
# segment_sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 70, 128])
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "out_of_range"])
def test_segment_sum_ref_matches_jax(kind, d, dtype):
    rng = np.random.default_rng([len(kind), d, len(dtype)])
    e, n = 300, 50
    data = rng.normal(size=(e, d)).astype(np.float32)
    ids = _ids(rng, kind, e, n)
    jdata = jnp.asarray(data).astype(jnp.dtype(dtype))
    want = _f32(jref.segment_sum_ref(jdata, jnp.asarray(ids), n))
    pallas = _f32(jops.segment_sum(jdata, jnp.asarray(ids), n, backend="pallas_interpret"))
    tdata = torch.from_numpy(data).to(getattr(torch, dtype))
    got_t = ops.segment_sum(tdata, torch.from_numpy(ids), n, use_kernels=False)
    assert got_t.dtype == tdata.dtype and got_t.shape == (n, d)
    got = got_t.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
    else:
        lim = 2e-2 * np.abs(want).max()
        assert np.abs(got - want).max() <= lim
        assert np.abs(got - pallas).max() <= lim


def test_segment_sum_accumulates_over_slices():
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.normal(size=(200, 7)).astype(np.float32))
    ids = torch.from_numpy(_ids(rng, "out_of_range", 200, 20))
    acc = torch.zeros((20, 7), dtype=ops.ACC_DTYPE)
    for s in range(0, 200, 64):
        out = ops.segment_sum(data[s:s + 64], ids[s:s + 64], 20, use_kernels=False, acc=acc)
        assert out is acc
    whole = ref.segment_sum_ref(data, ids, 20)
    np.testing.assert_allclose(acc.numpy(), whole.numpy(), atol=1e-6)


@pytest.mark.parametrize("e,n", [(0, 5), (10, 0), (10, 1)])
def test_segment_sum_ref_edge_sizes(e, n):
    rng = np.random.default_rng(e + n)
    data = rng.normal(size=(e, 3)).astype(np.float32)
    ids = rng.integers(-1, 3, e).astype(np.int32)
    got = ref.segment_sum_ref(torch.from_numpy(data), torch.from_numpy(ids), n).numpy()
    want = np.asarray(jref.segment_sum_ref(jnp.asarray(data), jnp.asarray(ids), n))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_segment_sum_dispatch_rules():
    data, ids = torch.ones((4, 2)), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.segment_sum(data, ids, 3, use_kernels=True)
    with pytest.raises(ValueError, match="acc"):
        ops.segment_sum(data, ids, 3, use_kernels=False, acc=torch.zeros((3, 2), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="data"):
        from repro_torch.kernels.segment_sum import segment_plan, segment_sum_cuda
        segment_sum_cuda(data, segment_plan(ids, 3), torch.zeros((3, 2)))


# ---------------------------------------------------------------------------
# data and configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_nodes=64, n_edges=256, d_feat=8),
    dict(n_nodes=50, n_edges=100, d_feat=5, d_edge=4, seed=7, pad_nodes=56, pad_edges=128,
         geometric=True),
])
def test_build_graph_data_matches_jax(kw):
    got, want = build_graph_data(**kw), j_build_graph_data(**kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_jax(name):
    mine, theirs = get_arch(name), j_get_arch(name)
    for cfg, jcfg in ((mine.config, theirs.config), (mine.smoke, theirs.smoke)):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), (name, f.name)
        assert gnn.param_shapes(cfg) == {k: tuple(v.shape) for k, v in jax.eval_shape(
            lambda c=jcfg: jgnn.init_params(c, jax.random.PRNGKey(0))).items()}
    for s, js in zip(GNN_SHAPES, J_GNN_SHAPES):
        for f in dataclasses.fields(s):
            assert getattr(s, f.name) == getattr(js, f.name), (s.name, f.name)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def _case(cfg, seed=0):
    """The JAX parameters and graph, and their port copies (CPU)."""
    raw = j_build_graph_data(64, 240, cfg.d_in, d_edge=cfg.d_edge_in, seed=seed,
                             pad_nodes=72, pad_edges=256)
    jparams = jgnn.init_params(cfg, jax.random.PRNGKey(seed))
    jg = jgnn.GraphData(**{k: jnp.asarray(v) for k, v in raw.items()})
    return jparams, jg, gnn_params_from_numpy(jparams, "cpu"), graph_from_numpy(raw, "cpu")


def _port_cfg(jcfg):
    return gnn.GNNConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(gnn.GNNConfig)})


@pytest.mark.parametrize("name", ARCHS)
def test_smoke_forward_matches_jax(name):
    jcfg = j_get_arch(name).smoke
    jparams, jg, params, g = _case(jcfg)
    want = _f32(jgnn.forward(jparams, jg, jcfg, backend="pallas_interpret"))
    got = gnn.forward(params, g, get_arch(name).smoke, use_kernels=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_gatedgcn_bf16_forward_matches_jax():
    jcfg = dataclasses.replace(j_get_arch("gatedgcn").smoke, dtype="bfloat16")
    jparams, jg, params, g = _case(jcfg, seed=1)
    want = _f32(jgnn.forward(jparams, jg, jcfg, backend="pallas_interpret"))
    got = gnn.forward(params, g, _port_cfg(jcfg), use_kernels=False)
    assert got.dtype == torch.bfloat16
    assert np.all(np.isfinite(want))
    assert np.abs(got.float().numpy() - want).max() <= 3e-2 * np.abs(want).max()


def test_gatedgcn_edge_slices_match_unsliced(monkeypatch):
    cfg = get_arch("gatedgcn").smoke
    _, _, params, g = _case(j_get_arch("gatedgcn").smoke, seed=2)
    whole = gnn.forward(params, g, cfg, use_kernels=False)
    monkeypatch.setattr(gnn, "EDGE_SLICE", 64)       # 256 edges → 4 slices
    sliced = gnn.forward(params, g, cfg, use_kernels=False)
    np.testing.assert_allclose(sliced.numpy(), whole.numpy(), atol=1e-5, rtol=1e-5)


def test_sage_minibatch_forward_matches_jax():
    jcfg = j_get_arch("graphsage-reddit").smoke
    rng = np.random.default_rng(4)
    b, (f1, f2) = 4, jcfg.fanouts
    feats = [rng.normal(size=(m, jcfg.d_in)).astype(np.float32) for m in (b, b * f1, b * f1 * f2)]
    jparams = jgnn.init_params(jcfg, jax.random.PRNGKey(5))
    want = np.asarray(jgnn.sage_minibatch_forward(jparams, [jnp.asarray(f) for f in feats], jcfg))
    got = gnn.sage_minibatch_forward(gnn_params_from_numpy(jparams, "cpu"),
                                     [torch.from_numpy(f) for f in feats], get_arch("graphsage-reddit").smoke)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_forward_with_kernels_on_cpu_raises():
    cfg = get_arch("gatedgcn").smoke
    raw = build_graph_data(16, 40, cfg.d_in)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        gnn.forward(params, graph_from_numpy(raw, "cpu"), cfg, use_kernels=True)
