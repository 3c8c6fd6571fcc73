"""The port's EquiformerV2 and Wigner-D rotations against the JAX package, on the CPU.

``wigner``: ``sh_real`` and ``axis_swap_matrix`` exactly equal to JAX's
up to l = 6 (the same NumPy code, seeds and fit); ``rot_z_real`` and
``edge_rotation`` within 1e-5 of JAX's float32 (cos / sin / atan2 and the
products may round differently in the last bit), on random directions,
the axes and zero vectors; the rotation properties of
``tests/test_substrates.py``. The forward against
``repro.models.gnn.forward(..., backend="pallas_interpret")`` and
``"ref"``, the JAX parameters carried across: float32 within 1e-4 · max
|JAX| (sums taken in another order and in float64), bfloat16 within 3e-2 ·
max |JAX| (JAX adds the chunks in bfloat16, the port in float64, and the
bf16 roundings of the features follow); padded edges and a node whose only
in-edges are padding; 8 edge chunks. The inputs come from NumPy with a seed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_arch as j_get_arch
from repro.data.graphs import build_graph_data as j_build_graph_data
from repro.launch.steps import _gnn_flops
from repro.models import gnn as jgnn
from repro.models import wigner as jwigner
from repro_torch.configs import get_arch
from repro_torch.convert import gnn_params_from_numpy, graph_from_numpy
from repro_torch.launch.steps import gnn_flops
from repro_torch.models import gnn, wigner

L_MAX = 6


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


def _directions(kind: str) -> np.ndarray:
    if kind == "random":
        return np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    if kind == "axes":
        eye = np.eye(3, dtype=np.float32)
        return np.concatenate([eye, -eye, 2.5 * eye])
    return np.zeros((4, 3), np.float32)          # self-loops and padded edges


# ---------------------------------------------------------------------------
# wigner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l_max", range(L_MAX + 1))
def test_sh_real_equals_jax(l_max):
    dirs = np.random.default_rng(l_max).normal(size=(50, 3))
    np.testing.assert_array_equal(wigner.sh_real(l_max, dirs), jwigner.sh_real(l_max, dirs))
    assert wigner.sh_basis_size(l_max) == jwigner.sh_basis_size(l_max)


@pytest.mark.parametrize("l", range(L_MAX + 1))
def test_axis_swap_matrix_equals_jax(l):
    np.testing.assert_array_equal(wigner.axis_swap_matrix(l), jwigner.axis_swap_matrix(l))


@pytest.mark.parametrize("l", range(L_MAX + 1))
def test_rot_z_real_matches_jax(l):
    theta = np.concatenate([np.random.default_rng(l).uniform(-4, 4, 20),
                            [0.0, np.pi, -np.pi, 1e-7]]).astype(np.float32)
    got = wigner.rot_z_real(l, torch.from_numpy(theta))
    assert got.dtype == torch.float32 and tuple(got.shape) == (24, 2 * l + 1, 2 * l + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwigner.rot_z_real(l, jnp.asarray(theta))),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["random", "axes", "zeros"])
def test_edge_rotation_matches_jax(kind):
    dirs = _directions(kind)
    got = wigner.edge_rotation(L_MAX, torch.from_numpy(dirs))
    want = np.asarray(jwigner.edge_rotation(L_MAX, jnp.asarray(dirs)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if kind == "zeros":  # a zero direction is the identity rotation
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(np.eye(49), want.shape),
                                   atol=1e-6)


def test_wigner_rotation_properties():
    """Twin of ``test_substrates.py::test_wigner_rotation_properties``."""
    rng = np.random.default_rng(0)
    theta = 0.7
    rz = np.array([[np.cos(theta), -np.sin(theta), 0],
                   [np.sin(theta), np.cos(theta), 0], [0, 0, 1.0]])
    for l in range(0, 5):
        m_fit = wigner._fit_block(l, rz)
        m_an = wigner.rot_z_real(l, torch.tensor(theta, dtype=torch.float32)).numpy()
        assert np.abs(m_fit - m_an).max() < 1e-5

    dirs = rng.normal(size=(6, 3)).astype(np.float32)
    lmax = 4
    d = wigner.edge_rotation(lmax, torch.from_numpy(dirs)).numpy()
    sh_v = wigner.sh_real(lmax, dirs.astype(np.float64))
    sh_y = wigner.sh_real(lmax, np.array([[0.0, 1.0, 0.0]]))
    for e in range(dirs.shape[0]):
        assert np.allclose(d[e] @ sh_v[e], sh_y[0], atol=1e-4)
        assert np.allclose(d[e] @ d[e].T, np.eye(d.shape[1]), atol=1e-4)


# ---------------------------------------------------------------------------
# configuration, parameters, FLOP count
# ---------------------------------------------------------------------------

def test_registry_holds_equiformer_v2_with_the_jax_fields():
    mine, theirs = get_arch("equiformer-v2"), j_get_arch("equiformer-v2")
    assert (mine.family, mine.notes, [s.name for s in mine.shapes]) == (
        theirs.family, theirs.notes, [s.name for s in theirs.shapes])
    for cfg, jcfg in ((mine.config, theirs.config), (mine.smoke, theirs.smoke)):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert {f.name for f in dataclasses.fields(jcfg)} == {
            f.name for f in dataclasses.fields(cfg)}
        assert gnn.param_shapes(cfg) == {k: tuple(v.shape) for k, v in jax.eval_shape(
            lambda c=jcfg: jgnn.init_params(c, jax.random.PRNGKey(0))).items()}
    params = gnn.init_params(mine.smoke, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == gnn.param_shapes(mine.smoke)


@pytest.mark.parametrize("name", ["gatedgcn", "graphsage-reddit", "meshgraphnet",
                                  "equiformer-v2"])
def test_gnn_flops_equal_jax(name):
    cfg = get_arch(name).config
    assert gnn_flops(cfg, 3840, 16384) == _gnn_flops(j_get_arch(name).config, 3840, 16384, False)


@pytest.mark.parametrize("edges,chunk,want", [
    (16384, 32768, 1), (16384, 4096, 4), (21112, 32768, 1), (128, 16, 8),
    (21112, 4096, 4), (21120, 4096, 4), (0, 16, 1), (96, 16, 4), (100, 16, 4)])
def test_chunk_rule(edges, chunk, want):
    assert gnn.eqv2_chunks(edges, chunk) == want


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def _case(jcfg, seed=0, n=64, e=120, pad_nodes=72, pad_edges=128):
    """The JAX parameters and graph, and their port copies (CPU). With the
    defaults, 8 padded edges point at node 71, which has no other in-edge."""
    raw = j_build_graph_data(n, e, jcfg.d_in, seed=seed, pad_nodes=pad_nodes,
                             pad_edges=pad_edges, geometric=True)
    jparams = jgnn.init_params(jcfg, jax.random.PRNGKey(seed))
    jg = jgnn.GraphData(**{k: jnp.asarray(v) for k, v in raw.items()})
    return jparams, jg, gnn_params_from_numpy(jparams, "cpu"), graph_from_numpy(raw, "cpu")


def _port_cfg(jcfg):
    return gnn.GNNConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(gnn.GNNConfig)})


def _within(got: torch.Tensor, want: np.ndarray, share: float) -> float:
    assert np.all(np.isfinite(want)) and bool(torch.isfinite(got).all())
    ratio = float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())
    assert ratio <= share, ratio
    return ratio


@pytest.mark.parametrize("backend", ["pallas_interpret", "ref"])
def test_smoke_forward_matches_jax(backend):
    jcfg = j_get_arch("equiformer-v2").smoke
    jparams, jg, params, g = _case(jcfg)
    assert not bool(g.edge_mask[g.dst == 71].any()) and int((g.dst == 71).sum()) == 8
    want = _f32(jgnn.forward(jparams, jg, jcfg, backend=backend))
    got = gnn.forward(params, g, get_arch("equiformer-v2").smoke, use_kernels=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _within(got, want, 1e-4)


def test_bf16_full_degree_forward_matches_jax():
    """2 layers at l_max 6 / m_max 2 / 8 heads, the full config's degrees, narrow."""
    jcfg = dataclasses.replace(j_get_arch("equiformer-v2").config, n_layers=2, d_hidden=8, d_in=6)
    jparams, jg, params, g = _case(jcfg, seed=1)
    want = _f32(jgnn.forward(jparams, jg, jcfg, backend="pallas_interpret"))
    got = gnn.forward(params, g, _port_cfg(jcfg), use_kernels=False)
    assert got.dtype == torch.bfloat16
    _within(got, want, 3e-2)


def test_chunked_forward_matches_jax_and_unchunked():
    """edge_chunk 16 on 128 edges: 8 chunks, in JAX and in the port."""
    jcfg = dataclasses.replace(j_get_arch("equiformer-v2").smoke, edge_chunk=16)
    assert gnn.eqv2_chunks(128, jcfg.edge_chunk) == 8
    jparams, jg, params, g = _case(jcfg, seed=2)
    want = _f32(jgnn.forward(jparams, jg, jcfg, backend="pallas_interpret"))
    got = gnn.forward(params, g, _port_cfg(jcfg), use_kernels=False)
    _within(got, want, 1e-4)
    whole = gnn.forward(params, g, get_arch("equiformer-v2").smoke, use_kernels=False)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6, rtol=1e-6)


def test_node_with_only_padded_in_edges_stays_finite():
    """Every in-edge of node 0 is padding: its softmax max is -inf, and its
    messages must be exactly zero, not NaN."""
    jcfg = j_get_arch("equiformer-v2").smoke
    raw = j_build_graph_data(24, 64, jcfg.d_in, seed=4, geometric=True)
    raw["edge_mask"][raw["dst"] == 0] = False
    raw["edge_mask"][:4] = False
    raw["dst"][:4] = 0
    jparams = jgnn.init_params(jcfg, jax.random.PRNGKey(4))
    want = _f32(jgnn.forward(jparams, jgnn.GraphData(**{k: jnp.asarray(v) for k, v in raw.items()}),
                             jcfg, backend="pallas_interpret"))
    got = gnn.forward(gnn_params_from_numpy(jparams, "cpu"), graph_from_numpy(raw, "cpu"),
                      get_arch("equiformer-v2").smoke, use_kernels=False)
    _within(got, want, 1e-4)


def test_smoke_is_rotation_invariant():
    """Twin of ``test_smoke_archs.py::test_equiformer_smoke_is_rotation_invariant``."""
    cfg = get_arch("equiformer-v2").smoke
    rng = np.random.default_rng(0)
    n, e = 20, 40
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    base = dict(
        x=torch.from_numpy(rng.normal(size=(n, cfg.d_in)).astype(np.float32)),
        src=torch.from_numpy(rng.integers(0, n, e).astype(np.int32)),
        dst=torch.from_numpy(rng.integers(0, n, e).astype(np.int32)),
        edge_attr=torch.zeros((e, 1)),
        node_mask=torch.ones(n, dtype=torch.bool),
        edge_mask=torch.ones(e, dtype=torch.bool),
    )
    params = gnn.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    out1 = gnn.forward(params, gnn.GraphData(positions=torch.from_numpy(pos), **base), cfg,
                       use_kernels=False)
    th = 1.1
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                   np.float32)
    out2 = gnn.forward(params, gnn.GraphData(positions=torch.from_numpy(pos @ rot.T), **base),
                       cfg, use_kernels=False)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-3, atol=1e-4)


def test_general_rotation_gap_equals_jax():
    """The reference is invariant only under rotations about z: a general
    rotation of the positions moves its output, and the port's by as much."""
    jcfg = j_get_arch("equiformer-v2").smoke
    jparams, jg, params, g = _case(jcfg, seed=5, pad_nodes=None, pad_edges=None)
    q, _ = np.linalg.qr(np.random.default_rng(5).normal(size=(3, 3)))
    rot = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    pos = np.asarray(jg.positions) @ rot.T
    gaps = []
    for fwd, a, b in (
            (lambda gg: _f32(jgnn.forward(jparams, gg, jcfg)), jg,
             dataclasses.replace(jg, positions=jnp.asarray(pos))),
            (lambda gg: gnn.forward(params, gg, get_arch("equiformer-v2").smoke,
                                    use_kernels=False).numpy(), g,
             dataclasses.replace(g, positions=torch.from_numpy(pos)))):
        out, out_rot = fwd(a), fwd(b)
        gaps.append(float(np.abs(out_rot - out).max() / np.abs(out).max()))
    assert gaps[0] > 1e-3 and abs(gaps[1] - gaps[0]) <= 1e-4, gaps


def test_forward_with_kernels_on_cpu_raises():
    cfg = get_arch("equiformer-v2").smoke
    _, _, params, g = _case(j_get_arch("equiformer-v2").smoke)
    with pytest.raises(ValueError, match="CUDA"):
        gnn.forward(params, g, cfg, use_kernels=True)
