"""The port's DLRM serving slice against the JAX package, on the CPU.

``embedding_bag_ref`` against the JAX reference and the Pallas kernel in
interpret mode; the dispatch rules; ``_embedding_bags``, ``forward`` and
``retrieval_scores`` (the JAX parameters carried across) against
``repro/models/dlrm.py``; the configs, FLOP count and request draws; and
the serving driver. The inputs come from NumPy with a seed. Tolerances:
float32 sums of up to a few rows taken in another order (1e-5 for one bag
sum; a one-row bag is a copy and is compared for equality); a forward's
products summed in another order by the two frameworks (1e-5 of the
largest logit); bfloat16 tables within one bfloat16 rounding of the
float64 sum, since the port sums in float32 and rounds once.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import RECSYS_SHAPES as J_RECSYS_SHAPES
from repro.configs.registry import get_arch as j_get_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.steps import _dlrm_flops as j_dlrm_flops
from repro.models import dlrm as jdlrm
from repro_torch.configs import RECSYS_SHAPES, get_arch
from repro_torch.convert import dlrm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps
from repro_torch.models import dlrm

ARCH = "dlrm-rm2"
SWEEP = [(100, 8, 64, 20), (64, 16, 128, 5), (32, 4, 7, 7)]  # tests/test_kernels.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bag_inputs(seed, v, d, n, nb):
    """As ``tests/test_kernels.py::test_embedding_bag_sweep`` draws them:
    unsorted bag ids, some bags empty."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, size=n).astype(np.int32)
    bag = rng.integers(0, nb, size=n).astype(np.int32)
    return table, idx, bag


def _port_bag(table, idx, bag, nb, dtype=torch.float32):
    out = ops.embedding_bag(torch.from_numpy(table).to(dtype), torch.from_numpy(idx),
                            torch.from_numpy(bag), nb, use_kernels=False)
    assert out.dtype == dtype and tuple(out.shape) == (nb, table.shape[1])
    return out.float().numpy()


def _sum64(table, idx, bag, nb):
    """float64 bag sums and sums of |rows|, and rows per bag."""
    keep = (bag >= 0) & (bag < nb)
    rows = table.astype(np.float64)[idx[keep]]
    s, a = np.zeros((nb, table.shape[1])), np.zeros((nb, table.shape[1]))
    np.add.at(s, bag[keep], rows)
    np.add.at(a, bag[keep], np.abs(rows))
    return s, a, np.bincount(bag[keep], minlength=nb)[:, None]


# ---------------------------------------------------------------------------
# embedding_bag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,d,n,nb", SWEEP)
def test_embedding_bag_ref_matches_jax(v, d, n, nb):
    table, idx, bag = _bag_inputs(v + n, v, d, n, nb)
    args = (jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bag), nb)
    got = _port_bag(table, idx, bag, nb)
    np.testing.assert_allclose(got, np.asarray(jref.embedding_bag_ref(*args)),
                               rtol=1e-5, atol=1e-5)
    pallas = np.asarray(jops.embedding_bag(*args, backend="pallas_interpret"))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("v,d,n,nb", SWEEP)
def test_embedding_bag_ref_bf16_within_one_rounding(v, d, n, nb):
    """float32 sums rounded once to bfloat16: within 2⁻⁸ of the float64 sum
    of the bfloat16 values, plus the float32 sum's own n_b · 2⁻²³ · Σ|rows|."""
    table, idx, bag = _bag_inputs(v + n + 1, v, d, n, nb)
    tb = torch.from_numpy(table).to(torch.bfloat16)
    got = _port_bag(table, idx, bag, nb, torch.bfloat16)
    s, a, cnt = _sum64(tb.float().numpy(), idx, bag, nb)
    limit = 2.0**-8 * np.abs(s) + (1 + 2.0**-8) * cnt * 2.0**-23 * a
    assert np.all(np.abs(got - s) <= limit)


def test_embedding_bag_ref_edge_cases():
    """Empty bags, unsorted bags, and bag ids num_bags and -1 (dropped).
    Against the JAX reference on every bag, and against the Pallas kernel on
    every bag but the last: the TPU kernel addresses its output block by
    the bag id, and interpret mode clamps the block index num_bags to the
    last bag, which then takes those rows (the port drops them, as
    ``jax.ops.segment_sum`` does)."""
    rng = np.random.default_rng(11)
    nb, d = 9, 6
    table = rng.normal(size=(40, d)).astype(np.float32)
    bag = np.array([8, 3, -1, 0, 9, 3, 8, 0, 9, -1, 5, 3], np.int32)   # 1, 2, 4, 6, 7 empty
    idx = rng.integers(0, 40, bag.shape[0]).astype(np.int32)
    args = (jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bag), nb)
    got = _port_bag(table, idx, bag, nb)
    want = np.asarray(jref.embedding_bag_ref(*args))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[[1, 2, 4, 6, 7]].any()
    pallas = np.asarray(jops.embedding_bag(*args, backend="pallas_interpret"))
    np.testing.assert_allclose(got[:-1], pallas[:-1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,nb", [(0, 4), (5, 0), (0, 0)])
def test_embedding_bag_ref_empty_sizes(n, nb):
    table, idx, bag = _bag_inputs(n + nb, 10, 3, n, max(nb, 1))
    got = _port_bag(table, idx, bag, nb)
    np.testing.assert_array_equal(got, np.asarray(jref.embedding_bag_ref(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bag), nb)))


def test_sort_by_bag_is_stable():
    rng = np.random.default_rng(5)
    bag = rng.integers(-2, 6, 500).astype(np.int32)
    idx = np.arange(500, dtype=np.int32)
    got_idx, got_bag = ops.sort_by_bag(torch.from_numpy(idx), torch.from_numpy(bag))
    order = np.argsort(bag, kind="stable")
    np.testing.assert_array_equal(got_idx.numpy(), idx[order])
    np.testing.assert_array_equal(got_bag.numpy(), bag[order])
    assert got_idx.dtype == got_bag.dtype == torch.int32


def test_embedding_bag_dispatch_rules():
    """Unsorted input gives what the JAX wrapper (which sorts) gives, in
    any order; ``use_kernels=True`` on CPU tensors raises; the kernel
    wrapper refuses CPU tensors."""
    table, idx, bag = _bag_inputs(9, 50, 8, 200, 30)
    got = _port_bag(table, idx, bag, 30)
    order = np.argsort(bag, kind="stable")
    np.testing.assert_array_equal(got, _port_bag(table, idx[order], bag[order], 30))
    np.testing.assert_allclose(got, np.asarray(jops.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bag), 30, backend="pallas_interpret")),
        rtol=1e-5, atol=1e-5)
    t, i, b = torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(bag)
    with pytest.raises(ValueError, match="CUDA"):
        ops.embedding_bag(t, i, b, 30, use_kernels=True)
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    with pytest.raises(ValueError, match="table"):
        embedding_bag_cuda(t, i, b, 30)


def test_embedding_bag_bad_row_index_is_nan():
    """A row index outside [0, V) (V itself, and -1: not wrapped) makes its
    bag NaN and no other; JAX's gather fills index V with NaN too."""
    table, idx, bag = _bag_inputs(4, 20, 5, 60, 12)
    idx[[3, 17]] = [20, -1]
    got = _port_bag(table, idx, bag, 12)
    bad = np.zeros(12, bool)
    bad[bag[[3, 17]]] = True
    assert np.isnan(got[bad]).all() and not np.isnan(got[~bad]).any()
    ok = np.isin(bag, np.flatnonzero(~bad))
    np.testing.assert_allclose(got[~bad], _port_bag(table, idx[ok], bag[ok], 12)[~bad])
    jdx = idx.copy()
    jdx[17] = 20
    want = np.asarray(jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(jdx),
                                             jnp.asarray(bag), 12))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


# ---------------------------------------------------------------------------
# configs, FLOP count, requests
# ---------------------------------------------------------------------------

def test_configs_match_jax():
    mine, theirs = get_arch(ARCH), j_get_arch(ARCH)
    assert mine.family == theirs.family == "recsys"
    for cfg, jcfg in ((mine.config, theirs.config), (mine.smoke, theirs.smoke)):
        for f in dataclasses.fields(jcfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        jshapes = jax.eval_shape(lambda c=jcfg: jdlrm.init_params(c, jax.random.PRNGKey(0)))
        assert dlrm.param_shapes(cfg) == {k: tuple(v.shape) for k, v in jshapes.items()}
        assert cfg.param_count() == sum(int(np.prod(v.shape)) for v in jshapes.values())
        assert cfg.n_interact == jcfg.n_interact
    assert mine.config.param_count() == 1_664_762_177
    jshapes = {s.name: s for s in J_RECSYS_SHAPES}
    assert [s.name for s in RECSYS_SHAPES] == ["train_batch", "serve_p99", "serve_bulk",
                                               "retrieval_cand"]
    for s in RECSYS_SHAPES:
        js = jshapes[s.name]
        assert (s.kind, s.batch, s.n_candidates) == (js.kind, js.batch, js.n_candidates)


@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("batch", [1, 512, 262144])
def test_dlrm_flops_match_jax(which, batch):
    cfg, jcfg = getattr(get_arch(ARCH), which), getattr(j_get_arch(ARCH), which)
    assert steps.dlrm_flops(cfg, batch) == j_dlrm_flops(jcfg, batch, False)


def test_requests_draw_as_the_jax_tests():
    """``tests/test_smoke_archs.py::test_recsys_smoke_train_step``'s draw."""
    cfg = get_arch(ARCH).smoke
    dense, sparse = steps.recsys_requests(cfg, 8, 0)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(dense, np.asarray(
        jnp.asarray(rng.normal(size=(8, cfg.n_dense)), jnp.float32)))
    np.testing.assert_array_equal(sparse, np.asarray(jnp.asarray(
        rng.integers(0, cfg.rows_per_table, (8, cfg.n_sparse, cfg.multi_hot)), jnp.int32)))
    assert dense.dtype == np.float32 and sparse.dtype == np.int32
    cand = steps.retrieval_candidates(cfg, 100, 0)
    assert cand.dtype == np.int32 and cand.min() >= 0 and cand.max() < cfg.rows_per_table


def test_init_params_law():
    cfg = dataclasses.replace(get_arch(ARCH).smoke, rows_per_table=4000, embed_dim=16)
    params = dlrm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == dlrm.param_shapes(cfg)
    assert all(v.dtype == torch.float32 for v in params.values())
    assert abs(float(params["tables"].std()) - 16**-0.5) < 0.01
    assert abs(float(params["top_w0"].std()) - params["top_w0"].shape[0] ** -0.5) < 0.02
    assert not params["bot_b0"].any()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _model_case(multi_hot=1, seed=0, **overrides):
    """The JAX config and parameters, and their port copies (CPU)."""
    jcfg = dataclasses.replace(j_get_arch(ARCH).smoke, multi_hot=multi_hot, **overrides)
    cfg = dataclasses.replace(get_arch(ARCH).smoke, multi_hot=multi_hot, **overrides)
    jparams = jdlrm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, dlrm_params_from_numpy(jparams, "cpu")


def test_triu_order_matches_jax():
    for f in (2, 5, 27):
        iu, ju = jnp.triu_indices(f, k=1)
        got = torch.triu_indices(f, f, 1)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(iu))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ju))


@pytest.mark.parametrize("case", ["one_hot", "multi_hot_3", "fields_26_wide_64"])
def test_embedding_bags_match_jax(case):
    """Equal at multi_hot = 1 (each bag is one row); within 1e-6 relative
    at multi_hot = 3; the full config's 26 fields × 64 wide catch a wrong
    f · V offset."""
    kw = dict(fields_26_wide_64=dict(n_sparse=26, embed_dim=64, rows_per_table=1000)).get(case, {})
    mh = 3 if case == "multi_hot_3" else 1
    jcfg, cfg, jparams, params = _model_case(mh, seed=1, **kw)
    _, sparse = steps.recsys_requests(cfg, 16, 2)
    want = np.asarray(jdlrm._embedding_bags(jparams, jnp.asarray(sparse), jcfg))
    got = dlrm._embedding_bags(params, torch.from_numpy(sparse), cfg, use_kernels=False).numpy()
    assert got.shape == want.shape == (16, cfg.n_sparse, cfg.embed_dim)
    if mh == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_embedding_bags_bad_ids_and_int32_limit():
    """An id outside [0, V) makes its (example, field) NaN and nothing else;
    F · V beyond int32 raises before any work."""
    _, cfg, _, params = _model_case()
    _, sparse = steps.recsys_requests(cfg, 4, 3)
    sparse[1, 2, 0], sparse[3, 0, 0] = cfg.rows_per_table, -1
    got = dlrm._embedding_bags(params, torch.from_numpy(sparse), cfg, use_kernels=False)
    nan = torch.isnan(got).all(-1)
    assert nan[1, 2] and nan[3, 0] and int(nan.sum()) == 2 and not torch.isnan(got[~nan]).any()
    huge = {"tables": torch.zeros(1, 1, 1).expand(4, 2**29, 1)}
    with pytest.raises(ValueError, match="int32"):
        dlrm._embedding_bags(huge, torch.zeros(1, 4, 1, dtype=torch.int32), cfg,
                             use_kernels=False)


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_forward_matches_jax(multi_hot):
    jcfg, cfg, jparams, params = _model_case(multi_hot, seed=2)
    dense, sparse = steps.recsys_requests(cfg, 16, 4)
    want = np.asarray(jdlrm.forward(jparams, jnp.asarray(dense), jnp.asarray(sparse), jcfg))
    got = dlrm.forward(params, torch.from_numpy(dense), torch.from_numpy(sparse), cfg,
                       use_kernels=False)
    assert got.shape == (16,) and got.dtype == torch.float32 and got.is_inference()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_retrieval_matches_jax_and_forward():
    """32 candidates against JAX ``retrieval_scores``, and against the
    port's forward with the last sparse field set to each candidate."""
    jcfg, cfg, jparams, params = _model_case(seed=3)
    dense, sparse = steps.recsys_requests(cfg, 1, 5)
    cand = steps.retrieval_candidates(cfg, 32, 5)
    want = np.asarray(jdlrm.retrieval_scores(jparams, jnp.asarray(dense), jnp.asarray(sparse),
                                             jnp.asarray(cand), jcfg))
    got = dlrm.retrieval_scores(params, torch.from_numpy(dense), torch.from_numpy(sparse),
                                torch.from_numpy(cand), cfg, use_kernels=False)
    assert got.shape == (32,)
    top = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * top
    rep = np.repeat(sparse, 32, axis=0)
    rep[:, -1, 0] = cand
    fwd = dlrm.forward(params, torch.from_numpy(np.repeat(dense, 32, axis=0)),
                       torch.from_numpy(rep), cfg, use_kernels=False)
    assert (got - fwd).abs().max() <= 1e-5 * top


def test_use_kernels_on_cpu_raises():
    _, cfg, _, params = _model_case()
    dense, sparse = steps.recsys_requests(cfg, 2, 0)
    with pytest.raises(ValueError, match="CUDA"):
        dlrm.forward(params, torch.from_numpy(dense), torch.from_numpy(sparse), cfg,
                     use_kernels=True)


# ---------------------------------------------------------------------------
# the serving driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_serve_driver_answers_with_forward(shape, capsys):
    """``launch.serve --arch dlrm-rm2 --device cpu --smoke`` answers each
    request as ``forward`` (``retrieval_scores``) does on the same draw,
    and prints a record with its seconds and batch."""
    res = tserve.main(["--arch", ARCH, "--device", "cpu", "--smoke", "--shape", shape,
                       "--requests", "2"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == len(res.records) == len(res.outputs) == 2
    cfg = get_arch(ARCH).smoke
    params = dlrm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = 1 if shape == "retrieval_cand" else 64
    for r, (rec, out) in enumerate(zip(res.records, res.outputs)):
        assert rec["shape"] == shape and rec["request"] == r and rec["batch"] == batch
        assert rec["seconds"] > 0 and rec["examples_per_s"] > 0
        dense, sparse = (torch.from_numpy(a) for a in steps.recsys_requests(cfg, batch, r))
        if shape == "retrieval_cand":
            cand = torch.from_numpy(steps.retrieval_candidates(cfg, 1024, r))
            want = dlrm.retrieval_scores(params, dense, sparse, cand, cfg, use_kernels=False)
        else:
            want = dlrm.forward(params, dense, sparse, cfg, use_kernels=False)
        assert torch.equal(out, want)
