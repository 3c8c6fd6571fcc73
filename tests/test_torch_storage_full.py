"""The port's full-gather storage update (``mode="full"``) against its delta
update, the JAX ``mode="full"`` step at m = 1 and a host rebuild: byte for
byte, overflow counters included (mirrors test_sharded's full/delta
tests). Every run on the CPU with the plain versions of the kernels."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import random_graph
from test_sharded import _sample_batch
from test_torch_engine import assert_same

from repro.core import build_np_storage
from repro.core.graph import GraphUpdate
from repro.core.storage import update_np_storage
from repro.dist import jax_engine as jje
from repro.dist import sharded as jsh
from repro_torch import convert
from repro_torch import engine as tje
from repro_torch import sharded as tsh
from repro_torch.mesh import LocalMesh

CAPS = dict(v_cap=64, deg_cap=32, e_cap=512, match_cap=2048, group_cap=2048,
            set_cap=32, pair_cap=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(pt, j):
    hi, lo = pt.edge_hi[j].numpy(), pt.edge_lo[j].numpy()
    return {(int(a), int(b)) for a, b in zip(hi, lo) if a >= 0}


@pytest.mark.parametrize("m", [1, 8])
def test_full_matches_delta_over_50_batches(m):
    """Over a randomized 50-batch stream the full rebuild equals the delta
    update on every partition tensor and every shared diag key, equals
    JAX's full step at m = 1, and ends at a host rebuild."""
    n = 30
    g = random_graph(n, 70, seed=21)
    tc = tje.EngineCaps(**CAPS, use_kernels=False)
    mesh = LocalMesh(m)
    storage = build_np_storage(g, m)
    pt = tsh.stack_partitions(storage, tc, "cpu")
    ush = tsh.UpdateShapes(n_add=3, n_del=3)
    full = tsh.make_storage_update_step(mesh, tc, ush, mode="full")
    delta = tsh.make_storage_update_step(mesh, tc, ush, mode="delta")
    if m == 1:
        jc = jje.EngineCaps(**CAPS, use_pallas=False)
        jmesh = jax.make_mesh((1,), ("data",))
        jfull = jsh.make_storage_update_step(jmesh, jc, jsh.UpdateShapes(n_add=3, n_del=3),
                                             mode="full")
    rng = np.random.default_rng(33)
    cur = storage
    for b in range(50):
        add, dele = _sample_batch(cur.graph, rng, 3, n)
        ta = torch.from_numpy(add.astype(np.int32))
        td = torch.from_numpy(dele.astype(np.int32))
        ptf, df = full(pt, ta, td)
        ptd, dd = delta(pt, ta, td)
        assert sorted(df) == ["overflow", "part_dirty", "stored_edges"]
        assert_same((ptf, df), (ptd, {k: dd[k] for k in df}), f"batch {b}")
        assert int(df["overflow"]) == 0
        if m == 1:
            want = jfull(jsh.stack_partitions(cur, jc), jnp.asarray(ta.numpy()),
                         jnp.asarray(td.numpy()))
            assert_same(want, (ptf, df), f"batch {b} against JAX")
        pt = ptf
        cur, _ = update_np_storage(cur, GraphUpdate(delete=dele, add=add))
    rebuilt = build_np_storage(cur.graph, m)
    for j in range(m):
        want = {(int(c >> 32), int(c & 0xFFFFFFFF)) for c in rebuilt.parts[j].codes}
        assert _edges(pt, j) == want


def test_full_edge_cases_match_delta_and_jax(monkeypatch):
    """Fresh vertex ids, padded batch rows and an out-of-bounds insert
    (counted as overflow, skipped) give the delta update's and JAX's
    results; the common-neighbour test runs in many row slices."""
    monkeypatch.setattr(tje, "_SLICE_CELLS", 64)
    g = random_graph(20, 40, seed=2)
    caps = dict(v_cap=64, deg_cap=16, e_cap=256, match_cap=1024, group_cap=1024,
                set_cap=16, pair_cap=32)
    jc = jje.EngineCaps(**caps, use_pallas=False)
    tc = tje.EngineCaps(**caps, use_kernels=False)
    jmesh, tmesh = jax.make_mesh((1,), ("data",)), LocalMesh(1)
    jpt = jsh.stack_partitions(build_np_storage(g, 1), jc)
    tpt = convert.partitions_from_numpy(jpt, device="cpu")
    jfull = jsh.make_storage_update_step(jmesh, jc, jsh.UpdateShapes(n_add=2, n_del=2),
                                         mode="full")
    ush = tsh.UpdateShapes(n_add=2, n_del=2)
    full = tsh.make_storage_update_step(tmesh, tc, ush, mode="full")
    delta = tsh.make_storage_update_step(tmesh, tc, ush, mode="delta")
    cases = [
        # brand-new vertices 40 / 55 and a padded delete row
        (np.array([[40, 55], [3, 40]]), np.concatenate([g.edges()[:1], [[-1, -1]]]), 0),
        # an out-of-bounds insert and a padded row
        (np.array([[0, 64 + 5], [-1, -1]]), np.full((2, 2), -1), 1),
    ]
    for add, dele, ovf in cases:
        ta = torch.from_numpy(add.astype(np.int32))
        td = torch.from_numpy(dele.astype(np.int32))
        ptf, df = full(tpt, ta, td)
        ptd, dd = delta(tpt, ta, td)
        assert_same((ptf, df), (ptd, {k: dd[k] for k in df}))
        assert_same(jfull(jpt, jnp.asarray(add, jnp.int32), jnp.asarray(dele, jnp.int32)),
                    (ptf, df))
        assert int(df["overflow"]) == ovf


def test_full_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown update mode"):
        tsh.make_storage_update_step(LocalMesh(1), tje.EngineCaps(**CAPS), tsh.UpdateShapes(1, 1),
                                     mode="rebuild")
