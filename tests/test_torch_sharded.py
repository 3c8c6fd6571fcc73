"""The port's steps against the JAX steps and the host engine: stage 1 plus
three stage-2 batches, exact equality (counts, match sets, tensors and
overflow counters).

- m = 1: byte-equal to ``repro.dist.sharded`` on a one-device mesh;
- m = 8: the port equals the host ``DDSL(graph, pattern, m=8)`` on the
  graph and caps of ``examples/distributed_listing.py``;
- m = 8 against the JAX steps on 8 fake devices: ``test_torch_spmd.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import random_graph
from test_torch_engine import assert_same

from repro.core import DDSL, build_np_storage, symmetry_break
from repro.core.cost import CostModel
from repro.core.ddsl import choose_cover
from repro.core.estimator import GraphStats
from repro.core.join_tree import minimum_unit_decomposition, optimal_join_tree
from repro.core.pattern import PATTERN_LIBRARY
from repro.core.graph import GraphUpdate
from repro.data.graphs import rmat_graph, sample_update
from repro.dist import jax_engine as jje
from repro.dist import sharded as jsh
from repro_torch import convert
from repro_torch import engine as tje
from repro_torch import sharded as tsh
from repro_torch.mesh import LocalMesh
from repro_torch.run import EXAMPLE_Q1, Pipeline

CAPS = dict(v_cap=64, deg_cap=32, e_cap=512, match_cap=2048, group_cap=2048,
            set_cap=32, pair_cap=64)


def _cpu_partitions(pt):
    return convert.partitions_from_numpy(pt, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(g, pname):
    pat = PATTERN_LIBRARY[pname]
    ord_ = symmetry_break(pat)
    stats = GraphStats.of(g)
    cover = choose_cover(pat, ord_, stats)
    tree = optimal_join_tree(pat, cover, CostModel(cover, ord_, stats))
    return pat, ord_, cover, jsh.build_tree_program(tree, cover, ord_), \
        minimum_unit_decomposition(pat, cover), stats


@pytest.mark.parametrize("pname", ["q1_square", "q2_triangle", "q5_house"])
def test_m1_steps_byte_equal_to_jax(pname):
    g = random_graph(36, 90, seed=7)
    pat, ord_, cover, prog, units, stats = _plan(g, pname)
    jc = jje.EngineCaps(**CAPS, use_pallas=False)
    tc = tje.EngineCaps(**CAPS, use_kernels=False)
    mesh, tmesh = jax.make_mesh((1,), ("data",)), LocalMesh(1)
    store_caps = jsh.match_caps(pat, cover, ord_, stats, jc)
    ush = jsh.UpdateShapes(n_add=3, n_del=3)
    tush = tsh.UpdateShapes(n_add=3, n_del=3)

    jpt = jsh.stack_partitions(build_np_storage(g, 1), jc)
    tpt = _cpu_partitions(jpt)
    jroot, jd = jsh.make_list_step(prog, mesh, jc)(jpt)
    troot, td = tsh.make_list_step(prog, tmesh, tc)(tpt)
    assert_same((jroot, jd), (troot, td))
    assert int(td["overflow"]) == 0
    jst, jd = jsh.make_init_store_step(prog, mesh, jc, store_caps)(jroot)
    tst, td = tsh.make_init_store_step(prog, tmesh, tc, store_caps)(troot)
    assert_same((jst, jd), (tst, td))

    jstore_step = jsh.make_storage_update_step(mesh, jc, ush)
    tstore_step = tsh.make_storage_update_step(tmesh, tc, tush)
    jmaint = jsh.make_maintain_step(prog, units, mesh, jc, store_caps)
    tmaint = tsh.make_maintain_step(prog, units, tmesh, tc, store_caps)
    cur = g
    for b in range(3):
        upd = sample_update(cur, 3, 3, seed=20 + b)
        cur = cur.apply_update(upd)
        add, dele = upd.add.astype(np.int32), upd.delete.astype(np.int32)
        jpt, jd = jstore_step(jpt, jnp.asarray(add), jnp.asarray(dele))
        tpt, td = tstore_step(tpt, torch.from_numpy(add), torch.from_numpy(dele))
        assert_same((jpt, jd), (tpt, td))
        jst, jpatch, jd = jmaint(jpt, jst, jnp.asarray(add), jnp.asarray(dele))
        tst, tpatch, td = tmaint(tpt, tst, torch.from_numpy(add), torch.from_numpy(dele))
        assert_same((jst, jpatch, jd), (tst, tpatch, td))
        assert int(td["overflow"]) == 0


def _rows(store, pat, cover, prog, ord_):
    skel_cols = prog.nodes[prog.root].skel_cols
    back = jje.comp_to_host(convert.comp_to_numpy(store.flatten()), pat, cover, skel_cols)
    return set(map(tuple, back.decompress(ord_)[1].tolist()))


@pytest.mark.parametrize("pname", ["q1_square", "q2_triangle"])
def test_m8_matches_host_ddsl(pname):
    cfg = dataclasses.replace(EXAMPLE_Q1, pattern=pname)
    pipe = Pipeline(cfg, "cpu", use_kernels=False)
    g = rmat_graph(cfg.n_log2, cfg.n_edges, seed=cfg.graph_seed)
    assert np.array_equal(g.codes, pipe.graph.codes)
    host = DDSL(g, PATTERN_LIBRARY[pname], m=cfg.m)
    assert tuple(host.cover) == tuple(pipe.cover)
    host.initial()
    d = pipe.initial()
    assert int(d["overflow"]) == 0 and int(d["count"]) == host.count()
    want = set(map(tuple, host.matches_plain().tolist()))
    assert _rows(pipe.store, pipe.pattern, pipe.cover, pipe.prog, pipe.ord) == want
    for _ in range(3):
        upd = pipe.next_update()
        d = pipe.apply(upd)
        host.apply(GraphUpdate(delete=upd.delete, add=upd.add))
        assert int(d["overflow"]) == 0 and int(d["count"]) == host.count()
        want = set(map(tuple, host.matches_plain().tolist()))
        assert _rows(pipe.store, pipe.pattern, pipe.cover, pipe.prog, pipe.ord) == want


def test_maintain_step_overwrites_its_input_store():
    pipe = Pipeline(dataclasses.replace(EXAMPLE_Q1, pattern="q2_triangle"), "cpu",
                    use_kernels=False)
    pipe.initial()
    before = pipe.store
    pipe.apply(pipe.next_update())
    assert pipe.store is before
