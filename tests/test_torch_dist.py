"""The port's NP-storage management (``repro_torch.dist``: rebalancing away
from slow partitions, elastic repartitioning) against the JAX package's
``repro.dist.straggler`` and ``repro.dist.elastic`` on the same inputs, made
from seeds: rebalance plans, partition codes, repartition reports and the
host engine's counts under the rebalanced partition function are held
exactly equal (the cases of ``tests/test_substrates.py``'s FT tests)."""

import numpy as np
import pytest

from conftest import random_graph

from repro.core import DDSL as JDDSL
from repro.core.pattern import PATTERN_LIBRARY as JLIB
from repro.core.storage import build_np_storage as jbuild
from repro.dist.elastic import repartition_delta as j_delta
from repro.dist.elastic import repartition_storage as j_repartition
from repro.dist.straggler import apply_rebalance as j_apply
from repro.dist.straggler import rebalance_plan as j_plan
from repro_torch.core import DDSL
from repro_torch.core.graph import Graph
from repro_torch.core.pattern import PATTERN_LIBRARY
from repro_torch.core.storage import build_np_storage
from repro_torch.dist import (apply_rebalance, rebalance_plan, repartition_delta,
                              repartition_storage)


def _port(g) -> Graph:
    return Graph._from_codes(g.n, np.asarray(g.codes, np.int64))


def _same_parts(ts, js):
    assert ts.m == js.m and len(ts.parts) == len(js.parts)
    for tp, jp in zip(ts.parts, js.parts):
        assert tp.codes.dtype == jp.codes.dtype and tp.codes.tobytes() == jp.codes.tobytes()
        assert np.array_equal(tp.center_vertices(), jp.center_vertices())


@pytest.mark.parametrize("n,e,seed,m,slow,fast,fraction", [
    (32, 80, 0, 4, [3], [0], 0.5),     # tests/test_substrates.py's case
    (48, 150, 5, 8, [1, 6], [2, 5], 0.3),
    (40, 100, 9, 4, [0, 2], [], 0.5),  # no fast partition: empty plan
])
def test_rebalance_equals_jax(n, e, seed, m, slow, fast, fraction):
    g = random_graph(n, e, seed=seed)
    js, ts = jbuild(g, m), build_np_storage(_port(g), m)
    plan = rebalance_plan(ts, slow=slow, fast=fast, fraction=fraction)
    assert plan == j_plan(js, slow=slow, fast=fast, fraction=fraction)
    assert all(type(k) is int and type(v) is int for k, v in plan.items())
    t2, j2 = apply_rebalance(ts, plan), j_apply(js, plan)
    _same_parts(t2, j2)
    if not plan:
        assert t2 is ts
        return
    # moved vertices are now centers of their new partition
    for u, p in plan.items():
        assert u in t2.parts[p].center_vertices().tolist()
    # Lemma 3.1: the rebalanced storage lists the same instances
    for name in ("q2_triangle", "q1_square"):
        eng = DDSL(_port(g), PATTERN_LIBRARY[name], m=m, h=t2.h)
        eng.initial()
        jeng = JDDSL(g, JLIB[name], m=m, h=j2.h)
        jeng.initial()
        base = DDSL(_port(g), PATTERN_LIBRARY[name], m=m)
        base.initial()
        assert eng.count() == jeng.count() == base.count()


@pytest.mark.parametrize("old_m,new_m", [(4, 8), (8, 4), (4, 3), (4, 4)])
def test_elastic_repartition_equals_jax(old_m, new_m):
    g = random_graph(40, 100, seed=1)
    js, ts = jbuild(g, old_m), build_np_storage(_port(g), old_m)
    delta = repartition_delta(ts, new_m)
    assert delta == j_delta(js, new_m)
    assert all(type(v) is int for v in delta.values())
    assert (delta["moved_centers"] > 0) == (old_m != new_m)
    t2 = repartition_storage(ts, new_m)
    _same_parts(t2, j_repartition(js, new_m))
    _same_parts(t2, build_np_storage(_port(g), new_m))


def test_repartition_of_a_rebalanced_storage_equals_jax():
    """The report reads the storage's own (overridden) partition function."""
    g = random_graph(48, 150, seed=5)
    js, ts = jbuild(g, 8), build_np_storage(_port(g), 8)
    plan = rebalance_plan(ts, slow=[1], fast=[2])
    t2, j2 = apply_rebalance(ts, plan), j_apply(js, plan)
    assert repartition_delta(t2, 4) == j_delta(j2, 4)
    assert repartition_delta(t2, 8) == j_delta(j2, 8)
    _same_parts(repartition_storage(t2, 4), j_repartition(j2, 4))


@pytest.mark.parametrize("n,e,seed,m", [(40, 100, 2, 8), (64, 220, 11, 8), (48, 150, 5, 4)])
def test_rebalance_of_the_busiest_partition_equals_jax(n, e, seed, m):
    """chip_smoke.py's choice: the partition storing the most edges is slow,
    the one storing the fewest is fast; then the rebalanced storage is re-cut
    at m // 2, and every step agrees with JAX's and lists the same counts."""
    g = random_graph(n, e, seed=seed)
    js, ts = jbuild(g, m), build_np_storage(_port(g), m)
    sizes = [p.num_edges for p in ts.parts]
    assert sizes == [p.num_edges for p in js.parts]
    slow, fast = [int(np.argmax(sizes))], [int(np.argmin(sizes))]
    plan = rebalance_plan(ts, slow=slow, fast=fast, fraction=0.5)
    assert plan and plan == j_plan(js, slow=slow, fast=fast, fraction=0.5)
    t2, j2 = apply_rebalance(ts, plan), j_apply(js, plan)
    _same_parts(t2, j2)
    assert repartition_delta(t2, m // 2) == j_delta(j2, m // 2)
    t3 = repartition_storage(t2, m // 2)
    _same_parts(t3, j_repartition(j2, m // 2))
    base = DDSL(_port(g), PATTERN_LIBRARY["q1_square"], m=m)
    base.initial()
    eng = DDSL(_port(g), PATTERN_LIBRARY["q1_square"], m=m, h=t2.h)
    eng.initial()
    assert eng.count() == base.count()
