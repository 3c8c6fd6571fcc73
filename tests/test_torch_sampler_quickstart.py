"""The port's last host pieces against the JAX package's, on the CPU.

- ``repro_torch.data.NeighborSampler`` draws the frontiers of
  ``repro.data.graphs.NeighborSampler`` bit for bit (the same NumPy draws in
  the same order) on ``rmat_graph(8, 1200, seed=0)`` with fanouts (4, 3),
  at sampler seeds 0 and 1, with ``tests/test_substrates.py``'s shape
  checks.
- ``examples/torch_quickstart.py``, run with ``jax`` blocked, prints the
  lines ``examples/quickstart.py`` prints; the two run as subprocesses side
  by side (each ~25 s: the host engine lists 40.8 M house matches).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, SRC
from repro.data.graphs import NeighborSampler as JNeighborSampler
from repro.data.graphs import rmat_graph as j_rmat_graph
from repro_torch.data import NeighborSampler, rmat_graph


@pytest.mark.parametrize("seed", [0, 1])
def test_neighbor_sampler_matches_jax(seed):
    g, jg = rmat_graph(8, 1200, seed=0), j_rmat_graph(8, 1200, seed=0)
    assert np.array_equal(g.indptr, jg.indptr) and np.array_equal(g.indices, jg.indices)
    feats = np.random.default_rng(0).normal(size=(g.n, 8)).astype(np.float32)
    mine = NeighborSampler(g, feats, fanouts=(4, 3), seed=seed)
    theirs = JNeighborSampler(jg, feats, fanouts=(4, 3), seed=seed)
    isolated = np.flatnonzero(g.degrees == 0)
    for seeds in (np.array([1, 2, 3]), np.array([0, 5, int(isolated[0]), 200, 255])):
        layers, want = mine.sample(seeds), theirs.sample(seeds)
        b = seeds.shape[0]
        assert [a.shape for a in layers] == [(b, 8), (4 * b, 8), (12 * b, 8)]
        assert len(layers) == len(want)
        for a, w in zip(layers, want):
            assert a.dtype == w.dtype and np.array_equal(a, w)
    # an isolated seed samples itself
    assert np.array_equal(layers[1][8:12], np.repeat(feats[isolated[:1]], 4, axis=0))


_TORCH = r'''
import runpy, sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
runpy.run_path(sys.argv[1], run_name="__main__")
assert not any(m == "repro" or m.startswith(("repro.", "jax")) for m in sys.modules
               if sys.modules[m] is not None), "repro or jax was imported"
'''


def test_quickstart_twin_prints_the_same_lines():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ex = os.path.join(REPO, "examples")
    procs = [subprocess.Popen([sys.executable, "-c", _TORCH,
                               os.path.join(ex, "torch_quickstart.py")], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
             subprocess.Popen([sys.executable, os.path.join(ex, "quickstart.py")], env=env,
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"{so}\n{se[-4000:]}"
    mine, theirs = (so.splitlines() for so, _ in outs)
    assert mine == theirs
    assert mine[0] == "data graph: n=1024 m=4710"
    assert any(line.startswith("initial |M(p, d)| = ") for line in mine)
