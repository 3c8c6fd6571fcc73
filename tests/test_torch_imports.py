"""``repro_torch`` stands alone: it imports neither JAX nor the JAX package."""

import os
import re
import subprocess
import sys

from conftest import REPO, SRC

PKG = os.path.join(SRC, "repro_torch")

_BLOCKED = r'''
import sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
import repro_torch
from repro_torch.run import EXAMPLE_Q1, Pipeline, stages
s1, b0 = stages(Pipeline(EXAMPLE_Q1, "cpu", use_kernels=False), 1)
assert s1["phase"] == "stage1" and s1["count"] == 1282 and s1["overflow"] == 0, s1
assert b0["phase"] == "batch" and b0["count"] == 1238 and b0["overflow"] == 0, b0
from dataclasses import replace
w1, wb = stages(Pipeline(replace(EXAMPLE_Q1, pattern="q2_triangle", executor="wcoj"), "cpu",
                         use_kernels=False), 1)
assert w1["count"] == 188 and w1["overflow"] == 0, w1
assert wb["count"] == 182 and wb["overflow"] == 0 and wb["unit_refreshes"] == 0, wb
import torch
from repro_torch.configs import get_arch
from repro_torch.data import build_graph_data
from repro_torch.convert import graph_from_numpy
from repro_torch.models import gnn
cfg = get_arch("gatedgcn").smoke
params = gnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
out = gnn.forward(params, graph_from_numpy(build_graph_data(32, 96, cfg.d_in), "cpu"), cfg,
                  use_kernels=False)
assert out.shape == (32, cfg.d_out) and bool(torch.isfinite(out).all()), out
from repro_torch.models import transformer as tf
lm = get_arch("phi4-mini-3.8b").smoke
lm_params = tf.init_params(lm, torch.Generator().manual_seed(0), "cpu")
cache = tf.init_cache(lm, 2, 12, "cpu")
logits, cache = tf.prefill(lm_params, torch.randint(0, lm.vocab, (2, 8)), cache, lm,
                           use_kernels=False)
assert logits.shape == (2, 1, lm.vocab) and bool(torch.isfinite(logits).all()), logits
assert bool(cache["dense"][0][:, :, :, :8].any()) and not cache["dense"][0][:, :, :, 8:].any()
from repro_torch.launch import steps
from repro_torch.models import dlrm
rec = get_arch("dlrm-rm2").smoke
dense, sparse = steps.recsys_requests(rec, 4, 0)
scores = dlrm.forward(dlrm.init_params(rec, torch.Generator().manual_seed(0), "cpu"),
                      torch.from_numpy(dense), torch.from_numpy(sparse), rec, use_kernels=False)
assert scores.shape == (4,) and bool(torch.isfinite(scores).all()), scores
assert not any(m == "repro" or m.startswith(("repro.", "jax")) for m in sys.modules
               if sys.modules[m] is not None), "repro or jax was imported"
print("standalone OK")
'''


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _BLOCKED], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    assert "standalone OK" in out.stdout


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_imports_jax_or_repro():
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)
    scanned = {os.path.relpath(p, PKG) for p in _sources()}
    assert os.path.join("core", "match_engine.py") in scanned
    bad = []
    for path in _sources():
        with open(path) as fh:
            for m in pat.finditer(fh.read()):
                bad.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not bad, bad


def test_kernel_sources_are_shipped():
    csrc = os.path.join(PKG, "kernels", "csrc")
    assert sorted(os.listdir(csrc)) == ["embedding_bag.cu", "flash_attention.cu",
                                        "flash_attention_tc.cu", "flash_decode.cu",
                                        "member_probe.cu", "segment_sum.cu", "set_intersect.cu"]
