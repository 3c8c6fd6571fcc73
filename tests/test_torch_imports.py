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
    bad = []
    for path in _sources():
        with open(path) as fh:
            for m in pat.finditer(fh.read()):
                bad.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not bad, bad


def test_kernel_sources_are_shipped():
    csrc = os.path.join(PKG, "kernels", "csrc")
    assert sorted(os.listdir(csrc)) == ["member_probe.cu", "set_intersect.cu"]
