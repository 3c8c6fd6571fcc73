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
import repro_torch.obs, repro_torch.planner.compiler
from repro_torch.backend import TorchBackend
from repro_torch.core.pattern import PATTERN_LIBRARY
from repro_torch.data.graphs import rmat_graph, sample_update
from repro_torch.stream import SharedDelta
g = rmat_graph(7, 320, seed=0)
from repro_torch.engine import EngineCaps
caps = EngineCaps(**{f: getattr(EXAMPLE_Q1, f) for f in ("v_cap", "deg_cap", "e_cap",
                    "match_cap", "group_cap", "set_cap", "pair_cap")})
be = TorchBackend(g, m=8, caps=caps, max_add=4, max_del=4, device="cpu")
assert be.register("sq", PATTERN_LIBRARY["q1_square"]) == 1282
u = sample_update(g, 4, 4, seed=100)
rep = be.apply_batch(SharedDelta(lo=0, hi=8, update=u, add_codes=u.add_codes(),
                                 delete_codes=u.delete_codes()), set())
assert rep["sq"].count_after == 1238 and rep["sq"].overflow == 0, rep
import tempfile
from repro_torch.stream import BatchScheduler, CountDeltaSink, ListingService
# the service's device backend with narrower listing caps, which keep its
# CPU batches short: one 4 + 4 update a batch
small = replace(caps, group_cap=1024, match_cap=2048, pair_cap=128)
for kind, kw in (("host", {}), ("sharded", dict(m=8, caps=small, max_add=8, max_del=8,
                                                 device="cpu"))):
    svc = ListingService(g, backend=kind, scheduler=BatchScheduler(max_ops=8), **kw)
    assert svc.register("sq", PATTERN_LIBRARY["q1_square"]) == 1282
    sink = svc.subscribe(CountDeltaSink())
    for b, want in ((0, 1238), (1, 1128)):
        svc.ingest(sample_update(svc.projected_graph(), 4, 4, seed=100 + b))
        svc.advance()
        assert svc.counts() == {"sq": want} and svc.metrics[-1].overflow == 0, svc.metrics
    assert svc.audit() == {"sq": True} and sink.totals == {"sq": 1128 - 1282}
    with tempfile.TemporaryDirectory() as snap:
        svc.ingest(sample_update(svc.projected_graph(), 4, 4, seed=102))
        svc.snapshot(snap)
        back = ListingService.restore(snap, backend=kind, scheduler=BatchScheduler(max_ops=8),
                                      **kw)
    assert back.committed_watermark == svc.committed_watermark and back.counts() == svc.counts()
    back.advance()
    assert back.counts() == {"sq": 1086} and back.audit() == {"sq": True}, back.counts()
# the sharded service's default profiler booked every step it ran: each
# wrapper's first call as its warm-up, the second batch's steps as steady calls
prof = svc.obs.jaxprof.steps
assert set(prof) == {"storage_update", "maintain_mega", "list:sq", "init_store:sq",
                     "unit_refresh:sq"}, sorted(prof)
for name in ("storage_update", "maintain_mega"):
    assert (prof[name].compiles, prof[name].calls) == (1, 1) and prof[name].heuristic, prof[name]
    assert prof[name].execute_seconds > 0 and prof[name].memory["output_size_in_bytes"] > 0
assert prof["maintain_mega"].memory["alias_size_in_bytes"] > 0 and prof["maintain_mega"].subs == {"sq": 1.0}
from repro_torch.core.storage import build_np_storage
from repro_torch.dist import apply_rebalance, rebalance_plan, repartition_delta
st = build_np_storage(g, 8)
assert apply_rebalance(st, rebalance_plan(st, slow=[0], fast=[1])).m == 8
assert repartition_delta(st, 4)["new_m"] == 4
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
eq = get_arch("equiformer-v2").smoke
eq_g = graph_from_numpy(build_graph_data(32, 96, eq.d_in, geometric=True), "cpu")
eq_params = gnn.init_params(eq, torch.Generator().manual_seed(0), "cpu")
eq_out = gnn.forward(eq_params, eq_g, eq, use_kernels=False)
assert eq_out.shape == (32, eq.d_out) and bool(torch.isfinite(eq_out).all()), eq_out
from repro_torch.launch.steps import gnn_train_step
from repro_torch.optim import adamw_init
tr_g = gnn.train_graph(eq_g, eq)
tr_p, tr_o, tr_loss, tr_norm = gnn_train_step(eq_params, adamw_init(eq_params), tr_g,
                                              torch.arange(32) % 3, eq, use_kernels=False)
assert int(tr_o.step) == 1 and bool(torch.isfinite(tr_loss)) and float(tr_norm) > 0
assert sorted(tr_p) == sorted(eq_params) and not torch.equal(tr_p["out_b"], eq_params["out_b"])
from repro_torch.models import transformer as tf
lm = get_arch("phi4-mini-3.8b").smoke
lm_params = tf.init_params(lm, torch.Generator().manual_seed(0), "cpu")
cache = tf.init_cache(lm, 2, 12, "cpu")
logits, cache = tf.prefill(lm_params, torch.randint(0, lm.vocab, (2, 8)), cache, lm,
                           use_kernels=False)
assert logits.shape == (2, 1, lm.vocab) and bool(torch.isfinite(logits).all()), logits
assert bool(cache["dense"][0][:, :, :, :8].any()) and not cache["dense"][0][:, :, :, 8:].any()
from repro_torch.launch.serve import main as serve_main
ds = serve_main(["--arch", "deepseek-v2-lite-16b", "--device", "cpu", "--smoke", "--absorbed",
                 "--gen", "3"])
assert ds.ids.shape == (2, 3) and bool(torch.isfinite(ds.logits).all())
assert sorted(ds.cache) == ["dense", "moe"] and bool(ds.cache["moe"][0][:, :, :18].any())
from repro_torch.launch import steps
from repro_torch.models import dlrm
rec = get_arch("dlrm-rm2").smoke
dense, sparse = steps.recsys_requests(rec, 4, 0)
scores = dlrm.forward(dlrm.init_params(rec, torch.Generator().manual_seed(0), "cpu"),
                      torch.from_numpy(dense), torch.from_numpy(sparse), rec, use_kernels=False)
assert scores.shape == (4,) and bool(torch.isfinite(scores).all()), scores
from repro_torch.data import click_batches
from repro_torch.optim import adamw_init
dd, ds, dy = (torch.from_numpy(a) for a in next(click_batches(rec.n_dense, rec.n_sparse,
                                                              rec.rows_per_table, 16)))
dp = dlrm.init_params(rec, torch.Generator().manual_seed(0), "cpu")
dp, dopt, dloss, dnorm = steps.dlrm_train_step(dp, adamw_init(dp), dd, ds, dy, rec,
                                               use_kernels=False)
assert int(dopt.step) == 1 and bool(torch.isfinite(dloss)) and float(dnorm) > 0
lp = tf.init_params(lm, torch.Generator().manual_seed(0), "cpu")
from repro_torch.data import prefetch, token_batches
tk, tl = (torch.from_numpy(a) for a in next(prefetch(token_batches(lm.vocab, 2, 8))))
lopt = adamw_init(steps.flat_params(lp))
lp, lopt, lloss, lnorm = steps.lm_train_step(lp, lopt, tk, tl, lm, use_kernels=False)
assert int(lopt.step) == 1 and bool(torch.isfinite(lloss)) and float(lnorm) > 0
with tempfile.TemporaryDirectory() as ck:
    from repro_torch.launch.train import main as train_main
    assert len(train_main(["--smoke", "--device", "cpu", "--steps", "1", "--batch", "2",
                           "--seq", "8", "--ckpt-dir", ck, "--ckpt-every", "1"])) == 1
    from repro_torch.checkpoint import CheckpointManager
    assert CheckpointManager(ck).latest_step() == 1
# the mesh of processes (gloo, one rank here), its builders, the collectives
# and compression on a local mesh
import os
import torch.distributed as dist
from repro_torch.dist import (bucketed_all_to_all, butterfly_compressed_all_reduce,
                              ef_compress, ef_residual_init, ring_all_reduce)
from repro_torch.launch.mesh import init_process_mesh, make_local_mesh
with tempfile.TemporaryDirectory() as rdv:
    os.environ.update(RANK="0", WORLD_SIZE="1")
    pm = init_process_mesh(8, "cpu", timeout_s=30, init_method=f"file://{rdv}/store")
    (m1,) = stages(Pipeline(EXAMPLE_Q1, "cpu", use_kernels=False, mesh=pm), 0)
    assert m1["count"] == 1282 and m1["overflow"] == 0 and pm.calls["all_gather"] > 0, m1
    dist.destroy_process_group()
# one LM training step on a (1, 1) grid (gloo, one rank): the sharded
# step's code path, every collective on the one rank
from repro_torch.convert import lm_params_shard
from repro_torch.launch.mesh import init_grid_mesh
from repro_torch.models.transformer import RoutedStats
with tempfile.TemporaryDirectory() as rdv:
    grid = init_grid_mesh(1, 1, "cpu", timeout_s=30, init_method=f"file://{rdv}/store")
    gcfg = get_arch("granite-moe-3b-a800m").smoke
    gp = lm_params_shard(tf.init_params(gcfg, torch.Generator().manual_seed(0), "cpu"), gcfg,
                         grid, device="cpu")
    gopt = steps.lm_adamw_init(gp, gcfg, grid)
    gstats = RoutedStats()
    gk, gl = (torch.from_numpy(a) for a in next(token_batches(gcfg.vocab, 2, 8)))
    gp, gopt, gloss, gnorm = steps.lm_train_step(gp, gopt, gk, gl, gcfg, use_kernels=False,
                                                 mesh=grid, stats=gstats)
    assert int(gopt.step) == 1 and bool(torch.isfinite(gloss)) and float(gnorm) > 0
    assert gstats.summary()["overflow"] == 0 and grid.calls["all_to_all/model"] > 0, grid.calls
    dist.destroy_process_group()
# one EquiformerV2 training step on a (1, 1) grid (gloo, one rank): the mesh
# gathers and segment sums with the channel split, ZeRO-1 moments; at world
# 1 the one-device step's loss and norm
from repro_torch.convert import graph_shard
with tempfile.TemporaryDirectory() as rdv:
    grid = init_grid_mesh(1, 1, "cpu", timeout_s=30, init_method=f"file://{rdv}/store")
    mtg = gnn.train_graph(graph_shard(build_graph_data(32, 96, eq.d_in, geometric=True), grid,
                                      device="cpu"), eq, mesh=grid)
    mp, mo, mloss, mnorm = gnn_train_step(eq_params, steps.gnn_adamw_init(eq_params, eq, grid),
                                          mtg, torch.arange(32) % 3, eq, use_kernels=False)
    assert int(mo.step) == 1 and float(mloss) == float(tr_loss) and float(mnorm) == float(tr_norm)
    assert grid.calls["all_to_all/model"] > 0 and grid.calls["reduce_scatter/data"] > 0, grid.calls
    dist.destroy_process_group()
# one DLRM training step on a (1, 1) grid (gloo, one rank): the tables' rows
# over "model", the bags' sum over it, ZeRO-1 moments; at world 1 the
# one-device step bit for bit
from repro_torch.convert import dlrm_params_shard
with tempfile.TemporaryDirectory() as rdv:
    grid = init_grid_mesh(1, 1, "cpu", timeout_s=30, init_method=f"file://{rdv}/store")
    d1 = dlrm.init_params(rec, torch.Generator().manual_seed(0), "cpu")
    dg = dlrm_params_shard(d1, rec, grid, device="cpu")
    dg, dgo, dgl, dgn = steps.dlrm_train_step(dg, steps.dlrm_adamw_init(dg, rec, grid), dd, ds,
                                              dy, rec, use_kernels=False, mesh=grid)
    d1, d1o, d1l, d1n = steps.dlrm_train_step(d1, adamw_init(d1), dd, ds, dy, rec,
                                              use_kernels=False)
    assert float(dgl) == float(d1l) and float(dgn) == float(d1n), (dgl, d1l, dgn, d1n)
    for k in d1:
        assert torch.equal(dg[k], d1[k]) and torch.equal(dgo.mu[k], d1o.mu[k]), k
        assert torch.equal(dgo.nu[k], d1o.nu[k]), k
    assert grid.calls["all_reduce/model"] > 0 and grid.calls["all_reduce/data"] > 0, grid.calls
    dist.destroy_process_group()
lm4 = make_local_mesh(4)
assert torch.equal(ring_all_reduce([torch.ones(3)] * 4, lm4)[2], torch.full((3,), 4.0))
assert torch.equal(butterfly_compressed_all_reduce([torch.ones(3)] * 4, lm4)[0],
                   torch.full((3,), 4.0))
_, _, ovf = bucketed_all_to_all([[torch.arange(6)]] * 4, [torch.zeros(6, dtype=torch.int32)] * 4,
                                [torch.ones(6, dtype=torch.bool)] * 4, lm4, 4)
assert int(ovf) == 8, ovf
q, _, _ = ef_compress({"w": torch.ones(4)}, ef_residual_init({"w": torch.ones(4)}))
assert q["w"].dtype == torch.int8
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
    yield os.path.join(REPO, "examples", "torch_subgraph_service.py")
    yield os.path.join(REPO, "examples", "torch_train_gnn.py")
    yield os.path.join(REPO, "examples", "torch_train_lm.py")
    yield os.path.join(REPO, "examples", "torch_train_lm_mesh.py")
    yield os.path.join(REPO, "examples", "torch_train_gnn_mesh.py")
    yield os.path.join(REPO, "examples", "torch_train_dlrm_mesh.py")
    yield os.path.join(REPO, "examples", "torch_quickstart.py")


def test_no_source_imports_jax_or_repro():
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)
    scanned = {os.path.relpath(p, PKG) for p in _sources()}
    for rel in (("core", "match_engine.py"), ("core", "ddsl.py"), ("core", "unit_cache.py"),
                ("stream", "service.py"), ("stream", "plan_manager.py"),
                ("stream", "journal.py"), ("stream", "sinks.py"), ("obs", "prof.py"),
                ("dist", "__init__.py"), ("dist", "straggler.py"), ("dist", "elastic.py"),
                ("optim", "__init__.py"), ("optim", "adamw.py"), ("optim", "schedule.py"),
                ("launch", "steps.py"), ("launch", "train.py"),
                ("checkpoint", "checkpoint.py"), ("data", "recsys.py"), ("data", "tokens.py"),
                ("data", "pipeline.py"), ("kernels", "flash_attention_bwd.py"),
                ("..", "..", "examples", "torch_subgraph_service.py"),
                ("..", "..", "examples", "torch_train_gnn.py"),
                ("..", "..", "examples", "torch_train_lm.py"), ("mesh.py",),
                ("launch", "mesh.py"), ("dist", "collectives.py"), ("models", "common.py"),
                ("models", "transformer.py"), ("convert.py",), ("sharding.py",),
                ("..", "..", "examples", "torch_train_lm_mesh.py"),
                ("..", "..", "examples", "torch_train_gnn_mesh.py"), ("models", "gnn.py"),
                ("..", "..", "examples", "torch_train_dlrm_mesh.py"),
                ("..", "..", "examples", "torch_quickstart.py"), ("models", "dlrm.py"),
                ("data", "graphs.py")):
        assert os.path.join(*rel) in scanned, rel
    bad = []
    for path in _sources():
        with open(path) as fh:
            for m in pat.finditer(fh.read()):
                bad.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not bad, bad


def test_kernel_sources_are_shipped():
    csrc = os.path.join(PKG, "kernels", "csrc")
    assert sorted(os.listdir(csrc)) == ["embedding_bag.cu", "flash_attention.cu",
                                        "flash_attention_bwd.cu", "flash_attention_bwd_tc.cu",
                                        "flash_attention_tc.cu", "flash_decode.cu", "hopper.cuh",
                                        "member_probe.cu", "segment_sum.cu", "set_intersect.cu"]
