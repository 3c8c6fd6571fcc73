"""DLRM on a ("data", "model") grid of ranks: the PyTorch port's sharded
training, serving and retrieval (JAX's ``_dlrm_cell`` on a 2-axis mesh).

    PYTHONPATH=src python examples/torch_train_dlrm_mesh.py --world 4 --data 2 --model 2 \\
        --steps 3 --check single
    PYTHONPATH=src python examples/torch_train_dlrm_mesh.py --device cpu --smoke --world 4 \\
        --data 2 --model 2 --steps 2

The script spawns ``--world`` ranks itself (NCCL, one rank a card, on
``--device cuda``, the default, which raises without CUDA; gloo on
``--device cpu``) and lays a ``(--data, --model)`` grid over them
(:func:`repro_torch.launch.mesh.init_grid_mesh`). Each rank draws the whole
dlrm-rm2 model from seed 0 (``_FULL``: 26 tables of 1,000,000 x 64 float32,
or the smoke config with ``--smoke``) and keeps its shards: its rows of the
tables, the MLPs whole, ZeRO-1 moments. It runs ``--steps`` of
``dlrm_train_step(..., mesh=grid)`` at ``_dlrm_cell``'s 1e-3 on the
``train_batch`` batches of ``click_batches(seed=0)`` (its data rank's
examples, the lookups on its rows summed over ``model``, the kernels on the
card), then answers one ``serve_p99``, one ``serve_bulk`` and one
``retrieval_cand`` request through ``serve_recsys(..., mesh=grid)``, each
after a warm-up request.

Then one check:

- ``--check single`` (default): each rank also takes the steps on one
  device (its card) from the same initial state and holds its slice of
  that state against its own after each step, element by element
  (:func:`_state_gaps`: step 1 to the limits below, every step within
  AdamW's largest swing);
  after the group is torn down, the same steps on one device in this
  process: the first step's loss and gradient norm within ``LIMIT`` of the
  grid's, each later step's within ``TRAJECTORY_LIMIT``; and the grid's
  logits and scores (put together from the ranks' parts) within
  ``SERVE_LIMIT`` of the largest value rank 0 computes on one device from
  the grid's own trained parameters, gathered whole. The one-device run's
  own requests after its own steps are reported beside them, with their
  gap to the grid's;
- ``--check plain``: each rank replays step 1 from the same initial state
  on the same grid with the kernels' plain versions; loss and gradient norm
  within ``LIMIT`` of the kernel run's.

Prints one JSON line per step and rank, per request and rank, and per
check (seconds, peak GiB, the ``embedding_bag`` and ``segment_sum``
launches, the collectives' calls and bytes by kind and axis); a failed
check or rank exits nonzero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.run import _require_device  # noqa: E402

# Loss and gradient norm of a step from the same state as one device's (or
# the plain versions'): float32 throughout, the sums over the data ranks and
# the lookups' sum over model in another order than one device's.
LIMIT = 1e-5
# Steps after the first start from states that already differ: AdamW's
# direction (m / bc1) / (sqrt(v / bc2) + EPS) moves an element whose first
# moment lies within a few EPS of zero by anything up to lr either way as the
# last bits of its gradient go, and those moves feed the next gradients, so
# the two runs part step by step (1.1e-5 in the third step's norm on four
# H100s); a two-hundredth of the 2-3 % a step moves the loss still holds
# them to one run.
TRAJECTORY_LIMIT = 1e-4
SERVE_LIMIT = 1e-5   # logits and scores, of the largest one-device value
# AdamW's defaults (adamw_update_). FIRM elements (one device's |m / bc1| at
# least 100 EPS) move within 1 % of their relative gradient gap at step 1.
B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1
FIRM = 100 * EPS
TIMEOUT_S = 900.0
LR, SEED = 1e-3, 0   # _dlrm_cell's step; the parameters' draw
SERVE_SHAPES = ("serve_p99", "serve_bulk", "retrieval_cand")
KERNELS = ("embedding_bag", "segment_sum")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spec():
    from repro_torch.configs import get_arch

    return get_arch("dlrm-rm2")


def _config(args):
    return _spec().smoke if args.smoke else _spec().config


def _shape(args, name: str):
    """The request shape; with ``--smoke`` the smoke cell's sizes (at most
    64 examples, 1,024 candidates, as ``_dlrm_cell(smoke=True)``)."""
    shape = _spec().shape(name)
    if args.smoke:
        shape = dataclasses.replace(shape, batch=min(shape.batch, 64),
                                    n_candidates=min(shape.n_candidates, 1024))
    return shape


def _batches(cfg, args, device):
    from repro_torch.data import click_batches

    stream = click_batches(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table,
                           _shape(args, "train_batch").batch, multi_hot=cfg.multi_hot, seed=0)
    return [tuple(torch.from_numpy(a).to(device) for a in next(stream))
            for _ in range(args.steps)]


def _whole_params(cfg, device):
    from repro_torch.models import dlrm

    return dlrm.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> dict:
    from repro_torch.kernels import ops

    return {k: v for k, v in ops.launch_counts().items() if v}


def _serve(cfg, params, args, dev, mesh=None):
    """A warm-up request (seed 1000) and one request (seed 0) of each
    ``SERVE_SHAPES`` shape: ``(outputs by shape, records)``."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_recsys

    outputs, recs = {}, []
    for name in SERVE_SHAPES:
        shape = _shape(args, name)
        kw = dict(use_kernels=dev.type == "cuda", device=dev, mesh=mesh)
        serve_recsys(cfg, params, shape, 1, seed=1000, **kw)
        ops.reset_launch_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        res = serve_recsys(cfg, params, shape, 1, **kw)
        rec = {**res.records[0], "launches": _launches()}
        if dev.type == "cuda":
            rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        outputs[name] = res.outputs[0].float().cpu().numpy()
        recs.append(rec)
    return outputs, recs


def _gaps(place, mesh, grid, one, t: int, prev):
    """One leaf's gaps after step ``t`` at this rank's moment positions:
    ``grid`` and ``one`` are ``(param, mu, nu)``, the grid's this rank's
    shards and ZeRO-1 moments, one device's whole; ``prev`` the signed
    parameter gap there before the step (None before step 1, one state).
    Of the largest one-device magnitude: the moments' gaps; the parameters'
    gap over all and over the FIRM elements (``|m / bc1| >= FIRM``); and
    how far the parameters' gap is from the one AdamW's rule gives from
    the gap before the step and each run's own moments, ``prev (1 - lr wd)
    - lr (u_grid - u_one)``: what the rule leaves unexplained. Returns the
    record and the signed gap."""
    bc1, bc2 = 1 - B1 ** t, 1 - B2 ** t
    sp = mesh.slices(place.spec, place.shape, mesh.rank)
    sm = mesh.slices(place.moment_spec, place.shape, mesh.rank)
    rel = tuple(slice(m.start - p.start, m.stop - p.start) for m, p in zip(sm, sp))
    p_g, m_g, v_g = grid[0][rel].float(), grid[1], grid[2]
    p_o, m_o, v_o = one[0][sm].float(), one[1][sm], one[2][sm]
    diff = p_g - p_o
    gap = diff.abs()
    firm = (m_o / bc1).abs() >= FIRM
    top = lambda x: max(float(x.abs().max()), 1e-30)  # noqa: E731
    u = lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + EPS)  # noqa: E731
    rule = -LR * (u(m_g, v_g) - u(m_o, v_o))
    if prev is not None:
        rule += prev * (1 - LR * WD)
    out = {"n": gap.numel(), "firm": int(firm.sum()),
           "mu_ratio": float((m_g - m_o).abs().max()) / top(m_o),
           "nu_ratio": float((v_g - v_o).abs().max()) / top(v_o),
           "param_ratio": float(gap.max()) / top(p_o),
           "param_ratio_firm": float(torch.where(firm, gap, 0).max()) / top(p_o),
           "unexplained_ratio": float((diff - rule).abs().max()) / top(p_o),
           "param_max_abs": float(gap.max()), "param_max_abs_ref": top(p_o),
           "over_limit": int((gap > LIMIT * top(p_o)).sum()),
           "over_limit_firm": int((firm & (gap > LIMIT * top(p_o))).sum())}
    return out, diff


def _state_gaps(cfg, mesh, snaps, batches, use_kernels: bool) -> list:
    """This rank's state after each grid step (``snaps[i]``: its shards and
    ZeRO-1 moments, ``(params, mu, nu)`` on the host) against the same
    slices of one device's state after the same step from the same
    parameters, taken here on the rank's own device, element by element
    (:func:`_gaps`, by leaf). The ranks' moment slices cover every
    element."""
    from repro_torch.launch import steps
    from repro_torch.models import dlrm
    from repro_torch.optim import adamw_init

    dev = mesh.device
    place = dlrm.dlrm_placements(cfg, mesh)
    whole = _whole_params(cfg, dev)
    opt = adamw_init(whole)
    out, prev = [], {}
    for i, (snap, batch) in enumerate(zip(snaps, batches)):
        steps.dlrm_train_step(whole, opt, *batch, cfg, lr=LR, use_kernels=use_kernels)
        rec = {}
        for k in sorted(place):
            grid = tuple(d[k].to(dev) for d in snap)
            rec[k], prev[k] = _gaps(place[k], mesh, grid, (whole[k], opt.mu[k], opt.nu[k]),
                                    i + 1, prev.get(k))
            del grid
        out.append(rec)
    del whole, opt, prev
    return out


def _rank(rank: int, world: int, port: int, args, out: str) -> None:
    """One rank: the steps and requests on the grid, then with ``--check
    single`` step 1 on one device against the grid's state after it, or
    with ``--check plain`` step 1 again with the plain versions."""
    import torch.distributed as dist
    from repro_torch.convert import dlrm_params_shard
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_grid_mesh
    from repro_torch.models import dlrm
    from repro_torch.sharding import MODEL

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    mesh = init_grid_mesh(args.data, args.model, args.device, timeout_s=TIMEOUT_S)
    dev = mesh.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _config(args)

    def fresh():
        whole = _whole_params(cfg, dev)
        params = dlrm_params_shard(whole, cfg, mesh, device=dev)
        del whole
        if cuda:
            torch.cuda.empty_cache()
        return params, steps.dlrm_adamw_init(params, cfg, mesh)

    params, opt = fresh()
    batches = _batches(cfg, args, dev)
    recs, snaps = [], []
    for i, (dense, sparse, labels) in enumerate(batches):
        ops.reset_launch_counts()
        mesh.reset_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, loss, gnorm = steps.dlrm_train_step(params, opt, dense, sparse, labels,
                                                         cfg, lr=LR, use_kernels=cuda, mesh=mesh)
        _sync(dev)
        rec = {"step": i, "rank": rank, "coords": mesh.coords(rank), "loss": float(loss),
               "gnorm": float(gnorm), "seconds": time.perf_counter() - t0,
               "launches": _launches(), "collective_calls": dict(mesh.calls),
               "collective_bytes": dict(mesh.bytes)}
        if cuda:
            rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        recs.append(rec)
        if args.check == "single":   # on the host: the card's peak stays the step's
            snaps.append(tuple({k: t.to("cpu", copy=True) for k, t in d.items()}
                               for d in (params, opt.mu, opt.nu)))
            dist.barrier()   # the next step's seconds wait for no rank's copy
    outputs, serve_recs = _serve(cfg, params, args, dev, mesh)
    for name, a in outputs.items():
        np.save(os.path.join(out, f"rank{rank}_{name}.npy"), a)
    state = None
    if args.check == "single":
        # the one-device requests on these parameters, gathered whole
        whole = dict(params)
        if dlrm.dlrm_placements(cfg, mesh)["tables"].model_dim is not None:
            whole["tables"] = mesh.all_gather(params["tables"], MODEL, 1).contiguous()
        if rank == 0:
            for name, a in _serve(cfg, whole, args, dev)[0].items():
                np.save(os.path.join(out, f"single_{name}.npy"), a)
        del whole
        state = _state_gaps(cfg, mesh, snaps, batches, cuda)
    del snaps, batches
    plain = None
    if args.check == "plain":
        del params, opt
        if cuda:
            torch.cuda.empty_cache()
        params, opt = fresh()
        _, _, loss, gnorm = steps.dlrm_train_step(
            params, opt, *_batches(cfg, args, dev)[0], cfg, lr=LR, use_kernels=False, mesh=mesh)
        plain = {"loss": float(loss), "gnorm": float(gnorm)}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"steps": recs, "serve": serve_recs, "plain": plain, "state": state}, f)
    dist.destroy_process_group()


def _single(cfg, args, dev):
    """The same steps and requests on one device (no mesh)."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init

    params = _whole_params(cfg, dev)
    opt = adamw_init(params)
    out = []
    for dense, sparse, labels in _batches(cfg, args, dev):
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, loss, gnorm = steps.dlrm_train_step(params, opt, dense, sparse, labels, cfg,
                                                         lr=LR, use_kernels=dev.type == "cuda")
        _sync(dev)
        out.append({"loss": float(loss), "gnorm": float(gnorm),
                    "seconds": time.perf_counter() - t0})
    if dev.type == "cuda":
        out[-1]["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del opt
    outputs, recs = _serve(cfg, params, args, dev)
    return out, outputs, recs


def _whole_output(args, out: str, name: str, n: int) -> np.ndarray:
    """A request's whole output from the ranks' parts: the data ranks' rows
    (a retrieval: every rank's candidates) in order, or rank 0's where every
    rank answered all ``n``."""
    from repro_torch.mesh import GridShape

    grid = GridShape((args.data, args.model), ("data", "model"))
    parts = [np.load(os.path.join(out, f"rank{r}_{name}.npy")) for r in range(args.world)]
    if parts[0].shape[0] == n:
        return parts[0]
    if name == "retrieval_cand":
        return np.concatenate(parts)
    return np.concatenate([parts[grid.lines("model")[d][0]] for d in range(args.data)])


def _slice_owners(cfg, args) -> dict:
    """Per leaf, the first rank that holds each distinct ZeRO-1 moment
    slice (ranks that differ only where the moments are replicated hold
    the same one): their element counts add up to the leaf's once."""
    from repro_torch.mesh import GridShape
    from repro_torch.models import dlrm

    grid = GridShape((args.data, args.model), ("data", "model"))
    out = {}
    for k, place in dlrm.dlrm_placements(cfg, grid).items():
        seen = {}
        for r in range(args.world):
            key = tuple((sl.start, sl.stop) for sl in grid.slices(place.moment_spec,
                                                                  place.shape, r))
            seen.setdefault(key, r)
        out[k] = sorted(seen.values())
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check", choices=("single", "plain"), default="single")
    args = ap.parse_args(argv)
    if args.data * args.model != args.world:
        raise ValueError(f"a ({args.data}, {args.model}) grid needs {args.data * args.model} "
                         f"ranks, --world is {args.world}")
    dev = _require_device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        if torch.cuda.device_count() < args.world:
            raise RuntimeError(f"{args.world} ranks need {args.world} cards, "
                               f"{torch.cuda.device_count()} visible")
        from repro_torch.kernels import build

        build.library()     # once, before the ranks load it
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _config(args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines() if cuda else []
    emit({"phase": "plan", "arch": cfg.name, "nvidia_smi": smi, "grid": [args.data, args.model],
          "world": args.world, "backend": "nccl" if cuda else "gloo",
          "batch": _shape(args, "train_batch").batch, "steps": args.steps,
          "params": cfg.param_count(), "tables": [cfg.n_sparse, cfg.rows_per_table,
                                                  cfg.embed_dim],
          "serve": {n: [_shape(args, n).batch, _shape(args, n).n_candidates]
                    for n in SERVE_SHAPES},
          "check": args.check, "device": torch.cuda.get_device_name(0) if cuda else "cpu"})
    failures = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        torch.multiprocessing.start_processes(
            _rank, args=(args.world, _free_port(), args, out), nprocs=args.world, join=True,
            start_method="spawn")
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(args.world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        grid_out, same_params = {}, {}
        for name in SERVE_SHAPES:
            if args.check == "single":
                same_params[name] = np.load(os.path.join(out, f"single_{name}.npy"))
            shape = _shape(args, name)
            n = shape.n_candidates if shape.kind == "retrieval" else shape.batch
            grid_out[name] = _whole_output(args, out, name, n)
            check(grid_out[name].shape == (n,), f"{name}: output shape "
                  f"{grid_out[name].shape} != ({n},)")

    for i in range(args.steps):
        recs = [rk["steps"][i] for rk in ranks]
        for rec in recs:
            emit({"phase": "mesh_step", **rec})
        losses = {rec["loss"] for rec in recs}
        check(len(losses) == 1, f"step {i}: the ranks' losses differ: {losses}")
        check(all(math.isfinite(rec["loss"]) and math.isfinite(rec["gnorm"]) for rec in recs),
              f"step {i}: a loss or norm is not finite")
        if cuda:
            check(all(rec["launches"].get(k) == 1 for rec in recs for k in KERNELS),
                  f"step {i}: launches a rank {[rec['launches'] for rec in recs]}, not one "
                  f"embedding_bag and one segment_sum")
    for rk in ranks:
        for rec in rk["serve"]:
            emit({"phase": "mesh_serve", **rec})
            if cuda:
                check(rec["launches"] == {"embedding_bag": 1},
                      f"{rec['shape']}: launches {rec['launches']} on rank {rec['rank']}")
    check(all(np.isfinite(a).all() for a in grid_out.values()), "a grid output is not finite")
    summary = {"phase": "mesh_train", "arch": cfg.name, "grid": [args.data, args.model],
               "losses": [ranks[0]["steps"][i]["loss"] for i in range(args.steps)],
               "gnorms": [ranks[0]["steps"][i]["gnorm"] for i in range(args.steps)],
               "step_seconds": [max(rk["steps"][i]["seconds"] for rk in ranks)
                                for i in range(args.steps)],
               "median_step_seconds": statistics.median(
                   max(rk["steps"][i]["seconds"] for rk in ranks) for i in range(args.steps)),
               "spawned_seconds": spawn_s}
    if cuda:
        summary["peak_gib_by_rank"] = [max(s["peak_gib"] for s in rk["steps"] + rk["serve"])
                                       for rk in ranks]
    emit(summary)

    if args.check == "single":
        t1 = time.perf_counter()
        one, one_out, one_recs = _single(cfg, args, dev)
        gaps = []
        for i, rec in enumerate(one):
            limit = LIMIT if i == 0 else TRAJECTORY_LIMIT
            got = ranks[0]["steps"][i]
            gap = {"step": i, "loss_single": rec["loss"], "loss_mesh": got["loss"],
                   "loss_ratio": abs(got["loss"] - rec["loss"]) / abs(rec["loss"]),
                   "gnorm_single": rec["gnorm"], "gnorm_mesh": got["gnorm"],
                   "gnorm_ratio": abs(got["gnorm"] - rec["gnorm"]) / rec["gnorm"],
                   "single_seconds": rec["seconds"], "limit": limit}
            gaps.append(gap)
            check(gap["loss_ratio"] <= limit and gap["gnorm_ratio"] <= limit,
                  f"step {i}: the grid's loss / norm part from one device's by "
                  f"{gap['loss_ratio']} / {gap['gnorm_ratio']} > {limit}")

        def ratio(got, want):
            return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))

        serve_gaps = {name: ratio(grid_out[name], same_params[name]) for name in SERVE_SHAPES}
        for name, gap in serve_gaps.items():
            check(gap <= SERVE_LIMIT, f"{name}: the grid's outputs part from one device's on "
                  f"the same parameters by {gap} of the largest > {SERVE_LIMIT}")
        own = {name: ratio(grid_out[name], one_out[name]) for name in SERVE_SHAPES}
        emit({"phase": "mesh_vs_single", "limit": LIMIT, "trajectory_limit": TRAJECTORY_LIMIT,
              "serve_limit": SERVE_LIMIT, "steps": gaps, "serve_ratio": serve_gaps,
              "serve_ratio_own_training": own,
              "serve_own_training_within_serve_limit": max(own.values()) <= SERVE_LIMIT,
              "single_serve_seconds": {r["shape"]: r["seconds"] for r in one_recs},
              "single_peak_gib": one[-1].get("peak_gib"),
              "single_seconds_total": time.perf_counter() - t1})
        # the state after each step, every rank's slices: after step 1 (one
        # state) the moments (the gradients) and the FIRM parameters within
        # LIMIT; after every step each parameter's gap what AdamW's rule
        # gives from the gap before it and each run's moments (within LIMIT)
        # and within AdamW's largest swing, 2 lr a step
        leaves = sorted(ranks[0]["state"][0])
        owners = _slice_owners(cfg, args)
        for i in range(args.steps):
            per = [rk["state"][i] for rk in ranks]
            keys = [key for key in per[0][leaves[0]] if "_ratio" in key]
            worst = {key: max(st[k][key] for st in per for k in leaves) for key in keys}
            worst_abs = max(st[k]["param_max_abs"] for st in per for k in leaves)
            counts = {key: sum(per[r][k][key] for k in leaves for r in owners[k])
                      for key in ("n", "firm", "over_limit", "over_limit_firm")}
            check(counts["n"] == cfg.param_count(), f"state after step {i + 1}: the ranks' "
                  f"slices cover {counts['n']} of {cfg.param_count()} elements")
            # counts over each distinct slice once; ratios the worst rank's
            emit({"phase": "mesh_state_after_step", "step": i, "limit": LIMIT,
                  "firm_moment": FIRM, "swing_limit": 2 * LR * (i + 1), **worst,
                  "param_max_abs": worst_abs, **counts,
                  "by_leaf": {k: {key: max(st[k][key] for st in per) for key in per[0][k]}
                              for k in leaves}})
            for key in (("mu_ratio", "nu_ratio", "param_ratio_firm") if i == 0 else ()) + (
                    "unexplained_ratio",):
                check(worst[key] <= LIMIT, f"state after step {i + 1}: {key} {worst[key]} > "
                      f"{LIMIT}")
            check(all(st[k]["param_max_abs"]
                      <= 2 * LR * (i + 1) + LIMIT * st[k]["param_max_abs_ref"]
                      for st in per for k in leaves),
                  f"state after step {i + 1}: a parameter moved {worst_abs} from one "
                  f"device's, over {2 * LR * (i + 1)}")
    else:
        kern, plain = ranks[0]["steps"][0], ranks[0]["plain"]
        rec = {"phase": "mesh_kernels_vs_plain", "limit": LIMIT, "loss_kernels": kern["loss"],
               "loss_plain": plain["loss"],
               "loss_ratio": abs(kern["loss"] - plain["loss"]) / abs(plain["loss"]),
               "gnorm_kernels": kern["gnorm"], "gnorm_plain": plain["gnorm"],
               "gnorm_ratio": abs(kern["gnorm"] - plain["gnorm"]) / plain["gnorm"]}
        emit(rec)
        check(rec["loss_ratio"] <= LIMIT and rec["gnorm_ratio"] <= LIMIT,
              f"kernels against plain: loss {rec['loss_ratio']}, gnorm {rec['gnorm_ratio']} "
              f"> {LIMIT}")
    if failures:
        print("torch_train_dlrm_mesh: FAILED: " + "; ".join(failures), file=sys.stderr)
        sys.exit(1)
    emit({"phase": "done", "arch": cfg.name, "grid": [args.data, args.model],
          "backend": "nccl" if cuda else "gloo"})


if __name__ == "__main__":
    main()
