"""GNN training on a ("data", "model") grid of ranks: the sharded step of the
PyTorch port (``_gnn_cell``'s step on a 2-axis mesh).

    PYTHONPATH=src python examples/torch_train_gnn_mesh.py --world 4
    PYTHONPATH=src python examples/torch_train_gnn_mesh.py --device cpu --smoke --world 4

The script spawns ``--world`` ranks itself (NCCL, one rank a card, on
``--device cuda``, the default, which raises without CUDA; gloo on
``--device cpu``) and lays a ``(--world / 2, 2)`` grid over them
(:func:`repro_torch.launch.mesh.init_grid_mesh`; ``(2, 2)`` at world 4). Then
it runs the three cells in turn, each as ``_gnn_cell`` lays it out: the graph
(``build_graph_data`` seed 0, node and edge counts padded to the world by
``gnn_counts``; labels the degree bucket) split over every axis, each rank
building the whole host graph and keeping its own shard; the weights drawn
whole from seed 4 and replicated; ZeRO-1 moments; ``STEPS`` of
``gnn_train_step`` on a train graph built with ``mesh=grid``, AdamW at
1e-3, remat, the kernels on the card. Each cell checks itself:

- ``eqv2_molecule`` — equiformer-v2 at ``_FULL`` on ``molecule`` (128
  graphs: 3,840 nodes, 16,384 edges), through the channel-split gather and
  segment sum; after the group is torn down the same steps on one device
  in this process (``gnn_train_step`` on the whole graph, the same weights):
  each step's loss and gradient norm within ``SINGLE_LIMIT`` of the grid's,
  and the grid's parameter updates over the steps within ``UPDATE_LIMIT``
  of one device's (:func:`update_gap`);
- ``sage_products`` — graphsage-reddit at its full config on
  ``ogb_products`` (2,449,029 nodes, 123,718,280 directed edges, d_in 100),
  nothing cut; each rank replays step 1 from the same state on the same
  grid with the plain versions: loss and norm within 1e-4 of the kernels';
- ``gatedgcn_products`` — gatedgcn at full width on ``ogb_products``, its
  16 layers cut to the largest count whose peak a card stays under
  ``PEAK_GIB`` less ``MARGIN_GIB`` (one step each at 4 and 8 layers
  measure a layer's memory); step 1 replayed with the plain versions: loss
  and norm within 3e-2.

``--smoke`` runs the smoke configs at ``_gnn_cell``'s smoke sizes (for the
CPU). Prints one JSON line per step and rank and per check (seconds a
step, peak GiB, ``segment_sum`` launches, the collectives' calls and bytes
by kind and axis); a failed check or rank exits nonzero.
"""

from __future__ import annotations

import argparse
import contextlib
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
from torch.multiprocessing.spawn import ProcessException

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.run import _require_device  # noqa: E402

# cell: (arch, shape, check), run in this order
CELLS = {"eqv2_molecule": ("equiformer-v2", "molecule", "single"),
         "sage_products": ("graphsage-reddit", "ogb_products", "plain"),
         "gatedgcn_products": ("gatedgcn", "ogb_products", "plain")}
MODEL_RANKS, STEPS = 2, 3   # the grid's "model" axis; steps a cell
# Kernels against plain: chip_smoke's GNN gates (graphsage float32 1e-4,
# gatedgcn bf16 3e-2).
LIMITS = {"graphsage-reddit": 1e-4, "gatedgcn": 3e-2}
# The grid against one card, equiformer-v2 in bf16: the grid rounds its
# cross-rank sums to float32 before bf16 and one card does not. Four H100s
# read loss / norm ratios up to 6.3e-5 / 4.1e-4 over the three steps; the
# losses move by 3-4x a step, so an update that is missing or reversed
# parts by far more than SINGLE_LIMIT. AdamW's normalised step flips where
# a gradient element is near 0, so the updates are held as a whole:
# update_gap is 1 for a missing update and 2 for a reversed one, and read
# 0.125 on four H100s.
SINGLE_LIMIT, UPDATE_LIMIT = 2e-3, 0.25
PEAK_GIB = 79.2           # a card's budget
# the gatedgcn layer cut keeps this much of it free: the plain replay's
# float64 chunks and the allocator's slack
MARGIN_GIB = 2.0
# the probe steps of the gatedgcn layer cut: from 4 layers on the peak is
# the last layer's backward over every layer's saved edge state, and grows
# by one layer's state a layer (at 2 it falls elsewhere: a steeper slope)
PROBE_LAYERS = (4, 8)
TIMEOUT_S = 900.0
LR, SEED = 1e-3, 4        # _gnn_cell's step; the weights' draw


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def update_gap(p0, p_mesh, p_one) -> float:
    """|Δ_mesh - Δ_one| / |Δ_one| over every parameter (float64), Δ a
    run's parameters after its steps less ``p0``, the weights both started
    from."""
    num = den = 0.0
    for k, v0 in p0.items():
        d_one = p_one[k].double().cpu() - v0.double().cpu()
        num += float((p_mesh[k].double().cpu() - v0.double().cpu() - d_one).square().sum())
        den += float(d_one.square().sum())
    return math.sqrt(num / den)


def _counts(shape, world: int, smoke: bool):
    """The padded ``(nodes, edges)`` of a cell and the real ones:
    ``gnn_counts`` on ``world`` devices, or ``_gnn_counts``' smoke sizes."""
    from repro_torch.launch.steps import gnn_counts

    real = gnn_counts(shape)
    if smoke:
        real = ((4 * shape.n_nodes, 4 * shape.n_edges * 2) if shape.kind == "batched_graphs"
                else (min(shape.n_nodes, 256), min(shape.n_edges, 512)))
    return tuple(-(-x // world) * world for x in real), real


def _config(arch: str, shape, args):
    from repro_torch.configs import get_arch

    spec = get_arch(arch)
    cfg = spec.smoke if args.smoke else dataclasses.replace(spec.config, d_in=shape.d_feat)
    return dataclasses.replace(cfg, remat=True)


def _graph(cfg, shape, world: int, smoke: bool):
    """The whole host graph, padded."""
    from repro_torch.data import build_graph_data

    (nodes, edges), (n_real, e_real) = _counts(shape, world, smoke)
    return build_graph_data(n_real, e_real, cfg.d_in, d_edge=cfg.d_edge_in, seed=0,
                            pad_nodes=nodes, pad_edges=edges,
                            geometric=cfg.arch == "equiformer_v2")


def _labels(raw, cfg) -> np.ndarray:
    """Each node's degree bucket: a class below ``d_out``, or the degree
    itself for a regression head."""
    deg = np.bincount(raw["dst"][raw["edge_mask"]], minlength=raw["x"].shape[0])
    return (np.minimum(deg, cfg.d_out - 1) if cfg.d_out > 1 else deg).astype(np.int32)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gib(dev) -> float | None:
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


class _Cell:
    """One cell on this rank: its shard, train graph and labels."""

    def __init__(self, mesh, cfg, raw, dev):
        from repro_torch.convert import graph_shard, node_rows
        from repro_torch.models import gnn

        self.mesh, self.cfg, self.dev = mesh, cfg, dev
        t0 = time.perf_counter()
        self.tg = gnn.train_graph(graph_shard(raw, mesh, device=dev), cfg, mesh=mesh)
        self.labels = torch.from_numpy(node_rows(_labels(raw, cfg), mesh).copy()).to(dev)
        _sync(dev)
        self.plan_s = time.perf_counter() - t0

    def fresh(self, cfg=None):
        from repro_torch.launch import steps
        from repro_torch.models import gnn

        cfg = cfg or self.cfg
        params = gnn.init_params(cfg, torch.Generator(device=self.dev).manual_seed(SEED),
                                 self.dev)
        return params, steps.gnn_adamw_init(params, cfg, self.mesh)

    def step(self, params, opt, use_kernels: bool, cfg=None):
        """One step, timed: (params, opt, record)."""
        from repro_torch.kernels import ops
        from repro_torch.launch import steps

        mesh, dev = self.mesh, self.dev
        ops.reset_launch_counts()
        mesh.reset_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, loss, gnorm = steps.gnn_train_step(params, opt, self.tg, self.labels,
                                                        cfg or self.cfg, lr=LR,
                                                        use_kernels=use_kernels)
        _sync(dev)
        rec = {"seconds": time.perf_counter() - t0, "loss": float(loss), "gnorm": float(gnorm),
               "peak_gib": _peak_gib(dev),
               "launches": {k: v for k, v in ops.launch_counts().items() if v},
               "collective_calls": dict(mesh.calls), "collective_bytes": dict(mesh.bytes)}
        return params, opt, rec


def _gatedgcn_layers(cell) -> dict:
    """The gatedgcn layer count: the largest whose peak a card stays under
    PEAK_GIB - MARGIN_GIB, from one kernel step at each of PROBE_LAYERS
    layers (the peak grows by one layer's saved state a layer; the ranks'
    largest peaks)."""
    mesh, peaks = cell.mesh, []
    for n in PROBE_LAYERS:
        cfg = dataclasses.replace(cell.cfg, n_layers=n)
        params, opt = cell.fresh(cfg)
        _, _, rec = cell.step(params, opt, cell.dev.type == "cuda", cfg)
        del params, opt
        peaks.append(rec["peak_gib"] or 0.0)
    top = mesh.all_reduce(torch.tensor(peaks, dtype=torch.float64, device=cell.dev),
                          mesh.axis_names, op="max").tolist()
    per = (top[1] - top[0]) / (PROBE_LAYERS[1] - PROBE_LAYERS[0])
    base = top[0] - per * PROBE_LAYERS[0]
    fit = int((PEAK_GIB - MARGIN_GIB - base) // per) if per > 0 else cell.cfg.n_layers
    layers = max(1, min(cell.cfg.n_layers, fit))
    if cell.dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"layers": layers, "probe_layers": list(PROBE_LAYERS), "probe_peak_gib": top,
            "gib_per_layer": per, "gib_base": base, "predicted_peak_gib": base + per * layers}


def _rank(rank: int, world: int, port: int, args, out: str) -> None:
    """One rank: each cell's steps on the grid, then its plain replay."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import init_grid_mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    mesh = init_grid_mesh(model=MODEL_RANKS, device=args.device, timeout_s=TIMEOUT_S)
    dev = mesh.device
    cuda = dev.type == "cuda"
    res, hosts = {}, {}
    for name, (arch, shape_name, check) in CELLS.items():
        shape = get_arch(arch).shape(shape_name)
        cfg = _config(arch, shape, args)
        t0 = time.perf_counter()
        key = (shape_name, cfg.d_in, cfg.d_edge_in, cfg.arch == "equiformer_v2")
        if key not in hosts:   # cells on one graph share it; the last one is kept
            hosts = {key: _graph(cfg, shape, world, args.smoke)}
        raw = hosts[key]
        data_s = time.perf_counter() - t0
        cell = _Cell(mesh, cfg, raw, dev)
        rec = {"nodes": int(raw["x"].shape[0]), "edges": int(raw["src"].shape[0]),
               "edges_a_rank": int(cell.tg.ed.src.shape[0]), "data_seconds": data_s,
               "plan_seconds": cell.plan_s, "edge_chunks": len(cell.tg.ed.plans)}
        if arch == "gatedgcn":
            rec["layer_cut"] = _gatedgcn_layers(cell)
            cfg = cell.cfg = dataclasses.replace(cfg, n_layers=rec["layer_cut"]["layers"])
        rec["layers"] = cfg.n_layers
        params, opt = cell.fresh()
        rec["steps"] = []
        for _ in range(STEPS):
            params, opt, step = cell.step(params, opt, cuda)
            rec["steps"].append(step)
        if check == "single" and rank == 0:
            torch.save({k: v.cpu() for k, v in params.items()}, os.path.join(out, f"{name}.pt"))
        del params, opt
        if check == "plain":
            if cuda:
                torch.cuda.empty_cache()
            params, opt = cell.fresh()
            _, _, rec["plain"] = cell.step(params, opt, False)
            del params, opt
        res[name] = rec
        del cell
        if cuda:
            torch.cuda.empty_cache()
        # after every cell, so that a later cell's failure keeps this one's
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def _single(name: str, args, dev):
    """The cell's steps on one device on the whole graph, from the same
    weights: (records, the weights before the first step, after the last)."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import graph_from_numpy
    from repro_torch.launch.steps import gnn_train_step
    from repro_torch.models import gnn
    from repro_torch.optim import adamw_init

    arch, shape_name, _ = CELLS[name]
    shape = get_arch(arch).shape(shape_name)
    cfg = _config(arch, shape, args)
    raw = _graph(cfg, shape, args.world, args.smoke)
    tg = gnn.train_graph(graph_from_numpy(raw, dev), cfg)
    labels = torch.from_numpy(_labels(raw, cfg)).to(dev)
    params = gnn.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    p0 = {k: v.clone() for k, v in params.items()}
    opt = adamw_init(params)
    recs = []
    for _ in range(STEPS):
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, loss, gnorm = gnn_train_step(params, opt, tg, labels, cfg, lr=LR,
                                                  use_kernels=dev.type == "cuda")
        _sync(dev)
        recs.append({"loss": float(loss), "gnorm": float(gnorm),
                     "seconds": time.perf_counter() - t0, "peak_gib": _peak_gib(dev)})
    return recs, p0, params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    grid = [args.world // MODEL_RANKS, MODEL_RANKS]
    dev = _require_device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        if torch.cuda.device_count() < args.world:
            raise RuntimeError(f"{args.world} ranks need {args.world} cards, "
                               f"{torch.cuda.device_count()} visible")
        from repro_torch.kernels import build

        build.library()     # once, before the ranks load it
        dev = torch.device("cuda", 0)
        # a card's budget is near its size: fewer, growable segments
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines() if cuda else []
    emit({"phase": "plan", "cells": list(CELLS), "nvidia_smi": smi,
          "grid": grid, "world": args.world,
          "backend": "nccl" if cuda else "gloo", "steps": STEPS, "smoke": args.smoke,
          "device": torch.cuda.get_device_name(0) if cuda else "cpu"})
    t0 = time.perf_counter()
    failures = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    with tempfile.TemporaryDirectory() as out:
        try:
            torch.multiprocessing.start_processes(
                _rank, args=(args.world, _free_port(), args, out), nprocs=args.world,
                join=True, start_method="spawn")
        except ProcessException as exc:   # report the cells every rank finished
            failures.append(f"a rank failed: {exc}")
        ranks = []
        for r in range(args.world):
            path = os.path.join(out, f"rank{r}.json")
            with open(path) if os.path.exists(path) else contextlib.nullcontext() as f:
                ranks.append(json.load(f) if f else {})
        spawn_s = time.perf_counter() - t0
        for name, (arch, shape_name, kind) in CELLS.items():
            if not all(name in rk for rk in ranks):
                failures.append(f"{name}: not every rank finished it")
                continue
            recs = [rk[name] for rk in ranks]
            first = recs[0]
            for r, rec in enumerate(recs):
                for i, s in enumerate(rec["steps"]):
                    emit({"phase": "mesh_step", "cell": name, "step": i, "rank": r, **s})
            for i in range(STEPS):
                losses = {rec["steps"][i]["loss"] for rec in recs}
                check(len(losses) == 1, f"{name} step {i}: the ranks' losses differ: {losses}")
                check(all(math.isfinite(rec["steps"][i]["loss"])
                          and math.isfinite(rec["steps"][i]["gnorm"]) for rec in recs),
                      f"{name} step {i}: a loss or norm is not finite")
                if cuda:
                    check(all(rec["steps"][i]["launches"].get("segment_sum", 0) > 0
                              for rec in recs), f"{name} step {i}: a rank launched no segment_sum")
            summary = {"phase": "mesh_train", "cell": name, "arch": arch, "shape": shape_name,
                       "grid": grid, "layers": first["layers"],
                       **{k: first[k] for k in ("nodes", "edges", "edges_a_rank", "edge_chunks")},
                       "losses": [s["loss"] for s in first["steps"]],
                       "gnorms": [s["gnorm"] for s in first["steps"]],
                       "median_step_seconds": statistics.median(
                           max(rec["steps"][i]["seconds"] for rec in recs)
                           for i in range(STEPS)),
                       "data_seconds": max(rec["data_seconds"] for rec in recs),
                       "plan_seconds": max(rec["plan_seconds"] for rec in recs)}
            if "layer_cut" in first:
                summary["layer_cut"] = first["layer_cut"]
            if cuda:
                summary["peak_gib_by_rank"] = [max(s["peak_gib"] for s in rec["steps"])
                                               for rec in recs]
                check(max(summary["peak_gib_by_rank"]) < PEAK_GIB,
                      f"{name}: peak {summary['peak_gib_by_rank']} GiB over {PEAK_GIB}")
            emit(summary)
            if kind == "plain":
                limit = LIMITS[arch]
                kern, plain = first["steps"][0], first["plain"]
                rec = {"phase": "mesh_kernels_vs_plain", "cell": name, "limit": limit,
                       "loss_kernels": kern["loss"], "loss_plain": plain["loss"],
                       "loss_ratio": abs(kern["loss"] - plain["loss"]) / abs(plain["loss"]),
                       "gnorm_kernels": kern["gnorm"], "gnorm_plain": plain["gnorm"],
                       "gnorm_ratio": abs(kern["gnorm"] - plain["gnorm"]) / plain["gnorm"],
                       "plain_seconds": plain["seconds"], "plain_peak_gib": plain["peak_gib"],
                       "plain_launches": plain["launches"]}
                emit(rec)
                check(not plain["launches"], f"{name}: the plain step launched kernels")
                check(rec["loss_ratio"] <= limit and rec["gnorm_ratio"] <= limit,
                      f"{name}: kernels against plain: loss {rec['loss_ratio']}, gnorm "
                      f"{rec['gnorm_ratio']} > {limit}")
            else:
                t1 = time.perf_counter()
                one, p0, p_one = _single(name, args, dev)
                p_mesh = torch.load(os.path.join(out, f"{name}.pt"))
                gaps = []
                for i, rec in enumerate(one):
                    got = first["steps"][i]
                    gap = {"step": i, "loss_single": rec["loss"], "loss_mesh": got["loss"],
                           "loss_ratio": abs(got["loss"] - rec["loss"]) / abs(rec["loss"]),
                           "gnorm_single": rec["gnorm"], "gnorm_mesh": got["gnorm"],
                           "gnorm_ratio": abs(got["gnorm"] - rec["gnorm"]) / rec["gnorm"],
                           "single_seconds": rec["seconds"]}
                    gaps.append(gap)
                    check(gap["loss_ratio"] <= SINGLE_LIMIT and gap["gnorm_ratio"] <= SINGLE_LIMIT,
                          f"{name} step {i}: the grid's loss / norm part from one device's by "
                          f"{gap['loss_ratio']} / {gap['gnorm_ratio']} > {SINGLE_LIMIT}")
                gap = update_gap(p0, p_mesh, p_one)
                equal = sum(torch.equal(p_mesh[k], v.cpu()) for k, v in p_one.items())
                check(gap <= UPDATE_LIMIT, f"{name}: the grid's updates part from one device's "
                                           f"by {gap} > {UPDATE_LIMIT}")
                emit({"phase": "mesh_vs_single", "cell": name, "limit": SINGLE_LIMIT,
                      "steps": gaps, "update_gap": gap, "update_limit": UPDATE_LIMIT,
                      "params_bitwise_equal": equal, "params": len(p_one),
                      "single_peak_gib": max(r["peak_gib"] or 0 for r in one) if cuda else None,
                      "single_seconds_total": time.perf_counter() - t1})
    if failures:
        print("torch_train_gnn_mesh: FAILED: " + "; ".join(failures), file=sys.stderr)
        sys.exit(1)
    emit({"phase": "done", "cells": list(CELLS), "grid": grid,
          "backend": "nccl" if cuda else "gloo", "spawned_seconds": spawn_s})


if __name__ == "__main__":
    main()
