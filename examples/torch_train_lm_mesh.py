"""LM training on a ("data", "model") grid of ranks: the sharded step of the
PyTorch port (the train branch of JAX's ``_lm_cell`` on a 2-axis mesh).

    PYTHONPATH=src python examples/torch_train_lm_mesh.py --world 4 --data 2 --model 2 \\
        --arch phi4-mini-3.8b --batch 2 --seq 4096 --steps 3 --check single
    PYTHONPATH=src python examples/torch_train_lm_mesh.py --world 4 --data 2 --model 2 \\
        --arch granite-moe-3b-a800m --batch 8 --seq 4096 --steps 3 --check plain
    PYTHONPATH=src python examples/torch_train_lm_mesh.py --device cpu --smoke --world 4 \\
        --data 2 --model 2 --arch granite-moe-3b-a800m --batch 4 --seq 12 --steps 2

The script spawns ``--world`` ranks itself (NCCL, one rank a card, on
``--device cuda``, the default, which raises without CUDA; gloo on
``--device cpu``) and lays a ``(--data, --model)`` grid over them
(:func:`repro_torch.launch.mesh.init_grid_mesh`). Each rank draws the whole
model from seed 0 (full width, or the smoke config with ``--smoke``),
keeps its shards under ``_lm_cell``'s fixed specs and ZeRO-1 moments, and
runs ``--steps`` of ``lm_train_step(..., mesh=grid)`` at ``_lm_cell``'s
3e-4 with remat on the global batch of ``token_batches(seed=0)``: its slice
of each microbatch (``lm_micro_batches`` over the data ranks), the layers
tensor parallel and the experts expert parallel over ``model``, the kernels
on the card.

Then one check:

- ``--check single`` (default): after the group is torn down, the same
  steps on one device in this process (``lm_train_step`` without a mesh,
  the same parameters, tokens and microbatching): each step's loss and
  gradient norm within ``LIMIT`` of the grid's;
- ``--check plain``: each rank replays step 1 from the same initial state
  on the same grid with the kernels' plain versions; loss and gradient norm
  within ``LIMIT`` of the kernel run's, the MoE routing flips counted.

A MoE model's exchange must drop no row. Prints one JSON line per step and
rank and per check (seconds a step, peak GiB, the kernels' launches, the
collectives' calls and bytes by kind and axis, the rows each MoE layer
masked past its expert's window); a failed check or rank exits nonzero.
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

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.run import _require_device  # noqa: E402

# Loss and gradient norm against the one-device step or the plain versions:
# bf16 rounds each layer's products and sums on each path in other places
# (the row-parallel sums over two ranks, the attention kernels), which over
# 32 layers add to a few roundings of 2**-8 (chip_smoke.LM_TRAIN_LIMIT).
LIMIT = 2e-2
TIMEOUT_S = 900.0
LR, SEED = 3e-4, 0   # _lm_cell's step; the parameters' draw


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _config(args):
    from repro_torch.configs import get_arch

    spec = get_arch(args.arch)
    return dataclasses.replace(spec.smoke if args.smoke else spec.config, remat=True)


def _batches(cfg, args, device):
    from repro_torch.data import token_batches

    stream = token_batches(cfg.vocab, args.batch, args.seq, seed=0)
    return [tuple(torch.from_numpy(a).to(device) for a in next(stream))
            for _ in range(args.steps)]


def _whole_params(cfg, device):
    from repro_torch.models import transformer as tf

    return tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)


@contextlib.contextmanager
def _routing(log: list):
    """Each MoE layer's per-expert row counts, as the routed sum reads them,
    appended to ``log`` while inside."""
    from repro_torch.models import transformer as tf

    rows = tf._expert_rows

    def spy(experts, n):
        out = rows(experts, n)
        log.append(out)
        return out

    tf._expert_rows = spy
    try:
        yield log
    finally:
        tf._expert_rows = rows


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank(rank: int, world: int, port: int, args, out: str) -> None:
    """One rank: the steps on the grid, then with ``--check plain`` step 1
    again with the plain versions."""
    import torch.distributed as dist
    from repro_torch.convert import lm_params_shard
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_grid_mesh
    from repro_torch.models import transformer as tf

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    mesh = init_grid_mesh(args.data, args.model, args.device, timeout_s=TIMEOUT_S)
    dev = mesh.device
    cuda = dev.type == "cuda"
    cfg = _config(args)
    dsize = mesh.size(mesh.data_axes)
    n_micro = steps.lm_micro_batches(cfg, args.batch, args.seq, devices=dsize)

    def fresh():
        whole = _whole_params(cfg, dev)
        params = lm_params_shard(whole, cfg, mesh, device=dev)
        del whole
        if cuda:
            torch.cuda.empty_cache()
        return params, steps.lm_adamw_init(params, cfg, mesh)

    params, opt = fresh()
    batches = _batches(cfg, args, dev)
    recs = []
    for i, (tok, lab) in enumerate(batches):
        stats, counts = tf.RoutedStats(), []
        ops.reset_launch_counts()
        mesh.reset_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t0 = time.perf_counter()
        with _routing(counts):
            params, opt, loss, gnorm = steps.lm_train_step(
                params, opt, tok, lab, cfg, lr=LR, use_kernels=cuda, n_micro=n_micro,
                mesh=mesh, stats=stats)
        _sync(dev)
        s = stats.summary()
        rec = {"step": i, "rank": rank, "coords": mesh.coords(rank), "loss": float(loss),
               "gnorm": float(gnorm), "seconds": time.perf_counter() - t0, "n_micro": n_micro,
               "launches": {k: v for k, v in ops.launch_counts().items() if v},
               "collective_calls": dict(mesh.calls), "collective_bytes": dict(mesh.bytes),
               "routing": counts}
        if cuda:
            rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        if cfg.moe:
            rec["moe"] = {"exchange_overflow": s["overflow"], "routed_calls": s["calls"],
                          "masked_rows_per_call": s["masked_per_call"]}
        recs.append(rec)
    plain = None
    if args.check == "plain":
        del params, opt
        if cuda:
            torch.cuda.empty_cache()
        params, opt = fresh()
        counts = []
        with _routing(counts):
            _, _, loss, gnorm = steps.lm_train_step(
                params, opt, *batches[0], cfg, lr=LR, use_kernels=False, n_micro=n_micro,
                mesh=mesh)
        plain = {"loss": float(loss), "gnorm": float(gnorm), "routing": counts}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"steps": recs, "plain": plain}, f)
    dist.destroy_process_group()


def _single(cfg, args, dev):
    """The same steps on one device: ``lm_train_step`` without a mesh."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init

    params = _whole_params(cfg, dev)
    opt = adamw_init(steps.flat_params(params))
    n_micro = steps.lm_micro_batches(cfg, args.batch, args.seq)
    out = []
    for tok, lab in _batches(cfg, args, dev):
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, loss, gnorm = steps.lm_train_step(params, opt, tok, lab, cfg, lr=LR,
                                                       use_kernels=dev.type == "cuda",
                                                       n_micro=n_micro)
        _sync(dev)
        out.append({"loss": float(loss), "gnorm": float(gnorm),
                    "seconds": time.perf_counter() - t0, "n_micro": n_micro})
    if dev.type == "cuda":
        out[-1]["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
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
    cfg = _config(args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines() if cuda else []
    emit({"phase": "plan", "arch": cfg.name, "nvidia_smi": smi, "grid": [args.data, args.model],
          "world": args.world, "backend": "nccl" if cuda else "gloo", "batch": args.batch,
          "seq": args.seq, "steps": args.steps, "layers": cfg.n_layers, "dtype": cfg.dtype,
          "params": cfg.param_count(), "remat": cfg.remat, "check": args.check,
          "device": torch.cuda.get_device_name(0) if cuda else "cpu"})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        torch.multiprocessing.start_processes(
            _rank, args=(args.world, _free_port(), args, out), nprocs=args.world, join=True,
            start_method="spawn")
        ranks = []
        for r in range(args.world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    spawn_s = time.perf_counter() - t0
    failures = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    for i in range(args.steps):
        recs = [rk["steps"][i] for rk in ranks]
        for rec in recs:
            emit({"phase": "mesh_step", **{k: v for k, v in rec.items() if k != "routing"}})
        losses = {rec["loss"] for rec in recs}
        check(len(losses) == 1, f"step {i}: the ranks' losses differ: {losses}")
        check(all(math.isfinite(rec["loss"]) and math.isfinite(rec["gnorm"]) for rec in recs),
              f"step {i}: a loss or norm is not finite")
        if cfg.moe:
            check(all(rec["moe"]["exchange_overflow"] == 0 for rec in recs),
                  f"step {i}: the exchange dropped rows")
        if cuda:
            check(all(rec["launches"].get("flash_attention", 0) > 0
                      and rec["launches"].get("flash_attention_bwd", 0) > 0 for rec in recs),
                  f"step {i}: a rank launched no attention kernel")
    summary = {"phase": "mesh_train", "arch": cfg.name, "grid": [args.data, args.model],
               "losses": [ranks[0]["steps"][i]["loss"] for i in range(args.steps)],
               "gnorms": [ranks[0]["steps"][i]["gnorm"] for i in range(args.steps)],
               "median_step_seconds": statistics.median(
                   max(rk["steps"][i]["seconds"] for rk in ranks) for i in range(args.steps)),
               "spawned_seconds": spawn_s}
    if cuda:
        summary["peak_gib_by_rank"] = [max(s["peak_gib"] for s in rk["steps"]) for rk in ranks]
    if cfg.moe:
        masked = [m for rk in ranks for s in rk["steps"] for m in s["moe"]["masked_rows_per_call"]]
        summary["moe"] = {"exchange_overflow": sum(s["moe"]["exchange_overflow"]
                                                   for rk in ranks for s in rk["steps"]),
                          "masked_rows_per_call": {"mean": statistics.mean(masked),
                                                   "max": max(masked)}}
    emit(summary)

    if args.check == "single":
        t1 = time.perf_counter()
        one = _single(cfg, args, dev)
        gaps = []
        for i, rec in enumerate(one):
            got = ranks[0]["steps"][i]
            gap = {"step": i, "loss_single": rec["loss"], "loss_mesh": got["loss"],
                   "loss_ratio": abs(got["loss"] - rec["loss"]) / abs(rec["loss"]),
                   "gnorm_single": rec["gnorm"], "gnorm_mesh": got["gnorm"],
                   "gnorm_ratio": abs(got["gnorm"] - rec["gnorm"]) / rec["gnorm"],
                   "single_seconds": rec["seconds"], "n_micro_single": rec["n_micro"]}
            gaps.append(gap)
            check(gap["loss_ratio"] <= LIMIT and gap["gnorm_ratio"] <= LIMIT,
                  f"step {i}: the grid's loss / norm part from one device's by "
                  f"{gap['loss_ratio']} / {gap['gnorm_ratio']} > {LIMIT}")
        emit({"phase": "mesh_vs_single", "limit": LIMIT, "steps": gaps,
              "single_peak_gib": one[-1].get("peak_gib"),
              "single_seconds_total": time.perf_counter() - t1})
    else:
        kern, plain = ranks[0]["steps"][0], ranks[0]["plain"]
        rec = {"phase": "mesh_kernels_vs_plain", "limit": LIMIT, "loss_kernels": kern["loss"],
               "loss_plain": plain["loss"],
               "loss_ratio": abs(kern["loss"] - plain["loss"]) / abs(plain["loss"]),
               "gnorm_kernels": kern["gnorm"], "gnorm_plain": plain["gnorm"],
               "gnorm_ratio": abs(kern["gnorm"] - plain["gnorm"]) / plain["gnorm"]}
        if cfg.moe:
            pairs = [(a, b) for rk in ranks
                     for a, b in zip(rk["steps"][0]["routing"], rk["plain"]["routing"])]
            rec["routing_counts_equal"] = all(a == b for a, b in pairs)
            rec["routing_layers_differing"] = sum(a != b for a, b in pairs)
        emit(rec)
        check(rec["loss_ratio"] <= LIMIT and rec["gnorm_ratio"] <= LIMIT,
              f"kernels against plain: loss {rec['loss_ratio']}, gnorm {rec['gnorm_ratio']} "
              f"> {LIMIT}")
    if failures:
        print("torch_train_lm_mesh: FAILED: " + "; ".join(failures), file=sys.stderr)
        sys.exit(1)
    emit({"phase": "done", "arch": cfg.name, "grid": [args.data, args.model],
          "backend": "nccl" if cuda else "gloo"})


if __name__ == "__main__":
    main()
