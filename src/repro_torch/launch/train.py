"""Fault-tolerant LM training driver (twin of ``repro/launch/train.py``).

Trains an LM of the registry (GQA or MLA, dense or MoE) at smoke or full
width on one device with:
- checkpoint/restart (atomic saves; auto-resume from the newest intact
  step — kill -9 mid-run and relaunch to test); the files interchange with
  the JAX driver's;
- straggler monitoring (per-step timing window, one host);
- host-side double-buffered data prefetch of the synthetic token stream.

Each step is :func:`repro_torch.launch.steps.lm_train_step` (one batch, no
microbatches, as the JAX driver's step) at the warm-up cosine rate
(peak 3e-4, 10 warm-up steps). On the card the attention runs the CUDA
kernels forward and backward (MLA's at its own V width, (96, 64) for
minicpm3-4b) and the embedding's backward the ``segment_sum`` kernel; MoE
layers take the routed sum JAX trains with; ``--device cpu`` runs the
kernels' plain versions. Without a card the default device raises (so does
a float32 MLA gradient on the card: no kernel takes it).

Usage (CPU smoke; ``--arch minicpm3-4b`` or ``granite-moe-3b-a800m`` for MLA
or MoE):
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --steps 20 --smoke --device cpu --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs.registry import get_arch
from ..data.pipeline import prefetch
from ..data.tokens import token_batches
from ..dist.straggler import StragglerMonitor
from ..models import transformer as tf
from ..optim import adamw_init, warmup_cosine
from .steps import flat_params, lm_train_step

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Run the driver; returns the losses of the steps it ran."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or 'cpu' (the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family != "lm":
        ap.error(f"{args.arch} is a {spec.family} arch: train.py drives LM archs; see "
                 "examples/ for GNN/recsys")
    cfg: tf.TransformerConfig = spec.smoke if args.smoke else spec.config
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    monitor = StragglerMonitor(n_hosts=1)

    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw_init(flat_params(params))
    start_step = 0
    latest, restored = mgr.restore_latest({"params": params, "opt": opt}, device=dev)
    if restored is not None:
        params, opt = restored["params"], restored["opt"]
        start_step = latest
        print(f"resumed from checkpoint step {latest}")

    losses = []
    data = prefetch(token_batches(cfg.vocab, args.batch, args.seq, seed=start_step))
    for i, (toks, labels) in enumerate(data):
        step = start_step + i
        if step >= args.steps:
            break
        t0 = time.perf_counter()
        lr = warmup_cosine(step, peak=3e-4, warmup=10, total=args.steps)
        params, opt, loss, gnorm = lm_train_step(
            params, opt, torch.from_numpy(toks).to(dev), torch.from_numpy(labels).to(dev), cfg,
            lr=lr, use_kernels=dev.type == "cuda", n_micro=1)
        loss = float(loss)
        dt = time.perf_counter() - t0
        monitor.record(np.array([dt]))
        if monitor.stragglers():
            print(f"step {step}: straggler hosts {monitor.stragglers()} (would rebalance)")
        print(f"step {step}: loss={loss:.4f} gnorm={float(gnorm):.3f} {dt * 1e3:.0f}ms")
        if math.isnan(loss):
            raise FloatingPointError(f"step {step}: NaN loss")
        losses.append(loss)
        if (step + 1) % args.ckpt_every == 0:
            path = mgr.save(step + 1, {"params": params, "opt": opt})
            print(f"checkpointed → {path}")
    print("done")
    return losses


if __name__ == "__main__":
    main()
