"""Where the port's bfloat16 gatedgcn gradients part from JAX's, seed by seed.

    PYTHONPATH=src python tests/gatedgcn_bf16_sweep.py [--seeds 0-12]

On the CPU, for each seed of ``test_torch_train._case`` (the smoke gatedgcn
in bfloat16, 64 nodes, 240 edges padded to 72 and 256), prints one line:

- ``flips``: ReLU inputs whose sign differs between the two packages, and
  the largest |input| among them over its tensor's largest |input| (a
  bfloat16 spacing is 3.9e-3 to 7.8e-3 of it), in either package;
- ``decided``: with JAX's ReLUs taking the port's decisions, the largest
  gap over its own largest value among the leaves but the edge gates',
  and which leaf;
- ``gates port / jax``: the edge gates' (``l*_A``, ``l*_B``, ``l*_C``)
  largest gap of each package's bfloat16 gradient to the float32 one of the
  same parameters and decisions, over that leaf's largest value;
- ``cancel``: how far the last layer's ``A`` gradient cancels, the largest
  element of its sum of absolute terms over its largest element (a float64
  rerun of the last layer, whose edge-state ReLU the output never reads).

The test ``test_gatedgcn_bf16_loss_and_grads_match_jax`` holds seed 1.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import test_torch_train as T  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import gnn  # noqa: E402


def last_layer_cancellation(params, g, labels, cfg) -> float:
    """The gatedgcn forward in float64 with the edge-gate gradient of the
    last layer split into its two terms: the message's
    ``g_agg[dst] * (h_src @ V)`` and the denominator's ``g_den[dst]``."""
    p = {k: v.double().requires_grad_() for k, v in params.items()}
    n = g.n
    src, dst = g.src.long().clamp(0, n - 1), g.dst.long().clamp(0, n - 1)
    seg = torch.where(g.edge_mask, g.dst.long(), n)
    d = p["embed_w"].shape[1]
    h = g.x.double() @ p["embed_w"] + p["embed_b"]
    e = torch.zeros((src.shape[0], d), dtype=torch.float64)
    for i in range(cfg.n_layers):
        hs, hd = h[src], h[dst]
        e_new = hd @ p[f"l{i}_A"] + hs @ p[f"l{i}_B"] + e @ p[f"l{i}_C"]
        eta, m = torch.sigmoid(e_new), hs @ p[f"l{i}_V"]
        agg = torch.zeros((n + 1, d), dtype=torch.float64).index_add(0, seg, eta * m)[:n]
        den = torch.zeros((n + 1, d), dtype=torch.float64).index_add(0, seg, eta)[:n]
        agg.retain_grad()
        den.retain_grad()
        h = h + torch.relu(h @ p[f"l{i}_U"] + agg / (den + 1e-6))
        e = e + torch.relu(e_new)
    steps.gnn_loss(h @ p["out_w"] + p["out_b"], labels, g.node_mask, cfg).backward()
    zero = torch.zeros((1, d), dtype=torch.float64)
    slope = (eta * (1 - eta)).detach()
    t1 = torch.cat([agg.grad, zero])[seg] * m.detach() * slope
    t2 = torch.cat([den.grad, zero])[seg] * slope
    hd = hd.detach()
    return float((hd.abs().T @ (t1.abs() + t2.abs())).max() / (hd.T @ (t1 + t2)).abs().max())


def sweep(seed: int, mp: pytest.MonkeyPatch) -> str:
    jcfg = dataclasses.replace(j_get_arch("gatedgcn").smoke, dtype="bfloat16")
    jparams, jg, jlabels, params, g, labels = T._case(jcfg, seed=seed)
    cfg = T._port_cfg(jcfg)
    tg = gnn.train_graph(g, cfg)
    _, grads = steps.gnn_value_and_grad(params, tg, labels, cfg, use_kernels=False)
    with T._ReluInputs() as rec:
        gnn.train_forward(params, tg, dataclasses.replace(cfg, remat=False), use_kernels=False)
    jx = T._j_relu_inputs(jparams, jg, jcfg, mp)
    order = torch.sort(torch.where(g.edge_mask, g.dst, g.n), stable=True)[1].numpy()
    masks, flips, near = [], 0, 0.0
    for px, wx in zip(rec.x, jx):
        if px.shape[0] != g.n:
            px = px[np.argsort(order)]
        differ = (px > 0) != (wx > 0)
        flips += int(differ.sum())
        top = np.abs(wx).max()
        near = max(near, np.abs(px[differ]).max(initial=0) / top,
                   np.abs(wx[differ]).max(initial=0) / top)
        masks.append(px > 0)
    _, wg = T._j_value_and_grad_decided(jcfg, masks, mp, jparams, jg, jlabels)
    _, fg = T._j_value_and_grad_decided(
        dataclasses.replace(jcfg, dtype="float32"), masks, mp,
        {k: v.astype(jnp.float32) for k, v in jparams.items()}, jg, jlabels)
    decided, gate_p, gate_j = (0.0, ""), 0.0, 0.0
    for k in sorted(wg):
        got = T._np(grads[k])
        if k.endswith(T._GATES):
            f = T._f32(fg[k])
            top = np.abs(f).max()
            if top:
                gate_p = max(gate_p, np.abs(got - f).max() / top)
                gate_j = max(gate_j, np.abs(T._f32(wg[k]) - f).max() / top)
        else:
            w = T._f32(wg[k])
            decided = max(decided, (np.abs(got - w).max() / np.abs(w).max(), k))
    cancel = last_layer_cancellation(params, g, labels, cfg)
    return (f"seed {seed:2d}  flips {flips:2d} within {near:.2e}  decided {decided[0]:.4f} "
            f"{decided[1]:8s} gates port / jax {gate_p:.4f} / {gate_j:.4f}  cancel {cancel:.1f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-12", help="a range lo-hi, both included")
    lo, hi = (int(v) for v in ap.parse_args().seeds.split("-"))
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for seed in range(lo, hi + 1):
            print(sweep(seed, mp), flush=True)


if __name__ == "__main__":
    main()
