"""DLRM serving steps, their FLOP count and their requests; the GNN
training step, its loss, node and edge counts and FLOP count.

Twins of the ``recsys_serve`` and ``retrieval`` branches of
``repro/launch/steps.py`` (``_dlrm_cell``) and of its ``_dlrm_flops`` for
serving; of the ``step`` of ``_gnn_cell`` (its masked loss, its gradient,
one AdamW update), of ``_gnn_counts`` on one device and of
``_gnn_flops``. DLRM training and the LM cells are not ported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..configs.registry import ShapeSpec
from ..models import dlrm, gnn
from ..optim import AdamWState, adamw_update

__all__ = ["dlrm_serve_step", "dlrm_retrieval_step", "dlrm_flops", "gnn_flops", "gnn_counts",
           "gnn_loss", "gnn_value_and_grad", "gnn_train_step", "recsys_requests",
           "retrieval_candidates"]


def dlrm_serve_step(params, dense, sparse, cfg: dlrm.DLRMConfig, *, use_kernels: bool):
    """Logits ``[B]`` of one batch of requests (the ``recsys_serve`` cell)."""
    return dlrm.forward(params, dense, sparse, cfg, use_kernels=use_kernels)


def dlrm_retrieval_step(params, dense, sparse, candidates, cfg: dlrm.DLRMConfig, *,
                        use_kernels: bool):
    """Scores ``[N]`` of one query against ``candidates [N]`` (the
    ``retrieval`` cell)."""
    return dlrm.retrieval_scores(params, dense, sparse, candidates, cfg,
                                 use_kernels=use_kernels)


def dlrm_flops(cfg: dlrm.DLRMConfig, batch: int) -> Dict[str, float]:
    """Model FLOP of serving ``batch`` examples (the two MLPs and the dot
    interaction, 2 FLOP a multiply-add; copy of ``_dlrm_flops`` with
    ``train=False``), and the table parameters."""
    dims_b = (cfg.n_dense,) + cfg.bot_mlp
    dims_t = (cfg.n_interact + cfg.bot_mlp[-1],) + cfg.top_mlp
    mlp = sum(2 * a * b for a, b in zip(dims_b, dims_b[1:]))
    mlp += sum(2 * a * b for a, b in zip(dims_t, dims_t[1:]))
    inter = 2 * (cfg.n_sparse + 1) ** 2 * cfg.embed_dim
    params = cfg.n_sparse * cfg.rows_per_table * cfg.embed_dim
    return {"model_flops": float(batch * (mlp + inter)), "params": float(params),
            "active_params": float(params)}


def gnn_flops(cfg: gnn.GNNConfig, nodes: int, edges: int, train: bool = False) -> Dict[str, float]:
    """Model FLOP of one full-graph forward, or with ``train`` of one
    training step, three forwards' worth (copy of ``_gnn_flops``): the
    JAX package's per-edge and per-node product counts, 2 FLOP a
    multiply-add. For EquiformerV2 it counts the full rotation and three
    SO(2) products of every m block per edge, about twice what the
    forward executes."""
    d = cfg.d_hidden
    if cfg.arch == "equiformer_v2":
        dim = (cfg.l_max + 1) ** 2
        per_edge = 2 * dim * dim * d + 2 * 3 * (cfg.m_max * 2 + 1) * d * d * dim
        per_node = 2 * d * d * 2
    elif cfg.arch == "meshgraphnet":
        per_edge = 2 * (3 * d) * d + 2 * d * d
        per_node = 2 * (2 * d) * d + 2 * d * d
    elif cfg.arch == "gatedgcn":
        per_edge = 2 * 3 * d * d
        per_node = 2 * 2 * d * d
    else:  # graphsage
        per_edge = 2 * d
        per_node = 2 * 2 * d * d
    fwd = cfg.n_layers * (edges * per_edge + nodes * per_node)
    return {"model_flops": float(3.0 * fwd if train else fwd), "params": 0.0,
            "active_params": 0.0}


def gnn_counts(shape: ShapeSpec) -> Tuple[int, int]:
    """``(nodes, edges)`` of a GNN training cell on one device (copy of
    ``_gnn_counts`` with one device, not the smoke sizes): a minibatch's
    seeds and their sampled frontiers, a batch of small graphs with both
    directions of each edge, or a whole graph with both directions."""
    if shape.kind == "minibatch":
        b, (f1, f2) = shape.batch_nodes, shape.fanouts
        return b + b * f1 + b * f1 * f2, b * f1 + b * f1 * f2
    if shape.kind == "batched_graphs":
        return shape.batch_graphs * shape.n_nodes, shape.batch_graphs * shape.n_edges * 2
    return shape.n_nodes, shape.n_edges * 2


def gnn_loss(out: torch.Tensor, labels: torch.Tensor, node_mask: torch.Tensor,
             cfg: gnn.GNNConfig) -> torch.Tensor:
    """The node-masked mean loss of ``_gnn_cell``'s step, in float32:
    cross-entropy for ``d_out > 1``, squared error for ``d_out == 1``."""
    out = out.float()
    if cfg.d_out > 1:
        per = torch.logsumexp(out, -1) - out.gather(-1, labels.long()[:, None])[:, 0]
    else:
        per = (out[:, 0] - labels.float()) ** 2
    return torch.sum(per * node_mask) / torch.clamp_min(node_mask.sum(), 1)


def gnn_value_and_grad(params, tg: gnn.TrainGraph, labels: torch.Tensor, cfg: gnn.GNNConfig, *,
                       use_kernels: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and its gradient by parameter name (zeros for a parameter
    the loss does not reach), as ``jax.value_and_grad`` of the step's loss
    gives them, on the graph ``tg`` (``gnn.train_graph``)."""
    names = sorted(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    with torch.enable_grad():
        out = gnn.train_forward(dict(zip(names, leaves)), tg, cfg, use_kernels=use_kernels)
        loss = gnn_loss(out, labels, tg.g.node_mask, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if gr is None else gr
                           for k, p, gr in zip(names, leaves, grads)}


def gnn_train_step(params, opt: AdamWState, tg: gnn.TrainGraph, labels: torch.Tensor,
                   cfg: gnn.GNNConfig, *, lr=1e-3, use_kernels: bool):
    """One training step (the ``step`` of ``_gnn_cell``) on the graph
    ``tg`` (``gnn.train_graph``, built once for every step): the loss's
    gradient, then ``adamw_update``. Returns ``(params, opt, loss,
    gnorm)``; its arguments are left as they were."""
    loss, grads = gnn_value_and_grad(params, tg, labels, cfg, use_kernels=use_kernels)
    params2, opt2, gnorm = adamw_update(params, grads, opt, lr)
    return params2, opt2, loss, gnorm


def recsys_requests(cfg: dlrm.DLRMConfig, batch: int,
                    seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """One batch of requests drawn with ``numpy.random.default_rng(seed)``
    as the JAX recsys tests draw them: dense features ``[batch, n_dense]``
    float32 from a standard normal, sparse ids ``[batch, n_sparse,
    multi_hot]`` int32 uniform over ``[0, rows_per_table)``. Real Criteo
    ids are heavily skewed toward a few hot rows; these are not, so every
    lookup is a cold row."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
    sparse = rng.integers(0, cfg.rows_per_table,
                          (batch, cfg.n_sparse, cfg.multi_hot)).astype(np.int32)
    return dense, sparse


def retrieval_candidates(cfg: dlrm.DLRMConfig, n: int, seed: int) -> np.ndarray:
    """``n`` candidate ids int32, uniform over the last table's rows."""
    return np.random.default_rng([seed, 1]).integers(0, cfg.rows_per_table, n).astype(np.int32)
