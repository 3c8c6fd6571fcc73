"""DLRM serving steps, their FLOP count and their requests.

Twins of the ``recsys_serve`` and ``retrieval`` branches of
``repro/launch/steps.py`` (``_dlrm_cell``) and of its ``_dlrm_flops`` for
serving; the training branch is not ported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..models import dlrm

__all__ = ["dlrm_serve_step", "dlrm_retrieval_step", "dlrm_flops", "recsys_requests",
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
