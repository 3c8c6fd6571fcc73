"""DLRM-RM2 [arXiv:1906.00091]: embedding bags → dot interaction → MLPs.

Single-device port of ``repro/models/dlrm.py``: ``forward`` and
``retrieval_scores`` for serving, ``train_forward`` for training. JAX's
``param_specs`` (the tables split by rows over ``"model"``) and
``_dlrm_cell``'s sharding have no twin yet: the LMs train on the port's
``GridMesh``, DLRM on one device (ROADMAP item 43). The 26 sparse tables are stacked
``[n_sparse, rows, dim]``; every lookup of a forward is one
:func:`repro_torch.kernels.ops.embedding_bag` call over the stack viewed as
one ``[n_sparse · rows, dim]`` table, with bag ``b · F + f`` for field
``f`` of example ``b``. That is the function the JAX forward computes with
``take_along_axis`` and a sum. In training the call is differentiable: the
tables' gradient is a segment sum of the bags' gradients into the rows the
batch touches (the ``segment_sum`` kernel on the card). The dense products
are ``torch.matmul`` / ``torch.bmm``, as the JAX package leaves them to XLA.
Parameters are a flat dict keyed by the JAX names (``tables``, ``bot_w0``,
…), so the JAX parameters carry across unchanged
(``convert.dlrm_params_from_numpy``). The serving entry points run under
``torch.inference_mode()``; ``train_forward`` is the same body with grad.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..kernels import ops

__all__ = ["DLRMConfig", "param_shapes", "init_params", "forward", "train_forward",
           "retrieval_scores"]


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """Twin of ``repro.models.dlrm.DLRMConfig``."""

    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    rows_per_table: int = 1_000_000
    bot_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    multi_hot: int = 1           # lookups per field (bag size)
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def n_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    def param_count(self) -> int:
        return sum(math.prod(s) for s in param_shapes(self).values())


def _mlp_dims(c: DLRMConfig, prefix: str) -> Tuple[int, ...]:
    if prefix == "bot":
        return (c.n_dense,) + c.bot_mlp
    return (c.n_interact + c.bot_mlp[-1],) + c.top_mlp


def param_shapes(c: DLRMConfig) -> Dict[str, Tuple[int, ...]]:
    """Parameter name → shape, as the JAX package names them."""
    shapes = {"tables": (c.n_sparse, c.rows_per_table, c.embed_dim)}
    for prefix in ("bot", "top"):
        dims = _mlp_dims(c, prefix)
        for i in range(len(dims) - 1):
            shapes[f"{prefix}_w{i}"] = (dims[i], dims[i + 1])
            shapes[f"{prefix}_b{i}"] = (dims[i + 1],)
    return shapes


def init_params(c: DLRMConfig, generator: torch.Generator, device="cuda") -> Dict:
    """Random parameters by the JAX ``init_params`` law: tables
    ``N(0, 1) / sqrt(dim)``, weights ``N(0, 1) / sqrt(fan_in)``, biases
    zero, in ``c.dtype``. The draws, in float32 on ``generator``'s device,
    differ from ``jax.random``; they are taken in sorted-name order."""
    out = {}
    for name, shape in sorted(param_shapes(c).items()):
        if len(shape) == 1:
            out[name] = torch.zeros(shape, dtype=c.tdtype, device=device)
            continue
        scale = 1.0 / math.sqrt(shape[-1] if name == "tables" else shape[0])
        w = torch.randn(shape, generator=generator, device=generator.device).mul_(scale)
        out[name] = w.to(device=device, dtype=c.tdtype)
    return out


def _mlp(params, prefix: str, x: torch.Tensor, n: int) -> torch.Tensor:
    for i in range(n):
        x = torch.matmul(x, params[f"{prefix}_w{i}"]) + params[f"{prefix}_b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def _embedding_bags(params, sparse_ids: torch.Tensor, c: DLRMConfig, *,
                    use_kernels: bool) -> torch.Tensor:
    """sparse_ids ``[B, n_sparse, multi_hot]`` → ``[B, n_sparse, dim]``: one
    ``ops.embedding_bag`` call over the stacked tables viewed as one
    ``[F · V, D]`` table (no copy). Row ``f · V + ids[b, f, h]`` in
    ``[B, F, H]`` order goes to bag ``b · F + f``; an id outside ``[0, V)``
    makes its bag NaN, as JAX's gather fills it (negative ids included)."""
    tables = params["tables"]
    f, v, d = tables.shape
    if f * v >= 2**31:
        raise ValueError(f"embedding bags: {f} tables x {v} rows exceed int32 row indices")
    b, _, h = sparse_ids.shape
    ids = sparse_ids.to(torch.int32)
    offsets = torch.arange(0, f * v, v, dtype=torch.int32, device=ids.device)[None, :, None]
    rows = torch.where((ids >= 0) & (ids < v), ids + offsets, -1).reshape(-1)
    bags = torch.arange(b * f, dtype=torch.int32, device=ids.device)[:, None].expand(-1, h)
    out = ops.embedding_bag(tables.view(f * v, d), rows, bags.reshape(-1), b * f,
                            use_kernels=use_kernels)
    return out.view(b, f, d)


def _interact(bot: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Top-MLP input ``[bot, upper triangle of feats · featsᵀ]``; the
    triangle in ``jnp.triu_indices(f, k=1)``'s row-major order."""
    inter = torch.bmm(feats, feats.transpose(1, 2))                  # [B, F+1, F+1]
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, 1, device=feats.device)
    return torch.cat([bot, inter[:, iu, ju]], dim=-1)


def _forward(params, dense, sparse_ids, c: DLRMConfig, use_kernels: bool) -> torch.Tensor:
    bot = _mlp(params, "bot", dense.to(c.tdtype), len(c.bot_mlp))                    # [B, D]
    emb = _embedding_bags(params, sparse_ids, c, use_kernels=use_kernels)           # [B, F, D]
    feats = torch.cat([bot[:, None, :], emb], dim=1)                               # [B, F+1, D]
    return _mlp(params, "top", _interact(bot, feats), len(c.top_mlp))[:, 0]


def forward(params, dense: torch.Tensor, sparse_ids: torch.Tensor, c: DLRMConfig, *,
            use_kernels: bool) -> torch.Tensor:
    """dense ``[B, n_dense]``, sparse_ids ``[B, n_sparse, multi_hot]`` →
    logits ``[B]``. ``use_kernels=True`` needs CUDA tensors and sends the
    embedding bags through the CUDA kernel (one launch)."""
    with torch.inference_mode():
        return _forward(params, dense, sparse_ids, c, use_kernels)


def train_forward(params, dense: torch.Tensor, sparse_ids: torch.Tensor, c: DLRMConfig, *,
                  use_kernels: bool) -> torch.Tensor:
    """:func:`forward` with grad: differentiable in every parameter that
    requires grad, the tables through the embedding bag's backward (one
    ``embedding_bag`` launch forward, one ``segment_sum`` backward)."""
    return _forward(params, dense, sparse_ids, c, use_kernels)


def retrieval_scores(params, dense: torch.Tensor, user_sparse: torch.Tensor,
                     candidate_ids: torch.Tensor, c: DLRMConfig, *,
                     use_kernels: bool) -> torch.Tensor:
    """Score one query (dense ``[1, n_dense]``, user_sparse
    ``[1, n_sparse, multi_hot]``) against ``candidate_ids [N]`` in the
    last sparse field → ``[N]``. The user side goes through the embedding
    bags once (one launch); the candidate rows are a plain gather of the
    last table, as JAX's ``jnp.take`` (an id outside ``[0, V)`` gives NaN).
    Batched over the candidates, never a loop."""
    with torch.inference_mode():
        n = candidate_ids.shape[0]
        bot = _mlp(params, "bot", dense.to(c.tdtype), len(c.bot_mlp))                # [1, D]
        emb_user = _embedding_bags(params, user_sparse, c, use_kernels=use_kernels)  # [1, F, D]
        last = params["tables"][c.n_sparse - 1]
        v = last.shape[0]
        ids = candidate_ids.long()
        cand = last.index_select(0, ids.clamp(0, v - 1))                           # [N, D]
        cand.masked_fill_(((ids < 0) | (ids >= v))[:, None], math.nan)
        feats = torch.cat([bot[:, None, :], emb_user], dim=1)                      # [1, F+1, D]
        feats = feats.expand(n, -1, -1).clone()
        feats[:, -1] = cand
        top_in = _interact(bot.expand(n, -1), feats)
        return _mlp(params, "top", top_in, len(c.top_mlp))[:, 0]
