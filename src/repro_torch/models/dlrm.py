"""DLRM-RM2 [arXiv:1906.00091]: embedding bags → dot interaction → MLPs.

Port of ``repro/models/dlrm.py``: ``forward`` and ``retrieval_scores`` for
serving, ``train_forward`` for training, ``param_specs``. The 26 sparse
tables are stacked ``[n_sparse, rows, dim]``; every lookup of a forward is
one :func:`repro_torch.kernels.ops.embedding_bag` call over the stack viewed
as one ``[n_sparse · rows, dim]`` table, with bag ``b · F + f`` for field
``f`` of example ``b``. That is the function the JAX forward computes with
``take_along_axis`` and a sum. In training the call is differentiable: the
tables' gradient is a segment sum of the bags' gradients into the rows the
batch touches (the ``segment_sum`` kernel on the card). The dense products
are ``torch.matmul`` / ``torch.bmm``, as the JAX package leaves them to XLA.
Parameters are a flat dict keyed by the JAX names (``tables``, ``bot_w0``,
…), so the JAX parameters carry across unchanged
(``convert.dlrm_params_from_numpy``). The serving entry points run under
``torch.inference_mode()``; ``train_forward`` is the same body with grad.

On a grid ``mesh`` (:class:`~repro_torch.mesh.GridMesh`) each entry point
runs ``_dlrm_cell``'s program on one rank: the tables split by rows over
``"model"`` (:func:`param_specs`, :func:`dlrm_placements`; whole on every
rank where the row count does not split), the MLPs and the interaction
replicated on this data rank's examples. A rank looks up the ids that fall
in its rows ``[lo, hi)``; a valid id on another rank's rows goes to bag
``num_bags``, which the embedding bag drops forward and backward (static
shapes, no host read), and the bags are summed over ``"model"``
(``common.reduce_from_model``, *g*). Where the table is whole on every rank
the bags are not summed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch

from ..kernels import ops
from ..sharding import MODEL, fix_spec, placements
from .common import reduce_from_model

__all__ = ["DLRMConfig", "param_shapes", "param_specs", "dlrm_placements", "init_params",
           "forward", "train_forward", "retrieval_scores"]


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


def param_specs(c: DLRMConfig, mesh_axes: Sequence[str]) -> Dict[str, tuple]:
    """JAX's ``param_specs``: the tables' rows over ``"model"`` (where the
    mesh has it), every MLP leaf replicated; a tuple entry a dimension."""
    mdl = MODEL if MODEL in mesh_axes else None
    return {k: (None, mdl, None) if k == "tables" else (None,) * len(v)
            for k, v in param_shapes(c).items()}


def dlrm_placements(c: DLRMConfig, mesh) -> Dict:
    """Each leaf's :class:`~repro_torch.sharding.Placement` on a grid (by
    name), as ``_dlrm_cell`` places them: the tables' rows over ``"model"``
    where it divides them, the AdamW moments ZeRO-1 over the data axes on
    the first free dimension they divide."""
    return placements(param_specs(c, mesh.axis_names), param_shapes(c), mesh)


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


def _row_split(params, c: DLRMConfig, mesh) -> Tuple[int, bool]:
    """``(lo, split)``: the first global row of this rank's table shard, and
    whether the tables are split over ``"model"`` (their bags then summed
    over it). One device, or a table whole on every rank: ``(0, False)``."""
    if mesh is None or dlrm_placements(c, mesh)["tables"].model_dim is None:
        return 0, False
    vl = params["tables"].shape[1]
    if vl * mesh.size(MODEL) != c.rows_per_table:
        raise ValueError(f"embedding bags: a shard of {vl} rows on {mesh.size(MODEL)} model "
                         f"ranks is not the {c.rows_per_table} rows of a table")
    return mesh.coord(MODEL) * vl, True


def _lookups(ids: torch.Tensor, field: torch.Tensor, bag: torch.Tensor, num_bags: int, v: int,
             vl: int, lo: int, split: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The embedding bag's row and bag of each lookup of global id ``ids``
    (int32) in table ``field`` into bag ``bag``, over this rank's ``[F · vl,
    D]`` view of its shard of rows ``[lo, lo + vl)``: an id outside ``[0,
    v)`` reads row -1 (its bag NaN, on every rank); with ``split`` a valid
    id on another rank's rows goes to bag ``num_bags`` (dropped)."""
    valid = (ids >= 0) & (ids < v)
    if not split:
        return torch.where(valid, ids + field * vl, -1), bag
    local = ids - lo
    mine = (local >= 0) & (local < vl)
    rows = torch.where(mine, local + field * vl, valid.to(torch.int32) - 1)   # 0 or -1
    return rows, torch.where(valid & ~mine, num_bags, bag)


def _embedding_bags(params, sparse_ids: torch.Tensor, c: DLRMConfig, *,
                    use_kernels: bool, mesh=None) -> torch.Tensor:
    """sparse_ids ``[B, n_sparse, multi_hot]`` → ``[B, n_sparse, dim]``: one
    ``ops.embedding_bag`` call over the stacked tables viewed as one
    ``[F · V, D]`` table (no copy). Row ``f · V + ids[b, f, h]`` in
    ``[B, F, H]`` order goes to bag ``b · F + f``; an id outside ``[0, V)``
    makes its bag NaN, as JAX's gather fills it (negative ids included).
    On a grid ``mesh`` this rank's shard of rows, the bags summed over
    ``"model"`` where the tables are split."""
    tables = params["tables"]
    f, vl, d = tables.shape
    if f * vl >= 2**31:
        raise ValueError(f"embedding bags: {f} tables x {vl} rows exceed int32 row indices")
    lo, split = _row_split(params, c, mesh)
    b, _, h = sparse_ids.shape
    dev = sparse_ids.device
    field = torch.arange(f, dtype=torch.int32, device=dev)[None, :, None]
    bags = torch.arange(b * f, dtype=torch.int32, device=dev).view(b, f, 1).expand(-1, -1, h)
    rows, bags = _lookups(sparse_ids.to(torch.int32), field, bags, b * f, c.rows_per_table, vl,
                          lo, split)
    out = ops.embedding_bag(tables.view(f * vl, d), rows.reshape(-1), bags.reshape(-1), b * f,
                            use_kernels=use_kernels).view(b, f, d)
    return reduce_from_model(out, mesh) if split else out


def _interact(bot: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Top-MLP input ``[bot, upper triangle of feats · featsᵀ]``; the
    triangle in ``jnp.triu_indices(f, k=1)``'s row-major order."""
    inter = torch.bmm(feats, feats.transpose(1, 2))                  # [B, F+1, F+1]
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, 1, device=feats.device)
    return torch.cat([bot, inter[:, iu, ju]], dim=-1)


def _forward(params, dense, sparse_ids, c: DLRMConfig, use_kernels: bool,
             mesh=None) -> torch.Tensor:
    bot = _mlp(params, "bot", dense.to(c.tdtype), len(c.bot_mlp))                    # [B, D]
    emb = _embedding_bags(params, sparse_ids, c, use_kernels=use_kernels, mesh=mesh)  # [B, F, D]
    feats = torch.cat([bot[:, None, :], emb], dim=1)                               # [B, F+1, D]
    return _mlp(params, "top", _interact(bot, feats), len(c.top_mlp))[:, 0]


def forward(params, dense: torch.Tensor, sparse_ids: torch.Tensor, c: DLRMConfig, *,
            use_kernels: bool, mesh=None) -> torch.Tensor:
    """dense ``[B, n_dense]``, sparse_ids ``[B, n_sparse, multi_hot]`` →
    logits ``[B]``. ``use_kernels=True`` needs CUDA tensors and sends the
    embedding bags through the CUDA kernel (one launch). On a grid ``mesh``
    ``params`` are this rank's shards and the examples this data rank's."""
    with torch.inference_mode():
        return _forward(params, dense, sparse_ids, c, use_kernels, mesh)


def train_forward(params, dense: torch.Tensor, sparse_ids: torch.Tensor, c: DLRMConfig, *,
                  use_kernels: bool, mesh=None) -> torch.Tensor:
    """:func:`forward` with grad: differentiable in every parameter that
    requires grad, the tables through the embedding bag's backward (one
    ``embedding_bag`` launch forward, one ``segment_sum`` backward). On a
    grid the gradient of a table shard is its own rows' only; the bags'
    gradient passes *g* as it is."""
    return _forward(params, dense, sparse_ids, c, use_kernels, mesh)


def _candidates(params, user_sparse, candidate_ids, c: DLRMConfig, use_kernels: bool,
                mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The user's bags ``[1, F, D]`` and the rows ``[n, D]`` of this rank's
    candidates in the last table, both from one embedding-bag launch: the
    user's F bags, then a one-row bag a candidate (an id outside ``[0, V)``
    reads row -1, its row NaN as JAX's ``jnp.take`` fills it).

    On a grid ``mesh`` ``candidate_ids`` are all of them, and this rank
    scores its slice where every axis together divides them
    (``_dlrm_cell``'s ``_fix_spec(P(all_axes), (nc,))``), else all. Where
    the tables are split each rank of a ``"model"`` line reads the line's
    candidates from the rows it holds, and their bags are reduce-scattered
    back to their ranks (all-reduced when every rank scores all), while the
    user's are summed (*g*)."""
    tables = params["tables"]
    f, vl, d = tables.shape
    lo, split = _row_split(params, c, mesh)
    dev = candidate_ids.device
    cand = candidate_ids.to(torch.int32)
    sliced = False
    if mesh is not None:
        axes = tuple(mesh.axis_names)
        sliced = fix_spec((axes,), tuple(cand.shape), mesh)[0] is not None
        if sliced:
            line = ([r for ln in mesh.lines(MODEL) if mesh.rank in ln for r in ln] if split
                    else [mesh.rank])
            cand = torch.cat([cand[mesh.slices((axes,), tuple(cand.shape), r)] for r in line])
    h = user_sparse.shape[2]
    nb = f + cand.shape[0]
    field = torch.arange(f, dtype=torch.int32, device=dev)[None, :, None]
    bags = torch.arange(f, dtype=torch.int32, device=dev).view(1, f, 1).expand(1, f, h)
    u_rows, u_bags = _lookups(user_sparse.to(torch.int32), field, bags, nb, c.rows_per_table,
                              vl, lo, split)
    c_rows, c_bags = _lookups(cand, torch.tensor(f - 1, dtype=torch.int32, device=dev),
                              torch.arange(f, nb, dtype=torch.int32, device=dev), nb,
                              c.rows_per_table, vl, lo, split)
    out = ops.embedding_bag(tables.view(f * vl, d), torch.cat([u_rows.reshape(-1), c_rows]),
                            torch.cat([u_bags.reshape(-1), c_bags]), nb, use_kernels=use_kernels)
    user, rows = out[:f][None], out[f:]
    if split:
        user = reduce_from_model(user, mesh)
        acc = rows.to(torch.float32, copy=True).contiguous()
        acc = mesh.reduce_scatter(acc, MODEL, 0) if sliced else mesh.all_reduce(acc, MODEL)
        rows = acc.to(rows.dtype)
    return user, rows


def retrieval_scores(params, dense: torch.Tensor, user_sparse: torch.Tensor,
                     candidate_ids: torch.Tensor, c: DLRMConfig, *,
                     use_kernels: bool, mesh=None) -> torch.Tensor:
    """Score one query (dense ``[1, n_dense]``, user_sparse
    ``[1, n_sparse, multi_hot]``) against ``candidate_ids [N]`` in the
    last sparse field → ``[N]``. The user's bags and the candidates' rows of
    the last table come from one embedding-bag launch (:func:`_candidates`;
    an id outside ``[0, V)`` gives NaN, as JAX's ``jnp.take``). Batched over
    the candidates, never a loop.

    On a grid ``mesh`` ``params`` are this rank's shards and
    ``candidate_ids`` all of them: the scores are this rank's slice where
    every axis together divides N, else of all N."""
    with torch.inference_mode():
        bot = _mlp(params, "bot", dense.to(c.tdtype), len(c.bot_mlp))                # [1, D]
        emb_user, cand = _candidates(params, user_sparse, candidate_ids, c, use_kernels, mesh)
        n = cand.shape[0]
        feats = torch.cat([bot[:, None, :], emb_user], dim=1)                      # [1, F+1, D]
        feats = feats.expand(n, -1, -1).clone()
        feats[:, -1] = cand
        top_in = _interact(bot.expand(n, -1), feats)
        return _mlp(params, "top", top_in, len(c.top_mlp))[:, 0]
