"""The training steps of DLRM, the LMs and the GNNs, the DLRM serving
steps, their FLOP counts and their inputs.

Twins of ``repro/launch/steps.py``'s cells on one device: the
``recsys_train``, ``recsys_serve`` and ``retrieval`` branches of
``_dlrm_cell`` and ``_dlrm_flops``; the train branch of ``_lm_cell`` (its
microbatch count and float32 gradient accumulation; GQA or MLA, dense or
MoE layers, the MoE sum as ``_lm_cell``'s mesh routes it) and
``_lm_flops``; the ``step`` of ``_gnn_cell``, ``_gnn_counts`` and
``_gnn_flops``. Each step's loss and gradient are JAX's; the DLRM and LM
steps then run :func:`~repro_torch.optim.adamw_update_`, in place (their
parameters and moments fill most of the card), the GNN step the functional
``adamw_update``.

``_gnn_cell``'s step on a mesh, too: ``gnn_train_step`` on a train graph
built with ``mesh=grid`` (``gnn.train_graph``): the graph split over every
axis, the weights replicated, the node-masked mean loss summed over every
axis, the gradient summed over every axis into ZeRO-1 moments
(:func:`gnn_adamw_init`).

``_lm_cell``'s train branch on a mesh, too (the placements of its leaves
by :mod:`repro_torch.sharding`): :func:`lm_adamw_init` and
``lm_train_step(..., mesh=grid)``: tensor-parallel layers and experts over
``"model"`` (:func:`~repro_torch.models.transformer.train_forward`), each
data rank its slice of every microbatch, the gradients averaged over the
data axes and AdamW on ZeRO-1 moments
(:func:`~repro_torch.optim.adamw_update_zero1_`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.registry import ShapeSpec
from ..models import dlrm, gnn
from ..models import transformer as tf
from ..models.common import cross_entropy, vocab_parallel_cross_entropy
from ..optim import AdamWState, adamw_init_zero1, adamw_update, adamw_update_, adamw_update_zero1_
from ..sharding import MODEL, batch_axes

__all__ = ["dlrm_serve_step", "dlrm_retrieval_step", "dlrm_flops", "dlrm_loss",
           "dlrm_value_and_grad", "dlrm_train_step", "lm_flops", "lm_micro_batches",
           "lm_loss", "lm_value_and_grad", "lm_train_step", "flat_params", "gnn_flops",
           "gnn_counts", "gnn_loss", "gnn_value_and_grad", "gnn_train_step", "recsys_requests",
           "retrieval_candidates", "lm_adamw_init", "gnn_adamw_init"]


def lm_adamw_init(params, cfg: tf.TransformerConfig, mesh) -> AdamWState:
    """Zero ZeRO-1 moments for this rank's shards ``params`` (nested, as
    :func:`~repro_torch.convert.lm_params_shard` cuts them): each leaf's
    slice of the data axes on its ``data_dim``."""
    place = tf.lm_placements(cfg, mesh)
    return adamw_init_zero1(flat_params(params), {k: p.data_dim for k, p in place.items()},
                            mesh)


def dlrm_serve_step(params, dense, sparse, cfg: dlrm.DLRMConfig, *, use_kernels: bool):
    """Logits ``[B]`` of one batch of requests (the ``recsys_serve`` cell)."""
    return dlrm.forward(params, dense, sparse, cfg, use_kernels=use_kernels)


def dlrm_retrieval_step(params, dense, sparse, candidates, cfg: dlrm.DLRMConfig, *,
                        use_kernels: bool):
    """Scores ``[N]`` of one query against ``candidates [N]`` (the
    ``retrieval`` cell)."""
    return dlrm.retrieval_scores(params, dense, sparse, candidates, cfg,
                                 use_kernels=use_kernels)


def dlrm_flops(cfg: dlrm.DLRMConfig, batch: int, train: bool = False) -> Dict[str, float]:
    """Model FLOP of serving ``batch`` examples, or with ``train`` of one
    training step on them, three times that (the two MLPs and the dot
    interaction, 2 FLOP a multiply-add; copy of ``_dlrm_flops``), and the
    table parameters."""
    dims_b = (cfg.n_dense,) + cfg.bot_mlp
    dims_t = (cfg.n_interact + cfg.bot_mlp[-1],) + cfg.top_mlp
    mlp = sum(2 * a * b for a, b in zip(dims_b, dims_b[1:]))
    mlp += sum(2 * a * b for a, b in zip(dims_t, dims_t[1:]))
    inter = 2 * (cfg.n_sparse + 1) ** 2 * cfg.embed_dim
    params = cfg.n_sparse * cfg.rows_per_table * cfg.embed_dim
    return {"model_flops": float(batch * (mlp + inter) * (3.0 if train else 1.0)),
            "params": float(params), "active_params": float(params)}


def dlrm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``_dlrm_cell``'s stable binary cross-entropy on float32 logits:
    ``mean(max(z, 0) - z·y + log1p(exp(-|z|)))``."""
    z = logits.float()
    return torch.mean(torch.clamp_min(z, 0) - z * labels + torch.log1p(torch.exp(-torch.abs(z))))


def dlrm_value_and_grad(params, dense, sparse, labels, cfg: dlrm.DLRMConfig, *,
                        use_kernels: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and its gradient by parameter name, as ``jax.value_and_grad``
    of ``_dlrm_cell``'s loss gives them. The leaves share the parameters'
    storage; the tables' gradient is dense (``[F, V, D]``, zero in the rows
    no lookup touched)."""
    names = sorted(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    with torch.enable_grad():
        logits = dlrm.train_forward(dict(zip(names, leaves)), dense, sparse, cfg,
                                    use_kernels=use_kernels)
        loss = dlrm_loss(logits, labels)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads))


def dlrm_train_step(params, opt: AdamWState, dense, sparse, labels, cfg: dlrm.DLRMConfig, *,
                    lr=1e-3, use_kernels: bool):
    """One training step (the ``step`` of ``_dlrm_cell``'s ``recsys_train``
    branch): the loss's gradient, then AdamW at ``lr`` **in place**
    (:func:`~repro_torch.optim.adamw_update_`): ``params`` and ``opt`` are
    overwritten and returned. Returns ``(params, opt, loss, gnorm)``."""
    loss, grads = dlrm_value_and_grad(params, dense, sparse, labels, cfg,
                                      use_kernels=use_kernels)
    gnorm = adamw_update_(params, grads, opt, lr)
    return params, opt, loss, gnorm


# ---------------------------------------------------------------------------
# LM training (one device)
# ---------------------------------------------------------------------------

def lm_flops(cfg: tf.TransformerConfig, shape: ShapeSpec) -> Dict[str, float]:
    """Model FLOP of one cell of ``shape`` (copy of ``_lm_flops``): a
    training step's ``6 · active params · tokens``; a prefill's ``2 · active
    params · tokens`` plus its causal attention; a decode step's weights
    and its attention over the cache. With the total and active parameter
    counts."""
    n_active, n_total = cfg.active_param_count(), cfg.param_count()
    if shape.kind == "train":
        useful = 6.0 * n_active * shape.seq_len * shape.global_batch
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        attn = (2.0 * shape.global_batch * cfg.n_layers * cfg.n_heads * shape.seq_len ** 2
                * (cfg.d_head + (cfg.v_head or cfg.d_head)) / 2)
        useful = 2.0 * n_active * tokens + attn
    else:  # decode: one token against a seq_len cache
        b = shape.global_batch
        if cfg.attn == "mla":
            attn = (2.0 * b * cfg.n_layers * cfg.n_heads * shape.seq_len
                    * (cfg.qk_nope + cfg.qk_rope + cfg.v_head))
        else:
            attn = 2.0 * b * cfg.n_layers * cfg.n_heads * shape.seq_len * 2 * cfg.d_head
        useful = 2.0 * n_active * b + attn
    return {"model_flops": useful, "params": float(n_total), "active_params": float(n_active)}


def lm_micro_batches(cfg: tf.TransformerConfig, batch: int, seq: int, devices: int = 1) -> int:
    """``_lm_cell``'s microbatch count: double it while each keeps at least
    one example a device and a device's microbatch exceeds the examples
    whose saved layer inputs (``2 · L · S · D`` bytes each) fit 2e9 bytes
    (5e8 with MoE)."""
    stack_per_example = 2 * cfg.n_layers * seq * cfg.d_model
    target = 5e8 if cfg.moe else 2e9
    micro_bs = max(1, int(target // max(stack_per_example, 1)))
    n_micro = 1
    while batch // (n_micro * 2) >= devices and batch // (devices * n_micro) > micro_bs:
        n_micro *= 2
    return n_micro


def flat_params(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The leaves of a nested parameter dict by ``/``-joined path (the same
    tensors, no copies): the flat dict :mod:`repro_torch.optim` takes, in
    the sorted order JAX flattens the nested dict in."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_params(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def lm_loss(params, tokens, labels, cfg: tf.TransformerConfig, *, use_kernels: bool,
            mesh=None, stats: Optional[tf.RoutedStats] = None) -> torch.Tensor:
    """``_lm_cell``'s loss: the float32 mean token NLL of the training
    forward's logits. On a grid ``mesh`` the forward is tensor parallel and
    the loss of a vocabulary-split head vocabulary parallel; ``stats``
    collects the MoE exchange's drops and masked rows."""
    logits = tf.train_forward(params, tokens, cfg, use_kernels=use_kernels, mesh=mesh,
                              stats=stats)
    if mesh is not None and tf.lm_placements(cfg, mesh)["lm_head"].model_dim is not None:
        start = mesh.coord(MODEL) * logits.shape[-1]
        return vocab_parallel_cross_entropy(logits, labels, start, mesh)
    return cross_entropy(logits, labels)


def _lm_grads(params, tokens, labels, cfg, use_kernels, mesh=None, stats=None):
    """One loss and its gradient by flat parameter name. Each layer of a
    stacked group (``"dense"``, ``"moe"``) is its own leaf, a view of the
    stacked tensor; as each layer's gradient arrives it is copied into that
    layer's slice of the stacked gradient (allocated at the first) and
    freed, so no ``[L, …]`` gradient is made once a layer, and none is held
    while the head's backward runs. A layer's experts no row reached get
    exact zeros (the routed sum takes its experts apart with one
    ``unbind``)."""
    leaves, grads, model = [], {}, {}

    def into_slice(key, stacked, i):
        def hook(leaf):
            if key not in grads:
                grads[key] = torch.zeros_like(stacked)
            grads[key][i].copy_(leaf.grad)
            leaf.grad = None
        return hook

    for key, val in params.items():
        if isinstance(val, dict):
            layers = [{} for _ in range(next(iter(val.values())).shape[0])]
            for name, t in val.items():
                for i, layer in enumerate(layers):
                    layer[name] = leaf = t[i].detach().requires_grad_()
                    leaf.register_post_accumulate_grad_hook(into_slice(f"{key}/{name}", t, i))
                    leaves.append(leaf)
            model[key] = layers
        else:
            model[key] = leaf = val.detach().requires_grad_()
            leaves.append(leaf)
    with torch.enable_grad():
        loss = lm_loss(model, tokens, labels, cfg, use_kernels=use_kernels, mesh=mesh,
                       stats=stats)
        torch.autograd.backward(loss, inputs=leaves)
    for key, val in params.items():
        if isinstance(val, dict):
            for name, t in val.items():
                grads.setdefault(f"{key}/{name}", torch.zeros_like(t))
        else:
            grad = model[key].grad
            grads[key] = grad if grad is not None else torch.zeros_like(val)
    return loss.detach(), {k: grads[k] for k in sorted(grads)}


def _micro_batches(tokens, labels, n_micro: int, mesh):
    """The ``(tokens, labels)`` of each microbatch this rank computes:
    microbatch ``j`` is rows ``[j·b/n, (j+1)·b/n)`` of the batch (JAX's
    reshape); on a grid ``mesh`` a data rank takes its slice of each by
    :func:`~repro_torch.sharding.batch_axes`, or all of it where they do not divide it (as JAX's
    ``_moe_routed`` replicates such a batch over the data axes)."""
    b = tokens.shape[0]
    if b % n_micro:
        raise ValueError(f"lm_value_and_grad: batch {b} is not a multiple of {n_micro}")
    micro = list(zip(tokens.chunk(n_micro), labels.chunk(n_micro)))
    if mesh is None or batch_axes(b // n_micro, mesh) is None:
        return micro
    daxes = mesh.data_axes
    rows = b // n_micro // mesh.size(daxes)
    lo = mesh.coord(daxes) * rows
    return [(t[lo:lo + rows], lab[lo:lo + rows]) for t, lab in micro]


def lm_value_and_grad(params, tokens, labels, cfg: tf.TransformerConfig, *, use_kernels: bool,
                      n_micro: int = 1, mesh=None, stats: Optional[tf.RoutedStats] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and its gradient by flat parameter name
    (:func:`flat_params`' keys), as ``_lm_cell``'s step takes them: with
    ``n_micro > 1`` the batch is cut into ``n_micro`` microbatches, their
    gradients summed in float32, divided by ``n_micro`` and cast to each
    parameter's type, the loss their mean.

    On a grid ``mesh`` ``params`` are this rank's shards and the batch the
    global one, of which each data rank computes its part
    (:func:`_micro_batches`); the loss returned is averaged over the data
    axes, the gradient is this rank's own (:func:`lm_train_step` averages
    it over the data axes)."""
    micro = _micro_batches(tokens, labels, n_micro, mesh)
    if n_micro == 1:
        loss, grads = _lm_grads(params, *micro[0], cfg, use_kernels, mesh, stats)
    else:
        flat = flat_params(params)
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in flat.items()}
        losses = []
        for t, lab in micro:
            loss, g = _lm_grads(params, t, lab, cfg, use_kernels, mesh, stats)
            losses.append(loss)
            for k in acc:
                acc[k] += g[k].float()
            del g
        grads = {k: (a / n_micro).to(flat[k].dtype) for k, a in acc.items()}
        loss = torch.stack(losses).mean()
    if mesh is not None:
        daxes = mesh.data_axes
        loss = mesh.all_reduce(loss.reshape(1).clone(), daxes)[0] / mesh.size(daxes)
    return loss, grads


def lm_train_step(params, opt: AdamWState, tokens, labels, cfg: tf.TransformerConfig, *,
                  lr=3e-4, use_kernels: bool, n_micro: int | None = None, mesh=None,
                  stats: Optional[tf.RoutedStats] = None):
    """One training step (the train branch of ``_lm_cell``): the loss's
    gradient over ``n_micro`` microbatches (default :func:`lm_micro_batches`
    over the data ranks), then AdamW at ``lr`` **in place** on the flat view
    of ``params`` (``opt`` keyed by :func:`flat_params`' names). Returns
    ``(params, opt, loss, gnorm)``, the first two the same objects,
    overwritten.

    On a grid ``mesh`` (:class:`~repro_torch.mesh.GridMesh`) ``params`` are
    this rank's shards (:func:`~repro_torch.convert.lm_params_shard`) and
    ``opt`` its ZeRO-1 moments (:func:`lm_adamw_init`); ``tokens`` /
    ``labels`` the global batch, the same on every rank. The layers run
    tensor parallel over ``"model"`` and the experts expert parallel; the
    gradient is averaged over the data axes into each leaf's ZeRO-1 slice,
    clipped by the norm of the whole gradient and the updated slices
    gathered (:func:`~repro_torch.optim.adamw_update_zero1_`). ``stats``
    collects the MoE exchange's drops and masked rows."""
    dsize = 1 if mesh is None else mesh.size(mesh.data_axes)
    if n_micro is None:
        n_micro = lm_micro_batches(cfg, tokens.shape[0], tokens.shape[1], devices=dsize)
    loss, grads = lm_value_and_grad(params, tokens, labels, cfg, use_kernels=use_kernels,
                                    n_micro=n_micro, mesh=mesh, stats=stats)
    if mesh is None:
        gnorm = adamw_update_(flat_params(params), grads, opt, lr)
    else:
        place = tf.lm_placements(cfg, mesh)
        gnorm = adamw_update_zero1_(flat_params(params), grads, opt, lr, mesh=mesh,
                                    data_dims={k: p.data_dim for k, p in place.items()},
                                    model_split={k: p.model_dim is not None
                                                 for k, p in place.items()})
    return params, opt, loss, gnorm


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


def gnn_counts(shape: ShapeSpec, n_dev: int = 1) -> Tuple[int, int]:
    """``(nodes, edges)`` of a GNN training cell (copy of ``_gnn_counts``,
    not the smoke sizes): a minibatch's seeds and their sampled frontiers,
    a batch of small graphs with both directions of each edge, or a whole
    graph with both directions; each padded to a multiple of ``n_dev``,
    the devices the rows split over."""
    if shape.kind == "minibatch":
        b, (f1, f2) = shape.batch_nodes, shape.fanouts
        nodes, edges = b + b * f1 + b * f1 * f2, b * f1 + b * f1 * f2
    elif shape.kind == "batched_graphs":
        nodes, edges = shape.batch_graphs * shape.n_nodes, shape.batch_graphs * shape.n_edges * 2
    else:
        nodes, edges = shape.n_nodes, shape.n_edges * 2
    return _pad_to(nodes, n_dev), _pad_to(edges, n_dev)


def _pad_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


class _SumOverMesh(torch.autograd.Function):
    """A rank's term summed over every axis; backward, the gradient as it
    is: the loss is one value, of which each rank's term is its share."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.detach().clone().contiguous(), mesh.axis_names)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gnn_loss(out: torch.Tensor, labels: torch.Tensor, node_mask: torch.Tensor,
             cfg: gnn.GNNConfig, mesh=None) -> torch.Tensor:
    """The node-masked mean loss of ``_gnn_cell``'s step, in float32:
    cross-entropy for ``d_out > 1``, squared error for ``d_out == 1``. On a
    grid ``mesh`` ``out``, ``labels`` and ``node_mask`` are this rank's node
    rows: the masked sum and the count are each summed over every axis, and
    a rank's gradient is that of its own rows' share."""
    out = out.float()
    if cfg.d_out > 1:
        per = torch.logsumexp(out, -1) - out.gather(-1, labels.long()[:, None])[:, 0]
    else:
        per = (out[:, 0] - labels.float()) ** 2
    total, count = torch.sum(per * node_mask), node_mask.sum()
    if mesh is not None:
        total = _SumOverMesh.apply(total.reshape(1), mesh)[0]
        count = mesh.all_reduce(count.reshape(1).clone(), mesh.axis_names)[0]
    return total / torch.clamp_min(count, 1)


def gnn_adamw_init(params, cfg: gnn.GNNConfig, mesh) -> AdamWState:
    """Zero ZeRO-1 moments of the replicated weights ``params`` on a grid
    ``mesh``: this data rank's slice of each leaf's first dimension the data
    axes divide (``_gnn_cell``'s ``_zero1_specs``)."""
    place = gnn.gnn_placements(cfg, mesh)
    return adamw_init_zero1(params, {k: p.data_dim for k, p in place.items()}, mesh)


def gnn_value_and_grad(params, tg: gnn.TrainGraph, labels: torch.Tensor, cfg: gnn.GNNConfig, *,
                       use_kernels: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and its gradient by parameter name (zeros for a parameter
    the loss does not reach), as ``jax.value_and_grad`` of the step's loss
    gives them, on the graph ``tg`` (``gnn.train_graph``). On the mesh of a
    train graph built with ``mesh=`` (``labels`` this rank's node rows) the
    loss is the whole graph's and the gradient this rank's share: the sum
    over every rank's is the whole gradient."""
    names = sorted(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    with torch.enable_grad():
        out = gnn.train_forward(dict(zip(names, leaves)), tg, cfg, use_kernels=use_kernels)
        loss = gnn_loss(out, labels, tg.g.node_mask, cfg, tg.mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if gr is None else gr
                           for k, p, gr in zip(names, leaves, grads)}


def gnn_train_step(params, opt: AdamWState, tg: gnn.TrainGraph, labels: torch.Tensor,
                   cfg: gnn.GNNConfig, *, lr=1e-3, use_kernels: bool):
    """One training step (the ``step`` of ``_gnn_cell``) on the graph
    ``tg`` (``gnn.train_graph``, built once for every step): the loss's
    gradient, then ``adamw_update``. Returns ``(params, opt, loss,
    gnorm)``; its arguments are left as they were.

    On the grid of a train graph built with ``mesh=grid`` (``_gnn_cell``'s
    step on a mesh) ``tg`` and ``labels`` are this rank's shard, ``params``
    the whole replicated weights and ``opt`` this rank's ZeRO-1 moments
    (:func:`gnn_adamw_init`): the gradient is summed over every axis (the
    graph is split over all of them) into each leaf's ZeRO-1 slice, clipped
    by the whole gradient's norm, and the updated slices gathered over the
    data axes (:func:`~repro_torch.optim.adamw_update_zero1_`, in place on
    copies of ``params`` and ``opt``)."""
    loss, grads = gnn_value_and_grad(params, tg, labels, cfg, use_kernels=use_kernels)
    mesh = tg.mesh
    if mesh is None:
        params2, opt2, gnorm = adamw_update(params, grads, opt, lr)
        return params2, opt2, loss, gnorm
    place = gnn.gnn_placements(cfg, mesh)
    params2 = {k: v.clone() for k, v in params.items()}
    opt2 = AdamWState(step=opt.step.clone(), mu={k: v.clone() for k, v in opt.mu.items()},
                      nu={k: v.clone() for k, v in opt.nu.items()})
    gnorm = adamw_update_zero1_(params2, grads, opt2, lr, mesh=mesh,
                                data_dims={k: p.data_dim for k, p in place.items()},
                                model_split={k: False for k in place},
                                grad_axes=mesh.axis_names)
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
