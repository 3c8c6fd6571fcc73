"""GNN full-graph inference and training: GatedGCN, GraphSAGE, MeshGraphNet,
EquiformerV2.

Port of ``repro/models/gnn.py``. Message passing is a row gather
(``index_select``) plus :func:`repro_torch.kernels.ops.segment_sum` over a
padded edge list: a padded edge's destination becomes the id ``n``, which
the segment sum drops. Each forward first sorts its edge list by that id
(:func:`sort_edges`) and builds the segment plans once, so every segment
sum of the forward reads its rows in order; node outputs do not depend on
the order of the edges. Parameters are a plain dict keyed by the JAX
names (``"l3_A"``, ``"p0_edge_w1"``, ``"l0_so2_m1_i"``, …), so the JAX
package's parameters carry across unchanged
(``convert.gnn_params_from_numpy``).

:func:`forward`, the inference entry, runs under
``torch.inference_mode()``. The gatedgcn forward there is its own: it
updates its edge state in place and runs its edge work over slices of at
most :data:`EDGE_SLICE` edges, summing into float64 node accumulators,
so that an ``ogb_products``-sized graph (123.7 M directed edges, a
17.3 GB bf16 edge state) fits one 80 GB card. The other three
architectures have one forward each, which :func:`forward` runs without
a backward.

:func:`train_forward`, the training entry, runs the four models with
autograd on, written functionally: no in-place update of a tensor
autograd saves, no edge slices. Every node-to-edge gather is
:func:`repro_torch.kernels.ops.gather_rows`, whose backward is a segment
sum (the CUDA kernel on the card), and every segment sum is
differentiable. With ``GNNConfig.remat`` each layer is checkpointed and
recomputed in the backward, as JAX's ``jax.checkpoint`` does. The sorted
edge list and its plans are built once per graph (:func:`train_graph`)
and reused by every step.

EquiformerV2 cuts its sorted edge list into chunks by the JAX chunk
rule (``edge_chunk``), which bounds the rotated and mixed rows a chunk
holds; the chunks' message sums add in float64 and are cast to the
model's type once a layer (JAX adds each chunk into the model's type).
Which edges share a chunk differs from JAX; the sums do not depend on it
beyond rounding.

On a grid mesh (:class:`~repro_torch.mesh.GridMesh`, JAX's ``mesh=``)
nodes and edges are split over every axis in rank order (:func:`graph_specs`)
and the weights are replicated (:func:`param_specs`). Each rank holds its
shard of the graph, its edges' ids global; :func:`train_graph` with
``mesh=`` sorts the rank's edges and plans them over the global node count,
and :func:`forward` / :func:`train_forward` move data only through JAX's
four ``shard_map`` primitives, here ``torch.autograd.Function`` classes
with their transposes written out:

- :func:`mesh_gather_rows` (``_gather_rows``): the node table all-gathered
  over every axis, then the rank's rows taken; backward, a segment sum of
  the rows' gradients into all N rows (``ops.segment_sum``, the kernel on
  the card), reduce-scattered back to the node shards;
- with ``cs`` (``_gather_rows_cs``, EquiformerV2): the table traded to
  (nodes over the data axes × channels over ``model``) by an all-to-all,
  all-gathered over the data axes, the data line's rows taken, and an
  all-to-all back to (the rank's rows × every channel);
- :func:`mesh_segment_sum` (``_scatter_sum`` / ``_scatter_sum_cs``): a
  local segment sum over all N (over the data line's edges with ``cs``),
  reduce-scattered to the node shards; backward, an all-gather and a take
  (dropped ids give 0).

The partial sums over all N are float64 (``ops.ACC_DTYPE``); they are
rounded to float32, reduce-scattered in float32 and rounded once to the
output's type (JAX sums them in the data's type). EquiformerV2 also does
by hand what GSPMD inserts: the segment max is a local ``scatter_reduce``
then a max over every axis, ``den[dst]`` a :func:`mesh_gather_rows`, the
positions all-gathered, and its chunks are each rank's own edges, cut by
JAX's chunk rule with ``shard_mult`` (:func:`eqv2_chunks`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..sharding import MODEL, placements
from . import wigner

__all__ = ["EDGE_SLICE", "GraphData", "GNNConfig", "SortedEdges", "sort_edges", "param_shapes",
           "init_params", "forward", "sage_minibatch_forward", "eqv2_chunks", "TrainGraph",
           "LineEdges", "train_graph", "train_forward", "param_specs", "graph_specs",
           "gnn_placements", "mesh_gather_rows", "mesh_segment_sum"]

# Edges per slice of the gatedgcn layer: its [slice, d_hidden] temporaries
# (gathered rows, gate, message) stay near 2.35 GB each at d_hidden = 70.
EDGE_SLICE = 1 << 24


@dataclasses.dataclass
class GraphData:
    """Padded graph (twin of ``repro.models.gnn.GraphData``). Edges with
    ``edge_mask`` False are padding."""

    x: torch.Tensor          # [N, F] node features
    src: torch.Tensor        # [E] int32
    dst: torch.Tensor        # [E] int32
    edge_attr: torch.Tensor  # [E, Fe] (zeros if unused)
    node_mask: torch.Tensor  # [N] bool
    edge_mask: torch.Tensor  # [E] bool
    positions: torch.Tensor  # [N, 3] (zeros for non-geometric graphs)

    @property
    def n(self) -> int:
        return self.x.shape[0]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """Twin of ``repro.models.gnn.GNNConfig``. ``remat`` checkpoints each
    layer of :func:`train_forward`; the inference forward ignores it."""

    name: str
    arch: str              # gatedgcn | graphsage | meshgraphnet | equiformer_v2
    n_layers: int
    d_hidden: int
    d_in: int
    d_out: int
    d_edge_in: int = 0
    aggregator: str = "mean"
    fanouts: Tuple[int, ...] = ()     # graphsage sampled mode
    mlp_layers: int = 2               # meshgraphnet
    l_max: int = 6                    # equiformer
    m_max: int = 2
    n_heads: int = 8
    dtype: str = "float32"
    remat: bool = True                # checkpoint each layer (bwd recompute)
    edge_chunk: int = 32768           # equiformer: bound per-chunk rotation/
                                      # message working set

    @property
    def tdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def _mlp_shapes(dims: Sequence[int], prefix: str) -> Dict[str, Tuple[int, ...]]:
    out = {}
    for i in range(len(dims) - 1):
        out[f"{prefix}_w{i}"] = (dims[i], dims[i + 1])
        out[f"{prefix}_b{i}"] = (dims[i + 1],)
    return out


def _mlp_apply(params, prefix: str, x: torch.Tensor, n: int, norm: bool = False):
    for i in range(n):
        x = x @ params[f"{prefix}_w{i}"] + params[f"{prefix}_b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    if norm:
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)  # jnp.var is the biased one
        x = (x - mu) * torch.rsqrt(var + 1e-6)
    return x


@dataclasses.dataclass
class SortedEdges:
    """A graph's edges sorted by segment id (stable): clipped gather
    indices, the ids (``n`` on padding, so padding sorts last), the edge
    features when the model reads them, and one segment plan per slice of
    ``slice_rows`` edges."""

    src: torch.Tensor
    dst: torch.Tensor
    seg: torch.Tensor
    edge_attr: torch.Tensor | None
    plans: List[ops.SegmentPlan]
    slice_rows: int


def sort_edges(g: GraphData, slice_rows: int | None = None,
               with_attr: bool = False, n: int | None = None) -> SortedEdges:
    """Sort ``g``'s edge list by destination once, and plan its segment
    sums: one plan per ``slice_rows`` edges (all of them when None), over
    ``n`` nodes (``g.n`` by default; on a mesh the global count, which a
    rank's edge ids index). The sort's permutation is freed before this
    returns."""
    n = g.n if n is None else n
    n_edges = g.src.shape[0]
    seg, order = torch.sort(torch.where(g.edge_mask, g.dst, n), stable=True)
    src = g.src.index_select(0, order).clamp_(0, n - 1)
    dst = g.dst.index_select(0, order).clamp_(0, n - 1)
    attr = g.edge_attr.index_select(0, order) if with_attr else None
    del order
    step = slice_rows or max(n_edges, 1)
    plans = [ops.segment_plan(seg[s:s + step], n) for s in range(0, max(n_edges, 1), step)]
    return SortedEdges(src, dst, seg, attr, plans, step)


# ---------------------------------------------------------------------------
# Distributed gather / scatter on a grid mesh (JAX's shard_map primitives)
# ---------------------------------------------------------------------------

def _data_line(mesh) -> Tuple[str, ...]:
    """The axes but ``model``: a channel-split primitive's data line."""
    return tuple(a for a in mesh.axis_names if a != MODEL)


def _channel_split(mesh, width: int) -> bool:
    """JAX's rule: split channels over ``model`` where it exists and
    divides the last dimension."""
    return MODEL in mesh.axis_names and width % mesh.shape[MODEL] == 0


def _round_scatter(part: torch.Tensor, mesh, axes) -> torch.Tensor:
    """A float64 partial sum over all N rounded to float32 and
    reduce-scattered over ``axes`` in float32 (this rank's rows)."""
    return mesh.reduce_scatter(part.to(torch.float32), axes, 0)


class _MeshGather(torch.autograd.Function):
    """``h[idx]`` with ``h`` node-sharded over every axis of ``mesh``."""

    @staticmethod
    def forward(ctx, h, idx, plan, mesh, cs, use_kernels):
        ctx.save_for_backward(idx)
        ctx.plan, ctx.mesh, ctx.cs, ctx.use_kernels = plan, mesh, cs, use_kernels
        ctx.dtype, ctx.n = h.dtype, h.shape[0] * mesh.world
        ch = h.dim() - 1
        if cs:  # [N/G, …, d] → [N/(data), …, d/M]: trade node rows for channels
            h = mesh.all_to_all(h, MODEL, ch, 0)
        full = mesh.all_gather(h.contiguous(), _data_line(mesh) if cs else mesh.axis_names, 0)
        rows = full.index_select(0, idx)
        del full
        # with cs, split the data line's rows over the model ranks, channels back
        return mesh.all_to_all(rows, MODEL, 0, ch) if cs else rows

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        mesh, n, ch = ctx.mesh, ctx.n, grad.dim() - 1
        if ctx.cs:
            grad = mesh.all_to_all(grad.contiguous(), MODEL, ch, 0)
        part = ops.segment_sum(grad.reshape(grad.shape[0], -1), idx, n,
                               use_kernels=ctx.use_kernels, plan=ctx.plan, dtype=ops.ACC_DTYPE)
        part = part.reshape((n,) + tuple(grad.shape[1:]))
        out = _round_scatter(part, mesh, _data_line(mesh) if ctx.cs else mesh.axis_names)
        del part
        if ctx.cs:
            out = mesh.all_to_all(out, MODEL, 0, ch)
        return out.to(ctx.dtype), None, None, None, None, None


class _MeshSegmentSum(torch.autograd.Function):
    """``segment_sum(data, seg, n)`` to node shards over every axis."""

    @staticmethod
    def forward(ctx, data, seg, plan, mesh, cs, use_kernels, dtype):
        ctx.save_for_backward(seg)
        ctx.mesh, ctx.cs, ctx.use_kernels, ctx.dtype = mesh, cs, use_kernels, data.dtype
        if cs:  # edges → (the data line's edges × a channel shard)
            data = mesh.all_to_all(data.contiguous(), MODEL, 1, 0)
        part = ops.segment_sum(data, seg, plan.n, use_kernels=use_kernels, plan=plan,
                               dtype=ops.ACC_DTYPE)
        out = _round_scatter(part, mesh, _data_line(mesh) if cs else mesh.axis_names)
        del part
        if cs:  # nodes → (the rank's node rows × every channel)
            out = mesh.all_to_all(out, MODEL, 0, 1)
        return out.to(dtype)

    @staticmethod
    def backward(ctx, grad):
        (seg,) = ctx.saved_tensors
        ops._use_kernel(grad, ctx.use_kernels, "segment_sum")
        mesh, g = ctx.mesh, grad.to(ctx.dtype)
        if ctx.cs:
            g = mesh.all_to_all(g.contiguous(), MODEL, 1, 0)
        full = mesh.all_gather(g.contiguous(), _data_line(mesh) if ctx.cs else mesh.axis_names, 0)
        n = full.shape[0]
        full = torch.cat([full, full.new_zeros((1, full.shape[1]))])
        rows = full.index_select(0, torch.where((seg >= 0) & (seg < n), seg, n))
        del full
        if ctx.cs:
            rows = mesh.all_to_all(rows, MODEL, 0, 1)
        return rows, None, None, None, None, None, None


def mesh_gather_rows(h: torch.Tensor, idx: torch.Tensor, mesh, *, use_kernels: bool,
                     plan: Optional[ops.SegmentPlan] = None, cs: bool = False) -> torch.Tensor:
    """``h[idx]`` with ``h`` this rank's rows of a node table split over
    every axis of ``mesh`` in rank order and ``idx`` global row ids (int32):
    JAX's ``_gather_rows``, or with ``cs`` ``_gather_rows_cs``, whose
    ``idx`` holds the ids of the rank's whole data line (every model rank's
    edges, in model order) and whose output is the rank's own rows.
    ``plan`` is the :func:`~repro_torch.kernels.ops.segment_plan` over the
    global N of the ids the gradient sums by (those of ``idx``, the rows
    known to carry zero gradient set to N, which drops them; without one,
    the backward plans ``idx``): the transpose's segment sum, the kernel on
    the card with ``use_kernels``, which on a CPU tensor raises here as in
    the backward."""
    ops._use_kernel(h, use_kernels, "gather_rows")
    if plan is not None:
        plan.check(idx.shape[0], h.shape[0] * mesh.world, h.device)
    return _MeshGather.apply(h, idx, plan, mesh, cs, use_kernels)


def mesh_segment_sum(data: torch.Tensor, seg: torch.Tensor, plan: ops.SegmentPlan, mesh, *,
                     use_kernels: bool, cs: bool = False,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's rows ``[N / world, D]`` of ``segment_sum(data, seg, N)``
    over every rank's ``data`` (``[E_rank, D]``), node rows split over every
    axis in rank order: JAX's ``_scatter_sum``, or with ``cs``
    ``_scatter_sum_cs``, whose ``seg`` (and ``plan``) are the data line's
    ids. ``plan`` is the segment plan of ``seg`` over the global N; ids
    outside ``[0, N)`` are dropped. The sum is float64 on each rank, then
    float32 across ranks, rounded once to ``dtype`` (``data``'s type by
    default). Differentiable in ``data``. ``use_kernels=True`` on a CPU
    tensor raises here, before any collective, as in the backward."""
    ops._use_kernel(data, use_kernels, "segment_sum")
    plan.check(seg.shape[0], plan.n, data.device)
    if plan.n % mesh.world:
        raise ValueError(f"mesh_segment_sum: {plan.n} nodes do not split over {mesh.world} ranks")
    return _MeshSegmentSum.apply(data, seg, plan, mesh, cs, use_kernels, dtype or data.dtype)


# ---------------------------------------------------------------------------
# GatedGCN  [arXiv:1711.07553 / benchmarking-gnns config]
# ---------------------------------------------------------------------------

def _gatedgcn_shapes(c: GNNConfig) -> Dict:
    d = c.d_hidden
    shapes = {"embed_w": (c.d_in, d), "embed_b": (d,), "out_w": (d, c.d_out), "out_b": (c.d_out,)}
    if c.d_edge_in:
        shapes.update({"eembed_w": (c.d_edge_in, d), "eembed_b": (d,)})
    for i in range(c.n_layers):
        for nm in ("A", "B", "C", "U", "V"):
            shapes[f"l{i}_{nm}"] = (d, d)
    return shapes


def _gatedgcn_forward(params, g: GraphData, c: GNNConfig, use_kernels: bool):
    n, dt = g.n, c.tdtype
    n_edges = g.src.shape[0]
    ed = sort_edges(g, EDGE_SLICE, with_attr=bool(c.d_edge_in))
    src, dst, seg_dst = ed.src, ed.dst, ed.seg
    h = g.x.to(dt) @ params["embed_w"] + params["embed_b"]
    e = (ed.edge_attr.to(dt) @ params["eembed_w"] + params["eembed_b"] if c.d_edge_in
         else torch.zeros((n_edges, c.d_hidden), dtype=h.dtype, device=h.device))
    ed.edge_attr = None  # e holds their embedding
    for i in range(c.n_layers):
        A, B, C, U, V = (params[f"l{i}_{nm}"] for nm in ("A", "B", "C", "U", "V"))
        agg = torch.zeros((n, c.d_hidden), dtype=ops.ACC_DTYPE, device=h.device)
        den = torch.zeros_like(agg)
        for s, plan in zip(range(0, n_edges, ed.slice_rows), ed.plans):
            sl = slice(s, s + ed.slice_rows)
            hs = h.index_select(0, src[sl])
            e_new = h.index_select(0, dst[sl]) @ A
            e_new += hs @ B
            e_new += e[sl] @ C
            eta = torch.sigmoid(e_new)
            msg = hs @ V
            del hs
            msg *= eta
            ops.segment_sum(msg, seg_dst[sl], n, use_kernels=use_kernels, acc=agg, plan=plan)
            del msg
            ops.segment_sum(eta, seg_dst[sl], n, use_kernels=use_kernels, acc=den, plan=plan)
            del eta
            e[sl].add_(e_new.relu_())  # e + relu(e_new), in place
        h_new = h @ U + agg.to(dt) / (den.to(dt) + 1e-6)
        h = h + torch.relu(h_new)
    return h @ params["out_w"] + params["out_b"]


# ---------------------------------------------------------------------------
# GraphSAGE (mean aggregator)  [arXiv:1706.02216]
# ---------------------------------------------------------------------------

def _graphsage_shapes(c: GNNConfig) -> Dict:
    shapes = {}
    dims = [c.d_in] + [c.d_hidden] * (c.n_layers - 1) + [c.d_out]
    for i in range(c.n_layers):
        shapes[f"l{i}_self"] = (dims[i], dims[i + 1])
        shapes[f"l{i}_neigh"] = (dims[i], dims[i + 1])
        shapes[f"l{i}_b"] = (dims[i + 1],)
    return shapes


def _sage_normalize(h):
    h = torch.relu(h)
    return h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-6)


def sage_minibatch_forward(params, feats: Sequence[torch.Tensor], c: GNNConfig):
    """Sampled-neighbourhood forward (fixed fanouts → dense reshape-mean).

    ``feats[k]``: features of the k-hop frontier, ``[B·Πf₁..f_k, d_in]``.
    Twin of ``repro.models.gnn.sage_minibatch_forward``.
    """
    with torch.inference_mode():
        hs = list(feats)
        for i in range(c.n_layers):
            new_hs = []
            for depth in range(len(hs) - 1):
                parent = hs[depth]
                child = hs[depth + 1].reshape(parent.shape[0], c.fanouts[depth], -1)
                out = (parent @ params[f"l{i}_self"] + child.mean(dim=1) @ params[f"l{i}_neigh"]
                       + params[f"l{i}_b"])
                if i < c.n_layers - 1:
                    out = _sage_normalize(out)
                new_hs.append(out)
            hs = new_hs
        return hs[0]


# ---------------------------------------------------------------------------
# MeshGraphNet  [arXiv:2010.03409]
# ---------------------------------------------------------------------------

def _mgn_shapes(c: GNNConfig) -> Dict:
    d = c.d_hidden
    shapes = {}
    shapes.update(_mlp_shapes([c.d_in, d, d], "enc_n"))
    shapes.update(_mlp_shapes([max(c.d_edge_in, 1), d, d], "enc_e"))
    for i in range(c.n_layers):
        shapes.update(_mlp_shapes([3 * d, d, d], f"p{i}_edge"))
        shapes.update(_mlp_shapes([2 * d, d, d], f"p{i}_node"))
    shapes.update(_mlp_shapes([d, d, c.d_out], "dec"))
    return shapes


# ---------------------------------------------------------------------------
# EquiformerV2 (eSCN SO(2) convolutions)  [arXiv:2306.12059]
# ---------------------------------------------------------------------------

def _eqv2_m_indices(l_max: int, m_max: int):
    """Coefficient indices with |m| ≤ m_max, grouped by m."""
    groups = {}
    off = 0
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            if abs(m) <= m_max:
                groups.setdefault(m, []).append(off + m + l)
        off += 2 * l + 1
    return groups


def _eqv2_shapes(c: GNNConfig) -> Dict:
    d = c.d_hidden
    groups = _eqv2_m_indices(c.l_max, c.m_max)
    shapes = {
        "embed_w": (c.d_in, d), "embed_b": (d,),
        "out_w": (d, c.d_out), "out_b": (c.d_out,),
    }
    for i in range(c.n_layers):
        for m, idxs in groups.items():
            if m < 0:
                continue
            nl = len(idxs)
            # SO(2) linear: mixes l-channels within fixed m (+ pairs for m>0)
            shapes[f"l{i}_so2_m{m}_r"] = (nl * d, nl * d)
            if m > 0:
                shapes[f"l{i}_so2_m{m}_i"] = (nl * d, nl * d)
        shapes.update(_mlp_shapes([d, d, c.n_heads], f"l{i}_alpha"))
        shapes.update(_mlp_shapes([d, d, d], f"l{i}_update"))
        shapes[f"l{i}_gate_w"] = (d, c.l_max)
        shapes[f"l{i}_gate_b"] = (c.l_max,)
    return shapes


def _so2_rows(groups) -> List[int]:
    """The coefficient rows the SO(2) mixing reads and writes, in its order:
    m = 0, then +m and −m for each m > 0 (each group by ascending l)."""
    rows = list(groups[0])
    for m in range(1, max(groups) + 1):
        rows += groups[m] + groups[-m]
    return rows


def _so2_mix(params, i, x, groups, d):
    """SO(2)-restricted linear mixing per |m| (the eSCN O(L³) trick) of
    ``x [E, R, d]``, the rotated features' rows in :func:`_so2_rows` order;
    the output has the same rows. The rows with |m| > m_max, which the
    original writes as zeros, are never formed."""
    e = x.shape[0]
    outs, off = [], 0
    for m in range(0, max(groups) + 1):
        nl = len(groups[m])
        wr = params[f"l{i}_so2_m{m}_r"]
        xp = x[:, off:off + nl, :].reshape(e, -1)
        off += nl
        if m == 0:
            outs.append(xp @ wr)
        else:
            wi = params[f"l{i}_so2_m{m}_i"]
            xm = x[:, off:off + nl, :].reshape(e, -1)
            off += nl
            outs += [xp @ wr - xm @ wi, xp @ wi + xm @ wr]
    return torch.cat(outs, 1).reshape(e, off, d)


def eqv2_chunks(n_edges: int, edge_chunk: int, shard_mult: int = 1) -> int:
    """JAX's chunk rule (``_eqv2_forward``): halve the edge list while both
    halves divide evenly, hold at least ``max(edge_chunk, shard_mult)``
    edges and split evenly over ``shard_mult`` devices (the mesh's size; 1
    on one device). ``n_edges`` counts every device's edges."""
    n_chunks, floor = 1, max(edge_chunk, shard_mult)
    while (n_edges % (n_chunks * 2) == 0 and n_edges // (n_chunks * 2) >= floor
           and (n_edges // (n_chunks * 2)) % shard_mult == 0):
        n_chunks *= 2
    return n_chunks


# ---------------------------------------------------------------------------
# Forwards over a sorted, planned graph (training, and inference but gatedgcn's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LineEdges:
    """The ids of a rank's whole data line, for the channel-split
    primitives: every model rank's sorted edges, in model order
    (all-gathered over ``model`` once, as JAX passes them ``P(data)``).
    ``src``: the clipped source ids; ``src_plan``: their transpose's plan
    (padded edges dropped; None without a backward); ``seg``, ``plans``:
    each EquiformerV2 chunk's destination ids (the model ranks' chunks of
    that index, concatenated) and their plans."""

    src: torch.Tensor
    src_plan: Optional[ops.SegmentPlan]
    seg: List[torch.Tensor]
    plans: List[ops.SegmentPlan]


@dataclasses.dataclass
class TrainGraph:
    """A graph with what each forward over it reuses: its edges sorted by
    destination (``ed``: one segment plan per EquiformerV2 edge chunk,
    else one), ``seg_plan`` (the whole list's, for sums over every edge,
    and the transpose of every gather by destination), and ``src_plan``,
    the transpose of every gather by source (None where no backward
    runs). Padded edges send their messages to the dropped id ``n``, so
    they carry zero gradient: both transposes drop them (the source ids
    of padded edges are set to ``n``; the destination ids already are).

    On a grid ``mesh`` ``g`` is this rank's shard, ``n`` the global node
    count the ids and plans index, and ``line`` the data line's ids
    (EquiformerV2 only, where the mesh has a ``model`` axis)."""

    g: GraphData
    ed: SortedEdges
    seg_plan: ops.SegmentPlan
    src_plan: Optional[ops.SegmentPlan]
    n: int
    mesh: object = None
    line: Optional[LineEdges] = None


def train_graph(g: GraphData, c: GNNConfig, backward: bool = True, mesh=None) -> TrainGraph:
    """Sort ``g``'s edges and build the plans of a forward, once per graph
    (a training run reuses them on every step): EquiformerV2's edge list
    is cut into chunks by the JAX chunk rule. Without ``backward`` the
    source plans, which only a gather's transpose reads, are not built.

    On a grid ``mesh`` ``g`` is this rank's shard (:func:`graph_specs`;
    ``convert.graph_shard``): its node rows, and its edges with global ids.
    The plans are over the global node count, EquiformerV2's chunks are
    the rank's own edges cut by the chunk rule with ``shard_mult`` the
    mesh's size, and its data line's ids are all-gathered over ``model``
    (a collective: every rank of the mesh calls this together)."""
    n_edges = g.src.shape[0]
    world = 1 if mesh is None else mesh.world
    n = g.n * world
    eqv2 = c.arch == "equiformer_v2"
    n_chunks = eqv2_chunks(n_edges * world, c.edge_chunk, world) if eqv2 else 1
    ck = n_edges // n_chunks
    ed = sort_edges(g, ck if eqv2 else None, with_attr=bool(c.d_edge_in), n=n)
    seg_plan = ed.plans[0] if len(ed.plans) == 1 else ops.segment_plan(ed.seg, n)
    src_ids = torch.where(ed.seg < n, ed.src, n).to(torch.int32)
    src_plan = ops.segment_plan(src_ids, n) if backward else None
    line = None
    if mesh is not None and eqv2 and MODEL in mesh.axis_names:
        gather = functools.partial(mesh.all_gather, axes=MODEL)
        segs = list(gather(ed.seg.reshape(n_chunks, ck), dim=1).unbind(0))
        line = LineEdges(gather(ed.src), ops.segment_plan(gather(src_ids), n) if backward else None,
                         segs, [ops.segment_plan(s.contiguous(), n) for s in segs])
    return TrainGraph(g, ed, seg_plan, src_plan, n, mesh, line)


def _take(tg: TrainGraph, h, idx, plan, use_kernels: bool):
    """``h[idx]`` of a node table (this rank's rows on a mesh)."""
    if tg.mesh is None:
        return ops.gather_rows(h, idx, plan=plan, use_kernels=use_kernels)
    return mesh_gather_rows(h, idx, tg.mesh, plan=plan, use_kernels=use_kernels)


def _sum(tg: TrainGraph, data, seg, plan, use_kernels: bool, dtype=None):
    """``segment_sum(data, seg, n)`` (this rank's node rows on a mesh)."""
    if tg.mesh is None:
        return ops.segment_sum(data, seg, tg.n, use_kernels=use_kernels, plan=plan, dtype=dtype)
    return mesh_segment_sum(data, seg, plan, tg.mesh, use_kernels=use_kernels, dtype=dtype)


def _layers(c: GNNConfig, layer, *state):
    """``state = layer(i, *state)`` for each layer, each checkpointed
    (its activations recomputed in the backward) when ``c.remat`` and
    grad mode is on. The layers draw no random numbers, so no RNG state
    is stashed. On a mesh the recompute repeats the layer's collectives,
    in the same order on every rank."""
    remat = c.remat and torch.is_grad_enabled()
    for i in range(c.n_layers):
        fn = functools.partial(layer, i)
        state = (checkpoint(fn, *state, use_reentrant=False, preserve_rng_state=False)
                 if remat else fn(*state))
    return state


def _gatedgcn_train(params, tg: TrainGraph, c: GNNConfig, use_kernels: bool):
    g, ed, dt = tg.g, tg.ed, c.tdtype
    h = g.x.to(dt) @ params["embed_w"] + params["embed_b"]
    e = (ed.edge_attr.to(dt) @ params["eembed_w"] + params["eembed_b"] if c.d_edge_in
         else torch.zeros((ed.src.shape[0], c.d_hidden), dtype=h.dtype, device=h.device))

    def layer(i, h, e):
        A, B, C, U, V = (params[f"l{i}_{nm}"] for nm in ("A", "B", "C", "U", "V"))
        hs = _take(tg, h, ed.src, tg.src_plan, use_kernels)
        hd = _take(tg, h, ed.dst, tg.seg_plan, use_kernels)
        e_new = hd @ A + hs @ B + e @ C
        eta = torch.sigmoid(e_new)
        msg = eta * (hs @ V)
        agg = _sum(tg, msg, ed.seg, tg.seg_plan, use_kernels)
        den = _sum(tg, eta, ed.seg, tg.seg_plan, use_kernels)
        h_new = h @ U + agg / (den + 1e-6)
        return h + torch.relu(h_new), e + torch.relu(e_new)

    h, _ = _layers(c, layer, h, e)
    return h @ params["out_w"] + params["out_b"]


def _graphsage_forward(params, tg: TrainGraph, c: GNNConfig, use_kernels: bool):
    ed = tg.ed

    def layer(i, h):
        hs = _take(tg, h, ed.src, tg.src_plan, use_kernels)
        s = _sum(tg, hs, ed.seg, tg.seg_plan, use_kernels)
        ones = torch.ones((hs.shape[0], 1), dtype=hs.dtype, device=hs.device)
        agg = s / _sum(tg, ones, ed.seg, tg.seg_plan, use_kernels).clamp_min(1.0)
        h = h @ params[f"l{i}_self"] + agg @ params[f"l{i}_neigh"] + params[f"l{i}_b"]
        return (_sage_normalize(h) if i < c.n_layers - 1 else h,)

    (h,) = _layers(c, layer, tg.g.x.to(c.tdtype))
    return h


def _mgn_forward(params, tg: TrainGraph, c: GNNConfig, use_kernels: bool):
    g, ed, dt = tg.g, tg.ed, c.tdtype
    h = _mlp_apply(params, "enc_n", g.x.to(dt), 2, norm=True)
    ea = (ed.edge_attr.to(dt) if c.d_edge_in
          else torch.ones((ed.src.shape[0], 1), dtype=dt, device=h.device))
    e = _mlp_apply(params, "enc_e", ea, 2, norm=True)

    def layer(i, h, e):
        hs = _take(tg, h, ed.src, tg.src_plan, use_kernels)
        hd = _take(tg, h, ed.dst, tg.seg_plan, use_kernels)
        e = e + _mlp_apply(params, f"p{i}_edge", torch.cat([e, hs, hd], -1), 2, norm=True)
        agg = _sum(tg, e, ed.seg, tg.seg_plan, use_kernels)
        return h + _mlp_apply(params, f"p{i}_node", torch.cat([h, agg], -1), 2, norm=True), e

    h, _ = _layers(c, layer, h, e)
    return _mlp_apply(params, "dec", h, 2)


def _eqv2_forward(params, tg: TrainGraph, c: GNNConfig, use_kernels: bool):
    """Structurally-faithful eSCN stack, its edges in chunks.

    Per layer: the source features gathered once (as JAX does) in
    float32, so their transpose sums float32 rows; pass 1, the attention
    logits from the invariant channel of the SO(2) conv (only the m = 0
    rows of the rotated features and the first ``d`` columns of their
    product), each chunk's concatenated; the softmax per destination, out
    of place; pass 2, each chunk's SO(2) messages rotated back, weighted
    and summed in float64, the chunks' sums added and cast once a layer;
    the gated update a new tensor. As in JAX, the rotation and everything
    it touches run in float32 (``rot`` times the model's features
    promotes); the embedding, the update MLP, the gates and ``feat`` stay
    in the config's type. The edge rotations depend only on the
    positions, which take no gradient: built once a forward, outside the
    checkpointed layers. The segment max is taken on detached logits: the
    softmax does not depend on the shift, so its gradient through the max
    is zero in exact arithmetic.

    On a mesh the source features and the messages go through the
    channel-split primitives where ``model`` divides their width, the
    positions are all-gathered, the segment max is this rank's
    ``scatter_reduce`` then a max over every axis, and ``den[dst]`` is a
    :func:`mesh_gather_rows` of the node-sharded sums."""
    g, ed, n, dt, d, mesh = tg.g, tg.ed, tg.n, c.tdtype, c.d_hidden, tg.mesh
    dim = wigner.sh_basis_size(c.l_max)
    groups = _eqv2_m_indices(c.l_max, c.m_max)
    n0, ck = len(groups[0]), ed.slice_rows
    mask = (ed.seg < n)[:, None]
    seg_heads = ed.seg.long()[:, None].expand(-1, c.n_heads)
    cs_gather = mesh is not None and tg.line is not None and _channel_split(mesh, d)
    cs_sum = mesh is not None and tg.line is not None and _channel_split(mesh, dim * d)

    h0 = g.x.to(dt) @ params["embed_w"] + params["embed_b"]  # invariant
    feat = torch.cat([h0[:, None, :], h0.new_zeros((g.n, dim - 1, d))], 1)
    with torch.no_grad():
        pos = g.positions.to(torch.float32)
        if mesh is not None:
            pos = mesh.all_gather(pos.contiguous(), mesh.axis_names, 0)
        rot = wigner.edge_rotation(c.l_max,
                                   pos.index_select(0, ed.dst) - pos.index_select(0, ed.src))
        rots = rot[:, _so2_rows(groups), :].split(ck)  # [ck, R, dim] each
    del rot, pos

    def gather_src(f):
        if cs_gather:
            return mesh_gather_rows(f, tg.line.src, mesh, plan=tg.line.src_plan,
                                    use_kernels=use_kernels, cs=True)
        return _take(tg, f, ed.src, tg.src_plan, use_kernels)

    def sum_chunk(j, msg):
        if cs_sum:
            return mesh_segment_sum(msg, tg.line.seg[j], tg.line.plans[j], mesh,
                                    use_kernels=use_kernels, cs=True, dtype=ops.ACC_DTYPE)
        return _sum(tg, msg, ed.seg[j * ck:(j + 1) * ck], ed.plans[j], use_kernels,
                    dtype=ops.ACC_DTYPE)

    def layer(i, feat):
        f32 = {k: v.float() for k, v in params.items()
               if k.startswith((f"l{i}_so2_", f"l{i}_alpha_"))}
        w0 = f32[f"l{i}_so2_m0_r"][:, :d]
        src_f = gather_src(feat.float()).split(ck)           # [ck, dim, d] each
        # ---- pass 1: attention logits (m=0 rows only), softmax per destination
        alpha = torch.cat([_mlp_apply(f32, f"l{i}_alpha",
                                      torch.bmm(r[:, :n0], s).reshape(s.shape[0], -1) @ w0, 2)
                           for r, s in zip(rots, src_f)])
        amax = torch.full((n + 1, c.n_heads), -math.inf, dtype=torch.float32,
                          device=feat.device).scatter_reduce_(
            0, seg_heads, torch.where(mask, alpha.detach(), -math.inf), "amax")[:n]
        if mesh is not None:
            amax = mesh.all_reduce(amax.contiguous(), mesh.axis_names, op="max")
        shifted = alpha - amax.index_select(0, ed.dst)
        w = torch.exp(torch.where(mask, shifted, -math.inf))  # the mask before exp
        den = _sum(tg, w, ed.seg, tg.seg_plan, use_kernels)
        w = w / _take(tg, den, ed.dst, tg.seg_plan, use_kernels).clamp_min(1e-9)
        wh = w.mean(-1).split(ck)     # head-avg gate; 0 on padding
        # ---- pass 2: chunked messages, float64 segment sums --------------
        agg = None
        for j, (r, s, w_c) in enumerate(zip(rots, src_f, wh)):
            out_f = _so2_mix(f32, i, torch.bmm(r, s), groups, d)
            msg = torch.bmm(r.transpose(1, 2), out_f) * w_c[:, None, None]  # back to global
            part = sum_chunk(j, msg.reshape(msg.shape[0], -1))
            agg = part if agg is None else agg + part
        agg = agg.to(dt).reshape(g.n, dim, d)
        # ---- gated update: a degree-l gate on each row of degree l -------
        inv = agg[:, 0, :]
        upd = _mlp_apply(params, f"l{i}_update", inv, 2)
        gates = torch.sigmoid(inv @ params[f"l{i}_gate_w"] + params[f"l{i}_gate_b"])
        gate_rows = torch.cat([gates[:, l - 1:l, None].expand(-1, 2 * l + 1, 1)
                               for l in range(1, c.l_max + 1)], 1)
        return (torch.cat([feat[:, :1] + upd[:, None], feat[:, 1:] + agg[:, 1:] * gate_rows], 1),)

    (feat,) = _layers(c, layer, feat)
    return feat[:, 0, :] @ params["out_w"] + params["out_b"]


_SHAPES = {
    "gatedgcn": _gatedgcn_shapes,
    "graphsage": _graphsage_shapes,
    "meshgraphnet": _mgn_shapes,
    "equiformer_v2": _eqv2_shapes,
}

_TRAIN = {
    "gatedgcn": _gatedgcn_train,
    "graphsage": _graphsage_forward,
    "meshgraphnet": _mgn_forward,
    "equiformer_v2": _eqv2_forward,
}


def param_shapes(c: GNNConfig) -> Dict[str, Tuple[int, ...]]:
    """Parameter name → shape, as the JAX package names them."""
    return _SHAPES[c.arch](c)


def init_params(c: GNNConfig, generator: torch.Generator, device="cuda") -> Dict:
    """Random parameters: biases zero, weights ``N(0, 1) / sqrt(fan_in)`` in
    ``c.dtype`` (the JAX ``_init`` rule; the draws differ from ``jax.random``).
    Drawn on ``generator``'s device in sorted name order, then moved."""
    out = {}
    for name, shp in sorted(param_shapes(c).items()):
        if len(shp) == 1:  # all 1-D params here are biases
            out[name] = torch.zeros(shp, dtype=c.tdtype, device=device)
        else:
            w = torch.randn(shp, generator=generator, device=generator.device) / shp[0] ** 0.5
            out[name] = w.to(device=device, dtype=c.tdtype)
    return out


def forward(params, g: GraphData, c: GNNConfig, *, use_kernels: bool,
            mesh=None) -> torch.Tensor:
    """Full-graph node outputs ``[N, d_out]``, under inference mode.
    ``use_kernels=True`` needs CUDA tensors and sends every segment sum
    through the CUDA kernel. gatedgcn runs its edge-sliced in-place
    forward; the other three their training forward without a backward.
    On a grid ``mesh`` (JAX's ``forward(..., mesh=)``) ``g`` is this rank's
    shard (:func:`graph_specs`) and the output its node rows; every
    architecture runs its training forward without a backward."""
    with torch.inference_mode():
        if c.arch == "gatedgcn" and mesh is None:
            return _gatedgcn_forward(params, g, c, use_kernels)
        return _TRAIN[c.arch](params, train_graph(g, c, backward=False, mesh=mesh), c,
                              use_kernels)


def train_forward(params, tg: TrainGraph, c: GNNConfig, *, use_kernels: bool) -> torch.Tensor:
    """Full-graph node outputs ``[N, d_out]`` of ``tg`` (:func:`train_graph`,
    built once and reused by every step) with autograd on, for training.
    ``use_kernels=True`` needs CUDA tensors and sends every segment sum
    and every gather's backward through the CUDA kernel. On the mesh of a
    train graph built with ``mesh=``, this rank's node rows."""
    with torch.enable_grad():
        return _TRAIN[c.arch](params, tg, c, use_kernels)


def param_specs(c: GNNConfig, mesh_axes: Sequence[str]) -> Dict[str, tuple]:
    """Every weight replicated (JAX's ``param_specs``): a ``None`` a
    dimension."""
    return {k: (None,) * len(v) for k, v in param_shapes(c).items()}


def graph_specs(mesh_axes: Sequence[str]) -> GraphData:
    """The specs of a graph's fields (JAX's ``graph_specs``): node and edge
    rows split over every axis, in rank order."""
    rows = tuple(mesh_axes)
    return GraphData(x=(rows, None), src=(rows,), dst=(rows,), edge_attr=(rows, None),
                     node_mask=(rows,), edge_mask=(rows,), positions=(rows, None))


def gnn_placements(c: GNNConfig, mesh) -> Dict:
    """Each weight's :class:`~repro_torch.sharding.Placement` on a grid (by
    name): replicated, its AdamW moments ZeRO-1 over the data axes on the
    first dimension they divide, as ``_gnn_cell`` places them."""
    return placements(param_specs(c, mesh.axis_names), param_shapes(c), mesh)
