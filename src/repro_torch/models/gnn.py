"""GNN full-graph inference: GatedGCN, GraphSAGE, MeshGraphNet.

Single-device port of ``repro/models/gnn.py``. Message passing is a row
gather (``index_select``) plus :func:`repro_torch.kernels.ops.segment_sum`
over a padded edge list: a padded edge's destination becomes the id
``n``, which the segment sum drops. Each forward first sorts its edge list
by that id (:func:`sort_edges`) and builds the segment plans once, so every
segment sum of the forward reads its rows in order; node outputs do not
depend on the order of the edges. Parameters are a plain dict keyed by
the JAX names (``"l3_A"``, ``"p0_edge_w1"``, …), so the JAX package's
parameters carry across unchanged (``convert.gnn_params_from_numpy``).

Inference only: every forward runs under ``torch.inference_mode()``, and
the gatedgcn forward updates its edge state in place. Its edge work runs
over slices of at most :data:`EDGE_SLICE` edges, summing into float64
node accumulators, so that an ``ogb_products``-sized graph (123.7 M
directed edges, a 17.3 GB bf16 edge state) fits one 80 GB card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from ..kernels import ops

__all__ = ["EDGE_SLICE", "GraphData", "GNNConfig", "SortedEdges", "sort_edges", "param_shapes",
           "init_params", "forward", "sage_minibatch_forward"]

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
    """Twin of ``repro.models.gnn.GNNConfig``, with the fields the three
    ported architectures read."""

    name: str
    arch: str              # gatedgcn | graphsage | meshgraphnet
    n_layers: int
    d_hidden: int
    d_in: int
    d_out: int
    d_edge_in: int = 0
    aggregator: str = "mean"
    fanouts: Tuple[int, ...] = ()     # graphsage sampled mode
    mlp_layers: int = 2               # meshgraphnet
    dtype: str = "float32"

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


def _segment_mean(data, seg, n, use_kernels, plan):
    s = ops.segment_sum(data, seg, n, use_kernels=use_kernels, plan=plan)
    ones = torch.ones((data.shape[0], 1), dtype=data.dtype, device=data.device)
    cnt = ops.segment_sum(ones, seg, n, use_kernels=use_kernels, plan=plan)
    return s / cnt.clamp_min(1.0)


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
               with_attr: bool = False) -> SortedEdges:
    """Sort ``g``'s edge list by destination once, and plan its segment
    sums: one plan per ``slice_rows`` edges (all of them when None).
    The sort's permutation is freed before this returns."""
    n, n_edges = g.n, g.src.shape[0]
    seg, order = torch.sort(torch.where(g.edge_mask, g.dst, n), stable=True)
    src = g.src.index_select(0, order).clamp_(0, n - 1)
    dst = g.dst.index_select(0, order).clamp_(0, n - 1)
    attr = g.edge_attr.index_select(0, order) if with_attr else None
    del order
    step = slice_rows or max(n_edges, 1)
    plans = [ops.segment_plan(seg[s:s + step], n) for s in range(0, max(n_edges, 1), step)]
    return SortedEdges(src, dst, seg, attr, plans, step)


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


def _graphsage_forward(params, g: GraphData, c: GNNConfig, use_kernels: bool):
    n = g.n
    h = g.x.to(c.tdtype)
    ed = sort_edges(g)
    for i in range(c.n_layers):
        agg = _segment_mean(h.index_select(0, ed.src), ed.seg, n, use_kernels, ed.plans[0])
        h = h @ params[f"l{i}_self"] + agg @ params[f"l{i}_neigh"] + params[f"l{i}_b"]
        if i < c.n_layers - 1:
            h = _sage_normalize(h)
    return h


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


def _mgn_forward(params, g: GraphData, c: GNNConfig, use_kernels: bool):
    n, dt = g.n, c.tdtype
    ed = sort_edges(g, with_attr=bool(c.d_edge_in))
    h = _mlp_apply(params, "enc_n", g.x.to(dt), 2, norm=True)
    ea = (ed.edge_attr.to(dt) if c.d_edge_in
          else torch.ones((g.src.shape[0], 1), dtype=dt, device=h.device))
    e = _mlp_apply(params, "enc_e", ea, 2, norm=True)
    for i in range(c.n_layers):
        edge_in = torch.cat([e, h.index_select(0, ed.src), h.index_select(0, ed.dst)], -1)
        e = e + _mlp_apply(params, f"p{i}_edge", edge_in, 2, norm=True)
        agg = ops.segment_sum(e, ed.seg, n, use_kernels=use_kernels, plan=ed.plans[0])
        h = h + _mlp_apply(params, f"p{i}_node", torch.cat([h, agg], -1), 2, norm=True)
    return _mlp_apply(params, "dec", h, 2)


_SHAPES = {
    "gatedgcn": _gatedgcn_shapes,
    "graphsage": _graphsage_shapes,
    "meshgraphnet": _mgn_shapes,
}

_FORWARD = {
    "gatedgcn": _gatedgcn_forward,
    "graphsage": _graphsage_forward,
    "meshgraphnet": _mgn_forward,
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


def forward(params, g: GraphData, c: GNNConfig, *, use_kernels: bool) -> torch.Tensor:
    """Full-graph node outputs ``[N, d_out]``. ``use_kernels=True`` needs
    CUDA tensors and sends every segment sum through the CUDA kernel."""
    with torch.inference_mode():
        return _FORWARD[c.arch](params, g, c, use_kernels)
