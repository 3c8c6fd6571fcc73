"""Decoder-only transformer: dense GQA, MLA and mixture-of-experts layers.

Port of ``repro/models/transformer.py`` (RoPE, SwiGLU, layer-stacked ``[L,
…]`` parameters): for inference on one device ``forward`` (teacher
forcing), ``prefill``, ``prefill_chunked`` and ``decode_step`` over a
layer-stacked cache; for training ``train_forward`` (GQA or MLA, dense or
MoE layers), the same layer body with grad, each layer recomputed in the
backward when ``remat`` is set, on one device or on a grid mesh
(``param_specs``, tensor and expert parallel; see below). Parameters are a nested dict keyed by the
JAX names, weights in JAX's ``[in, out]`` layout, so the JAX package's
parameters carry across unchanged (``convert.lm_params_from_numpy``).

- **Attention.** Grouped-query (``attn="gqa"``), or MLA (``"mla"``,
  DeepSeek-V2 §2.1): low-rank query and key/value projections, and a cache
  of only the latents ``(c_kv, k_rope)``, ``kv_lora + qk_rope`` values a
  position. Every attention but the absorbed decode goes through
  :func:`repro_torch.kernels.ops.flash_attention`, the hand-written CUDA
  kernels with ``use_kernels=True`` and their plain version otherwise;
  offsets are Python ints, so the kernels serve prefill, chunked prefill and
  decode alike. MLA's materialized form expands K and V from the whole
  latent cache, K at the query width ``qk_nope + qk_rope`` and V at its own
  ``v_head``, as JAX does, in one call: prefill and chunked prefill take
  the tensor-core kernel at those widths, and the decode kernel, built for
  one width, gets V zero-padded inside the wrapper. The absorbed decode
  (``decode_absorbed`` with one new token) scores the queries against the
  latent cache itself in float32 products, as JAX does, with no kernel.
- **Mixture of experts** (the layers after ``first_dense``): router softmax
  in float32, top-k by a stable descending sort (ties go to the lower expert
  id, as ``jax.lax.top_k`` sends them), weights renormalized, then the
  shared experts after the routed ones. The routed sum differs between the
  entry points as JAX's does, which routes by whether it has a mesh:
  serving (JAX passes none) takes ``_moe_experts``, each expert's SwiGLU
  on only the rows routed to it, added into a zero accumulator in the
  model's type in ascending expert order (JAX's one-device path runs every
  expert on every token and adds ``y · 0`` for the unrouted ones, so each
  token's sum has the same terms in the same order; only the products' own
  rounding differs). Training (JAX's ``_lm_cell`` runs on a mesh, so
  ``_moe_routed``) takes ``_moe_routed``: its one-shard body at ep = 1,
  rows sorted by expert, each expert's rows in a static window with the
  rows past it masked to zero, each token's k weighted outputs summed in
  float32 and rounded once. Both read the per-expert row counts to the host
  once a layer.
- **On a grid mesh** (:class:`~repro_torch.mesh.GridMesh`, training only):
  ``param_specs`` is JAX's, and each rank holds its shards under the fixed
  specs. ``_layer`` runs the training block tensor parallel over ``"model"``
  (this rank's whole heads; ``wo`` / ``wd`` row-parallel, summed in float32;
  MLA's low-rank ``wq_a`` / ``wkv_a`` gathered whole), the embedding and
  head split by vocabulary, and ``_moe_routed_ep`` is JAX's ``_moe_routed``
  at ep = model ranks over the exchange with grad
  (:mod:`repro_torch.dist.collectives`), the shared experts tensor
  parallel, the router whole. Serving on a mesh (JAX's sharded prefill and
  decode caches) is not ported; the serving entry points run on one device.

Every serving entry point runs under ``torch.inference_mode()``. The serving
functions write the new keys and values (or latents) into the cache **in
place** and return the same cache object.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..dist.collectives import return_rows, route_rows, send_rows
from ..kernels import ops
from ..mesh import GridShape
from ..sharding import MODEL, Placement, placements
from .common import (apply_rope, copy_to_model, gather_from_model, reduce_from_model, rms_norm,
                     rope, scale_grad, swiglu)

__all__ = ["TransformerConfig", "param_shapes", "param_specs", "lm_placements", "init_params",
           "forward",
           "train_forward", "init_cache", "prefill", "prefill_chunked", "decode_step",
           "moe_window", "moe_windows", "RoutedStats"]

@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Twin of ``repro.models.transformer.TransformerConfig``, field for
    field. ``attn_backend``, ``q_chunk`` and ``attn_seq_shard`` steer JAX's
    compilation and sharding and are not read here: the port chooses its
    attention by ``use_kernels=``. ``moe_capacity_factor`` sizes the
    routed training sum's rows (:func:`moe_window`).
    ``remat`` checkpoints each layer of ``train_forward``."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    attn: str = "gqa"              # "gqa" | "mla"
    # MLA
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    first_dense: int = 0           # leading dense layers before MoE layers
    rope_theta: float = 1e4
    dtype: str = "bfloat16"
    attn_backend: str = "ref"
    q_chunk: int = 256
    moe_capacity_factor: float = 2.0
    decode_absorbed: bool = False  # MLA: the absorbed form for one-token decode
    attn_seq_shard: bool = False
    remat: bool = True

    @property
    def tdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def n_experts_padded(self) -> int:
        """Expert arrays are padded to a multiple of 16 (JAX's widest expert
        split); the padded experts are never routed to."""
        return -(-self.n_experts // 16) * 16

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_dense if self.moe else 0

    @property
    def n_dense_layers(self) -> int:
        return self.n_layers if not self.moe else self.first_dense

    def param_count(self) -> int:
        """Total parameters, from the shapes."""
        return sum(math.prod(s) for s in _leaves(param_shapes(self)))

    def active_param_count(self) -> int:
        """Parameters a token reads: with MoE, the padded experts it is not
        routed to left out (JAX's count)."""
        if not self.moe:
            return self.param_count()
        inactive = (self.n_moe_layers * (self.n_experts_padded - self.top_k)
                    * 3 * self.d_model * self.d_expert)
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _attn_shapes(c: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    d = c.d_model
    if c.attn == "gqa":
        return {
            "wq": (d, c.n_heads * c.d_head),
            "wk": (d, c.n_kv_heads * c.d_head),
            "wv": (d, c.n_kv_heads * c.d_head),
            "wo": (c.n_heads * c.d_head, d),
        }
    shapes = {
        "wkv_a": (d, c.kv_lora + c.qk_rope),
        "kv_norm": (c.kv_lora,),
        "wk_b": (c.kv_lora, c.n_heads * c.qk_nope),
        "wv_b": (c.kv_lora, c.n_heads * c.v_head),
        "wo": (c.n_heads * c.v_head, d),
    }
    qdim = c.n_heads * (c.qk_nope + c.qk_rope)
    if c.q_lora:
        shapes.update({"wq_a": (d, c.q_lora), "q_norm": (c.q_lora,), "wq_b": (c.q_lora, qdim)})
    else:
        shapes["wq"] = (d, qdim)
    return shapes


def _dense_layer_shapes(c: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    d, f = c.d_model, c.d_ff
    shapes = {"attn_norm": (d,), "mlp_norm": (d,), "wg": (d, f), "wu": (d, f), "wd": (f, d)}
    shapes.update(_attn_shapes(c))
    return shapes


def _moe_layer_shapes(c: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    d, fe, e = c.d_model, c.d_expert, c.n_experts_padded
    shapes = {"attn_norm": (d,), "mlp_norm": (d,), "router": (d, c.n_experts),
              "e_wg": (e, d, fe), "e_wu": (e, d, fe), "e_wd": (e, fe, d)}
    if c.n_shared:
        fs = c.n_shared * fe
        shapes.update({"s_wg": (d, fs), "s_wu": (d, fs), "s_wd": (fs, d)})
    shapes.update(_attn_shapes(c))
    return shapes


def _groups(c: TransformerConfig) -> List[Tuple[str, bool, int]]:
    """The layer groups in the order they run: ``(name, moe, layers)``,
    each only where the config has such layers."""
    return [(g, moe, n) for g, moe, n in (("dense", False, c.n_dense_layers),
                                          ("moe", True, c.n_moe_layers)) if n]


def param_shapes(c: TransformerConfig) -> Dict:
    """The parameter tree's shapes, named as the JAX package names them;
    the layer leaves are stacked ``[L, …]`` in a ``"dense"`` and a
    ``"moe"`` group."""
    shapes = {"embed": (c.vocab, c.d_model), "final_norm": (c.d_model,),
              "lm_head": (c.d_model, c.vocab)}
    for group, moe, n in _groups(c):
        layer = _moe_layer_shapes(c) if moe else _dense_layer_shapes(c)
        shapes[group] = {k: (n,) + s for k, s in layer.items()}
    return shapes


def param_specs(c: TransformerConfig, mesh_axes) -> Dict:
    """Twin of JAX's ``param_specs``: each leaf's spec as a tuple, TP over
    ``"model"`` (column-split ``wg``, ``wu``, ``wq``, ``wk``, ``wv``, ``wq_a``,
    ``wq_b``, ``wkv_a``, ``wk_b``, ``wv_b``, ``s_wg``, ``s_wu``; row-split
    ``wd``, ``wo``, ``s_wd``), the embedding and head split by vocabulary,
    the experts over ``"model"`` (EP), norms and the router whole. Before
    ``sharding.fix_spec``, which drops a split its dimension does not
    divide."""
    mdl = "model" if "model" in mesh_axes else None
    cols = ("wg", "wu", "wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "s_wg", "s_wu")

    def layer_specs(shapes):
        out = {}
        for name in shapes:
            if name.endswith("norm"):
                out[name] = (None, None)
            elif name in cols:
                out[name] = (None, None, mdl)
            elif name in ("wd", "wo", "s_wd"):
                out[name] = (None, mdl, None)
            elif name.startswith("e_"):
                out[name] = (None, mdl, None, None)
            else:
                out[name] = (None, None, None)
        return out

    specs = {"embed": (mdl, None), "final_norm": (None,), "lm_head": (None, mdl)}
    for group, moe, _ in _groups(c):
        specs[group] = layer_specs(_moe_layer_shapes(c) if moe else _dense_layer_shapes(c))
    return specs


def lm_placements(c: TransformerConfig, mesh) -> Dict[str, Placement]:
    """Each leaf's :class:`~repro_torch.sharding.Placement` by flat name on
    the grid ``mesh`` (a :class:`~repro_torch.mesh.GridShape`, or a
    ``GridMesh``): :func:`param_specs` fixed, and the ZeRO-1 moments, as
    ``_lm_cell`` places them. Worked out once a config and grid shape."""
    return _placements(c, mesh.sizes, mesh.axis_names)


@functools.lru_cache(maxsize=None)
def _placements(c: TransformerConfig, sizes, axis_names) -> Dict[str, Placement]:
    return placements(param_specs(c, axis_names), param_shapes(c), GridShape(sizes, axis_names))


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def init_params(c: TransformerConfig, generator: torch.Generator, device="cuda") -> Dict:
    """Random parameters by the JAX ``init_params`` law: norms one; embed
    ``N(0, 1) · 0.02``; lm_head ``N(0, 1) / sqrt(d_model)``; every other
    weight ``N(0, 1) / sqrt(fan_in)``, fan_in being its input axis (the
    second to last of one layer's leaf: ``d_model`` for ``e_wg`` / ``e_wu``,
    ``d_expert`` for ``e_wd``).

    The draws differ from ``jax.random``. They are taken in float32 on
    ``generator``'s device, leaf by leaf in sorted-name order (``dense/…``,
    ``embed``, ``final_norm``, ``lm_head``, ``moe/…``), a piece at a time: a
    stacked ``[L, …]`` leaf one layer at a time, ``embed`` and ``lm_head`` in
    blocks of whole rows no larger than the largest one-layer leaf. Each
    piece is cast to ``c.dtype`` and written into its leaf on ``device``
    before the next is drawn, so the float32 transient stays one layer's
    leaf (command-r-35b's ``wg`` would be 29.5 GB in float32 drawn whole)."""
    shapes = param_shapes(c)
    piece = max(math.prod(s[1:]) for g, _, _ in _groups(c) for s in shapes[g].values())

    def normal(shape, std, rows):
        out = torch.empty(shape, dtype=c.tdtype, device=device)
        for i in range(0, shape[0], rows):
            n = min(rows, shape[0] - i)
            w = torch.randn((n,) + tuple(shape[1:]), generator=generator,
                            device=generator.device)
            out[i:i + n] = w.mul_(std)
        return out

    def leaf(name, shape, std, rows):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=c.tdtype, device=device)
        return normal(shape, std, rows)

    params = {}
    for key in sorted(shapes):
        s = shapes[key]
        if isinstance(s, dict):
            params[key] = {n: leaf(n, ls, 1.0 / math.sqrt(ls[-2]), 1)
                           for n, ls in sorted(s.items())}
        else:
            std = 0.02 if key == "embed" else 1.0 / math.sqrt(c.d_model)
            params[key] = leaf(key, s, std, max(1, piece // math.prod(s[1:])))
    return params


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _gqa_qkv(lp, x, c: TransformerConfig, positions):
    """Queries, keys and values of the heads the weights hold (all of them,
    or under TP this rank's)."""
    b, l, _ = x.shape
    q = (x @ lp["wq"]).view(b, l, -1, c.d_head)
    k = (x @ lp["wk"]).view(b, l, -1, c.d_head)
    v = (x @ lp["wv"]).view(b, l, -1, c.d_head)
    cos, sin = rope(positions, c.d_head, c.rope_theta)
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    return q, k, v.transpose(1, 2)


def _same(x):
    return x


def _mla_q(lp, x, c: TransformerConfig, positions, f=_same):
    """MLA queries ``(q_nope [B, H, L, qk_nope], q_rope [B, H, L, qk_rope])``,
    RoPE on the ``qk_rope`` columns only; ``H`` the heads ``wq`` / ``wq_b``
    hold, ``f`` applied to the input of that head-split product (TP's
    :func:`~repro_torch.models.common.copy_to_model`)."""
    b, l, _ = x.shape
    if c.q_lora:
        q = f(rms_norm(x @ lp["wq_a"], lp["q_norm"])) @ lp["wq_b"]
    else:
        q = f(x) @ lp["wq"]
    q = q.view(b, l, -1, c.qk_nope + c.qk_rope).transpose(1, 2)
    cos, sin = rope(positions, c.qk_rope, c.rope_theta)
    return q[..., :c.qk_nope], apply_rope(q[..., c.qk_nope:], cos, sin)


def _mla_kv_latent(lp, x, c: TransformerConfig, positions):
    """The cache entries of a chunk: ``(c_kv [B, L, kv_lora], k_rope [B, L,
    qk_rope])``; ``k_rope`` is one head shared by all query heads."""
    kv = x @ lp["wkv_a"]
    c_kv = rms_norm(kv[..., :c.kv_lora], lp["kv_norm"])
    cos, sin = rope(positions, c.qk_rope, c.rope_theta)
    return c_kv, apply_rope(kv[..., c.kv_lora:][:, None], cos, sin)[:, 0]


def _mla_attention(lp, q_nope, q_rope, c_kv, k_rope, c: TransformerConfig, q_offset: int, *,
                   use_kernels: bool, f=_same):
    """Materialized MLA: K and V expanded from the whole latent ``c_kv [B,
    Lk, kv_lora]`` (its unwritten zeros too, hidden by the causal mask),
    ``k_rope`` broadcast to every head, V at its own ``v_head`` columns (a
    head-major view of the product: the kernel wrapper makes the one copy
    its route reads); one ``flash_attention`` call, scaled by ``1 /
    sqrt(qk_nope + qk_rope)``, the query's width. Returns ``[B, H, Lq,
    v_head]``. ``f`` is applied to the latents that meet the head-split
    ``wk_b`` / ``wv_b`` (TP's ``copy_to_model``)."""
    b, h = q_nope.shape[:2]
    lk = c_kv.shape[1]
    width = c.qk_nope + c.qk_rope
    c_kv, k_rope = f(c_kv), f(k_rope)
    k = torch.empty((b, h, lk, width), dtype=c_kv.dtype, device=c_kv.device)
    k[..., :c.qk_nope] = (c_kv @ lp["wk_b"]).view(b, lk, h, c.qk_nope).transpose(1, 2)
    k[..., c.qk_nope:] = k_rope[:, None]
    v = (c_kv @ lp["wv_b"]).view(b, lk, h, c.v_head).transpose(1, 2)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return ops.flash_attention(q, k, v, causal=True, q_offset=q_offset, use_kernels=use_kernels)


def _mla_attention_absorbed(lp, q_nope, q_rope, c_kv, k_rope, c: TransformerConfig,
                            q_offset: int):
    """Absorbed MLA: ``q_nope`` taken through ``wk_bᵀ`` into the latent
    space (in the model's type), scores in float32 against ``c_kv`` and the
    shared ``k_rope``, values read in latent space and expanded once a query
    through ``wv_b``; the output ``[B, H, Lq, v_head]`` in the cache's type.
    JAX's einsums, no kernel."""
    h, lq = q_nope.shape[1], q_nope.shape[2]
    lk = c_kv.shape[1]
    q_lat = torch.einsum("bhqn,rhn->bhqr", q_nope, lp["wk_b"].view(c.kv_lora, h, c.qk_nope))
    cf = c_kv.float()
    logits = (torch.einsum("bhqr,blr->bhql", q_lat.float(), cf)
              + torch.einsum("bhqe,ble->bhql", q_rope.float(), k_rope.float()))
    logits = logits * (1.0 / math.sqrt(c.qk_nope + c.qk_rope))
    qpos = torch.arange(lq, device=c_kv.device)[:, None] + q_offset
    kpos = torch.arange(lk, device=c_kv.device)[None, :]
    probs = torch.softmax(logits.masked_fill(kpos > qpos, -1e30), dim=-1)
    o_lat = torch.einsum("bhql,blr->bhqr", probs, cf)
    wv_b = lp["wv_b"].view(c.kv_lora, h, c.v_head).float()
    return torch.einsum("bhqr,rhv->bhqv", o_lat, wv_b).to(c_kv.dtype)


# ---------------------------------------------------------------------------
# Mixture of experts (one device)
# ---------------------------------------------------------------------------

def _router_probs(lp, x) -> torch.Tensor:
    """Router probabilities of ``x [T, D]``, ``[T, n_experts]`` float32:
    logits in the model's type, softmax in float32."""
    return torch.softmax((x @ lp["router"]).float(), dim=-1)


def _top_experts(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` most probable experts of each row, ``[T, k]`` int64, by a
    stable descending sort: equal probabilities in ascending expert order,
    as ``jax.lax.top_k``."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]


def _route_weights(probs: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """The probabilities of experts ``sel``, renormalized by their sum
    clipped at 1e-9."""
    w = probs.gather(-1, sel)
    return w / w.sum(-1, keepdim=True).clamp_min(1e-9)


def _moe_route(lp, x, c: TransformerConfig):
    """Router of ``x [T, D]``: ``(weights [T, top_k] float32, experts [T,
    top_k] int64)``."""
    probs = _router_probs(lp, x)
    sel = _top_experts(probs, c.top_k)
    return _route_weights(probs, sel), sel


def _expert_rows(experts: torch.Tensor, n: int) -> List[int]:
    """Rows routed to each of the ``n`` experts, read to the host (the
    layer's one synchronization)."""
    return torch.bincount(experts, minlength=n).tolist()


def _moe_experts(lp, x, weights, sel, c: TransformerConfig) -> torch.Tensor:
    """``Σ_e coef · SwiGLU_e(x)`` over the routed ``(token, expert)`` pairs
    of ``x [T, D]``: each expert's SwiGLU on its routed rows only, times the
    weight cast to the model's type, added into a zero ``[T, D]`` in
    ascending expert order (a token meets each expert at most once)."""
    experts = sel.reshape(-1)
    order = torch.argsort(experts, stable=True)
    tokens = order // c.top_k
    coef = weights.reshape(-1)[order].to(x.dtype)[:, None]
    out = torch.zeros_like(x)
    start = 0
    for e, n in enumerate(_expert_rows(experts, c.n_experts)):
        if n:
            rows = tokens[start:start + n]
            y = swiglu(x.index_select(0, rows), lp["e_wg"][e], lp["e_wu"][e], lp["e_wd"][e])
            out.index_add_(0, rows, y * coef[start:start + n])
            start += n
    return out


def moe_windows(counts: List[int], total: int, window: int) -> List[int]:
    """Rows ``_moe_routed`` keeps of each expert: expert ``e``'s ``counts[e]``
    rows lie at offset ``o = Σ counts[:e]`` of the expert-sorted rows
    (``total`` of them with the exchange's padding, which sorts last), and
    only those before ``start + window`` are computed, ``start = min(o,
    total − window)`` (JAX clips the window's start into the rows)."""
    kept, o = [], 0
    for n in counts:
        kept.append(max(0, min(n, min(o, total - window) + window - o)))
        o += n
    return kept


def moe_window(c: TransformerConfig, tokens: int) -> Tuple[int, int]:
    """``(total, window)`` of ``_moe_routed`` over ``tokens`` tokens at ep =
    1: the exchange's ``t · k · capacity_factor`` rows (its capacity, real
    rows first), and each expert's static window ``min(total, max(128, 2 ·
    total // n_experts_padded))``."""
    total = max(1, int(tokens * c.top_k * c.moe_capacity_factor))
    return total, min(total, max(128, (2 * total) // c.n_experts_padded))


def _moe_routed(lp, x, weights, sel, c: TransformerConfig) -> torch.Tensor:
    """JAX's ``_moe_routed`` body on one shard (ep = 1, no collective) for
    ``x [T, D]``: the ``T · k`` (token, choice) rows in token-major order
    (the exchange keeps them all, its capacity :func:`moe_window`'s
    ``total``), sorted stably by expert; of each expert the rows inside its
    window (:func:`moe_windows`) through its SwiGLU, the rest zero;
    unsorted, each row times its weight in the model's type, and each
    token's k rows summed (in float32, rounded once to the model's type, as
    XLA sums them).

    Deterministic with grad: the rows are gathered once by a permutation
    and unsorted by its inverse (no index meets two rows), the experts'
    weights taken apart by one ``unbind`` (an expert no row reaches gets an
    exact zero gradient)."""
    t, d = x.shape
    k = c.top_k
    total, window = moe_window(c, t)
    if total < t * k:
        raise NotImplementedError(f"{c.name}: moe_capacity_factor "
                                  f"{c.moe_capacity_factor} < 1 drops routed rows")
    experts = sel.reshape(-1)
    order = torch.argsort(experts, stable=True)
    counts = _expert_rows(experts, c.n_experts_padded)
    kept = moe_windows(counts, total, window)
    rows = x.unsqueeze(1).expand(t, k, d).reshape(t * k, d).index_select(0, order)
    y = _windowed_experts(lp, rows, counts, kept).index_select(0, torch.argsort(order))
    return (y * weights.reshape(-1, 1).to(x.dtype)).view(t, k, d).sum(1)


def _windowed_experts(lp, rows, counts: List[int], kept: List[int]) -> torch.Tensor:
    """The expert SwiGLU of ``rows`` sorted by expert, ``counts[e]`` rows of
    expert ``e`` of ``lp["e_*"]``: its first ``kept[e]`` through its
    weights, the rest zero. The experts' weights are taken apart by one
    ``unbind`` (an expert no row reaches gets an exact zero gradient)."""
    pieces = rows.split([m for nk, ne in zip(kept, counts) for m in (nk, ne - nk)])
    wg, wu, wd = (lp[name].unbind(0) for name in ("e_wg", "e_wu", "e_wd"))
    ys = []
    for e, (nk, ne) in enumerate(zip(kept, counts)):
        if nk:
            ys.append(swiglu(pieces[2 * e], wg[e], wu[e], wd[e]))
        if ne > nk:
            ys.append(rows.new_zeros((ne - nk, rows.shape[1])))
    return torch.cat(ys)


@dataclasses.dataclass
class RoutedStats:
    """What the expert-parallel routed sum (:func:`_moe_routed_ep`) saw, a
    record a call (a layer's forward, and again its recompute under remat,
    which routes as the forward did): the rows the exchange dropped past its
    capacity, summed over the model axis, and the valid rows the receiving
    rank masked past their expert's window, each a 0-d tensor until
    :meth:`summary` reads them."""

    overflow: List[torch.Tensor] = dataclasses.field(default_factory=list)
    masked: List[torch.Tensor] = dataclasses.field(default_factory=list)

    def summary(self) -> Dict:
        """``calls``, the ``overflow`` summed over them, and the masked rows
        of each call and their sum (one read to the host)."""
        masked = [int(m) for m in self.masked]
        return {"calls": len(self.masked), "overflow": sum(int(o) for o in self.overflow),
                "masked_per_call": masked, "masked": sum(masked)}


def _moe_routed_ep(lp, x, weights, sel, c: TransformerConfig, mesh,
                   stats: Optional[RoutedStats]) -> torch.Tensor:
    """JAX's ``_moe_routed`` on the ``"model"`` axis of a grid mesh, ``ep``
    its size, for ``x [B, L, D]`` (this data rank's tokens, the same on
    every model rank) and its routing ``weights`` / ``sel [B, L, k]``; this
    rank holds experts ``[m·e_per, (m+1)·e_per)`` of ``lp["e_*"]``,
    ``e_per = n_experts_padded / ep``.

    Where ``ep`` divides ``L`` each model rank takes its block of the
    sequence, and the outputs are gathered whole over ``model``; else every
    rank routes all tokens, as JAX's replicated ``shard_map`` does, and the
    output's gradient is divided by ``ep`` (the ``ep`` copies' expert
    gradients add to one). Its ``t`` tokens' ``t · k`` (token, choice) rows go
    to the rank of their expert through :func:`~repro_torch.dist.collectives.send_rows`,
    ``cap = t · k · capacity_factor // ep_active`` a destination
    (``ep_active`` the ranks holding a real expert); the rows past it are
    dropped and counted, summed over ``model``. A receiver parks its empty
    slots in its last local expert, sorts the rows by local expert (stably,
    in the order received), computes each expert's rows inside its window
    ``min(total, max(128, 2·total // e_per))`` (``total = ep · cap``; the
    window's start clipped into the rows, :func:`moe_windows`) and zeroes
    the rest and the empty slots; :func:`~repro_torch.dist.collectives.return_rows`
    brings them back, and each token's k rows are weighted in the model's
    type and summed in float32, rounded once. The router and the inputs
    reach this body through ``copy_to_model``, so their gradients are
    summed over the model ranks."""
    ax = mesh.axis(MODEL)
    ep, k = ax.size, c.top_k
    e_per = c.n_experts_padded // ep
    b, l, d = x.shape
    x, weights = copy_to_model(x, mesh), copy_to_model(weights, mesh)
    seq = l % ep == 0
    if seq:
        lo, n = ax.rank * (l // ep), l // ep
        x, weights, sel = x[:, lo:lo + n], weights[:, lo:lo + n], sel[:, lo:lo + n]
    bl, ll = x.shape[:2]
    t = bl * ll
    rows = x.reshape(t, 1, d).expand(t, k, d).reshape(t * k, d)
    expert = sel.reshape(-1)
    ep_active = max(1, -(-c.n_experts // e_per))
    cap = max(1, int(t * k * c.moe_capacity_factor) // ep_active)
    route, overflow = route_rows((expert // e_per).to(torch.int32),
                                 torch.ones_like(expert, dtype=torch.bool), ax, cap)
    received = send_rows(rows, route, ax)
    tag = send_rows((expert + 1).to(torch.int32), route, ax)
    valid = tag > 0
    local_e = torch.where(valid, (tag.long() - 1) % e_per, e_per - 1)
    order = torch.argsort(local_e, stable=True)
    counts = _expert_rows(local_e, e_per)
    total = ep * cap
    window = min(total, max(128, (2 * total) // e_per))
    kept = moe_windows(counts, total, window)
    valid_sorted = valid[order]
    if stats is not None:
        # each expert's rows in sorted order: kept, then past the window
        runs = torch.tensor([m for nk, ne in zip(kept, counts) for m in (nk, ne - nk)],
                            device=valid.device)
        past = torch.arange(runs.shape[0], device=valid.device).remainder(2).bool()
        stats.overflow.append(overflow)
        stats.masked.append((valid_sorted & past.repeat_interleave(
            runs, output_size=total)).sum())
    y = _windowed_experts(lp, received.index_select(0, order), counts, kept)
    y = torch.where(valid_sorted[:, None], y, 0)
    y = y.index_select(0, torch.argsort(order))
    back = return_rows(y, route, ax)
    out = (back * weights.reshape(-1, 1).to(back.dtype)).view(t, k, d).sum(1).view(bl, ll, d)
    if seq:
        return gather_from_model(out, mesh, 1)
    return scale_grad(out, 1.0 / ep)


def _tp(mesh, split, name: str):
    """``mesh`` where the leaf ``name`` splits over ``model`` (``split``
    each leaf's dimension split over it, or ``None``), else ``None``."""
    return mesh if mesh is not None and split[name] is not None else None


def _swiglu_tp(x, wg, wu, wd, tp) -> torch.Tensor:
    """SwiGLU, whole where ``tp`` is ``None``; on the grid mesh ``tp`` with
    ``wg`` / ``wu`` split by columns and ``wd`` by rows over ``model``, the
    partial products summed by ``reduce_from_model``."""
    if tp is None:
        return swiglu(x, wg, wu, wd)
    return reduce_from_model(swiglu(copy_to_model(x, tp), wg, wu, wd), tp)


def _moe_ffn(lp, x, c: TransformerConfig, routed: bool = False, mesh=None, split=None,
             stats: Optional[RoutedStats] = None):
    """``x [B, L, D]`` → the routed experts' SwiGLU plus the shared experts':
    ``_moe_experts`` (JAX without a mesh, as it serves), with ``routed``
    ``_moe_routed`` (JAX on a mesh, as ``_lm_cell`` trains), or on a grid
    ``mesh`` :func:`_moe_routed_ep` (``stats`` its record) and the shared
    experts tensor parallel like the dense SwiGLU. The router is whole."""
    b, l, d = x.shape
    flat = x.reshape(-1, d)
    weights, sel = _moe_route(lp, flat, c)
    if mesh is None:
        out = (_moe_routed if routed else _moe_experts)(lp, flat, weights, sel, c)
    else:
        out = _moe_routed_ep(lp, x, weights.view(b, l, -1), sel.view(b, l, -1), c, mesh,
                             stats).reshape(-1, d)
    if c.n_shared:
        out = out + _swiglu_tp(flat, lp["s_wg"], lp["s_wu"], lp["s_wd"], _tp(mesh, split, "s_wd"))
    return out.view(b, l, d)


# ---------------------------------------------------------------------------
# Layers + model
# ---------------------------------------------------------------------------

def _layer(lp, x, c: TransformerConfig, positions, *, moe: bool, use_kernels: bool,
           cache=None, pos: int = 0, routed: bool = False, mesh=None, split=None,
           stats: Optional[RoutedStats] = None):
    """One block. With ``cache`` (this layer's views: GQA ``(k, v)`` ``[B,
    Hkv, S, Dh]``, MLA ``(c_kv [B, S, kv_lora], k_rope [B, S, qk_rope])``) the
    chunk's entries are written at ``pos … pos + Lq - 1`` in place and the
    queries attend over the whole cache with ``q_offset = pos``: the causal
    mask hides the entries not written yet. ``routed`` picks the MoE sum
    JAX trains with (:func:`_moe_ffn`).

    On a grid ``mesh`` (training; ``split`` each leaf's dimension split over
    ``model`` or ``None``, checked by :func:`_check_heads`) the block is
    tensor parallel over ``model``: this rank's heads from the column-split
    projections (their inputs through ``copy_to_model``), the row-split
    ``wo`` summed over ``model`` in float32 (``reduce_from_model``), MLA's
    ``wq_a`` / ``wkv_a`` (split on a dimension that is not a head) gathered
    whole first, the SwiGLU split over ``d_ff`` the same way, the MoE block
    expert parallel (``stats`` its record)."""
    heads = _tp(mesh, split, "wo")
    f = _same if heads is None else functools.partial(copy_to_model, mesh=heads)
    h = rms_norm(x, lp["attn_norm"])
    if c.attn == "gqa":
        q, k, v = _gqa_qkv(lp, f(h), c, positions)
        if cache is not None:
            ck, cv = cache
            ck[:, :, pos:pos + k.shape[2]] = k
            cv[:, :, pos:pos + v.shape[2]] = v
            k, v = ck, cv
        attn = ops.flash_attention(q, k, v, causal=True, q_offset=pos, use_kernels=use_kernels)
    else:
        if mesh is not None:
            lp = dict(lp, **{n: gather_from_model(lp[n], mesh, split[n])
                             for n in ("wq_a", "wkv_a") if split.get(n) is not None})
        q_nope, q_rope = _mla_q(lp, h, c, positions, f)
        c_kv, k_rope = _mla_kv_latent(lp, h, c, positions)
        if cache is not None:
            cc, cr = cache
            cc[:, pos:pos + c_kv.shape[1]] = c_kv
            cr[:, pos:pos + k_rope.shape[1]] = k_rope
            c_kv, k_rope = cc, cr
        if cache is not None and c.decode_absorbed and q_nope.shape[2] == 1:
            attn = _mla_attention_absorbed(lp, q_nope, q_rope, c_kv, k_rope, c, pos)
        else:
            attn = _mla_attention(lp, q_nope, q_rope, c_kv, k_rope, c, pos,
                                  use_kernels=use_kernels, f=f)
    out = attn.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1) @ lp["wo"]
    x = x + (out if heads is None else reduce_from_model(out, heads))
    h2 = rms_norm(x, lp["mlp_norm"])
    if moe:
        return x + _moe_ffn(lp, h2, c, routed, mesh, split, stats)
    return x + _swiglu_tp(h2, lp["wg"], lp["wu"], lp["wd"], _tp(mesh, split, "wd"))


def _model_dims(c: TransformerConfig, mesh) -> Dict:
    """Each leaf's dimension split over ``model`` under the fixed specs:
    ``embed`` and ``lm_head`` of the whole leaf, a layer group's leaves of
    one layer's slice (the stacked dimension taken off)."""
    out: Dict = {}
    for name, p in lm_placements(c, mesh).items():
        group, _, leaf = name.rpartition("/")
        if group:
            out.setdefault(group, {})[leaf] = None if p.model_dim is None else p.model_dim - 1
        else:
            out[name] = p.model_dim
    return out


def _check_heads(c: TransformerConfig, mesh, dims: Dict) -> None:
    """Raise where the fixed specs would cut an attention head in two, split
    the query heads but not the key / value heads (or the reverse), or leave
    the experts whole on several model ranks: the port does not reshard."""
    m = mesh.shape[MODEL]
    for group, moe, _ in _groups(c):
        split = dims[group]
        leaves = (("wq", "wk", "wv", "wo") if c.attn == "gqa" else
                  ("wq_b" if c.q_lora else "wq", "wk_b", "wv_b", "wo"))
        whole = [n for n in leaves if split[n] is None]
        if whole and len(whole) < len(leaves):
            raise NotImplementedError(
                f"{c.name}: {group}/{whole[0]} is whole while "
                f"{group}/{next(n for n in leaves if n not in whole)} splits over model {m}")
        if not whole:
            if c.n_heads % m:
                raise NotImplementedError(f"{c.name}: {group}/{leaves[0]} would cut a head in "
                                          f"two ({c.n_heads} heads over model {m})")
            if c.attn == "gqa" and c.n_kv_heads % m:
                raise NotImplementedError(f"{c.name}: {group}/wk would cut a head in two "
                                          f"({c.n_kv_heads} kv heads over model {m})")
        if moe and m > 1 and split["e_wg"] is None:
            raise NotImplementedError(f"{c.name}: {group}/e_wg does not split over model {m}")


def _run_layers(params, x, c: TransformerConfig, positions, *, use_kernels: bool,
                caches: Optional[Dict] = None, pos: int = 0):
    """The dense layers, then the MoE layers, each reading its slice of the
    group's stacked ``[L, …]`` parameters (and of its cache)."""
    for group, moe, n in _groups(c):
        stacked = params[group]
        for i in range(n):
            lp = {name: t[i] for name, t in stacked.items()}
            cache = None if caches is None else tuple(t[i] for t in caches[group])
            x = _layer(lp, x, c, positions, moe=moe, use_kernels=use_kernels, cache=cache,
                       pos=pos)
    return x


def _embed(params, tokens, c: TransformerConfig):
    return params["embed"][tokens.long()].to(c.tdtype)


def _logits(params, x):
    return rms_norm(x, params["final_norm"]) @ params["lm_head"]


def _positions(start: int, n: int, device) -> torch.Tensor:
    return torch.arange(start, start + n, device=device)


def forward(params, tokens, c: TransformerConfig, *, use_kernels: bool) -> torch.Tensor:
    """Teacher-forcing forward: tokens ``[B, S]`` → logits ``[B, S, V]``."""
    with torch.inference_mode():
        x = _embed(params, tokens, c)
        x = _run_layers(params, x, c, _positions(0, tokens.shape[1], x.device),
                        use_kernels=use_kernels)
        return _logits(params, x)


def train_forward(params, tokens, c: TransformerConfig, *, use_kernels: bool, mesh=None,
                  stats: Optional[RoutedStats] = None) -> torch.Tensor:
    """Teacher-forcing forward with grad: tokens ``[B, S]`` → logits ``[B,
    S, V]`` (JAX's ``forward`` on ``_lm_cell``'s mesh under
    ``jax.value_and_grad``), GQA or MLA, dense or MoE layers.

    The embedding goes through :func:`ops.gather_rows` (its transpose a
    segment sum into the rows the tokens touch), each layer through
    :func:`_layer` (serving's body, no cache), its attention through the
    differentiable :func:`ops.flash_attention` (MLA's K assembled by slice
    writes, V at its own width), a MoE layer's routed sum through
    :func:`_moe_routed`, as JAX trains (not serving's sum). With
    ``c.remat`` and grad mode on each layer is checkpointed and recomputed
    in the backward, as JAX's ``jax.checkpoint`` of its scan step; the
    recompute reads the same row counts to the host and routes as the
    forward did (a recompute that routed otherwise would save tensors of
    other shapes, and ``checkpoint`` raises). A layer group of ``params``
    may be a list of per-layer dicts instead of stacked ``[L, …]`` tensors,
    so that a caller can take each layer's gradient on its own leaves.

    On a grid ``mesh`` (:class:`~repro_torch.mesh.GridMesh`) ``params`` are
    this rank's shards under the fixed specs and ``tokens`` its batch: the
    embedding split by vocabulary looks up the rank's rows (zeros for the
    others) and sums over ``model``, each layer runs tensor parallel
    (:func:`_layer`; its recompute repeats the layer's collectives and
    exchange), and a vocabulary-split head returns this rank's columns of the logits (its
    loss is ``common.vocab_parallel_cross_entropy``). ``stats`` collects
    the MoE exchange's drops and masked rows.
    """
    b, s = tokens.shape
    ids = tokens.reshape(-1).to(torch.int32)
    dims = None if mesh is None else _model_dims(c, mesh)
    if dims is not None:
        _check_heads(c, mesh, dims)
    if dims is not None and dims["embed"] is not None:
        rows = params["embed"].shape[0]
        local = ids - mesh.coord(MODEL) * rows
        hit = (local >= 0) & (local < rows)
        x = ops.gather_rows(params["embed"], torch.where(hit, local, 0),
                            use_kernels=use_kernels) * hit[:, None].to(params["embed"].dtype)
        x = reduce_from_model(x.view(b, s, -1), mesh).to(c.tdtype)
    else:
        x = ops.gather_rows(params["embed"], ids, use_kernels=use_kernels).view(b, s, -1)
        x = x.to(c.tdtype)
    positions = _positions(0, s, x.device)
    remat = c.remat and torch.is_grad_enabled()
    for group, moe, n in _groups(c):
        layers = params[group]
        for i in range(n):
            lp = layers[i] if isinstance(layers, list) else {k: t[i] for k, t in layers.items()}
            fn = functools.partial(_layer, lp, c=c, positions=positions, moe=moe,
                                   use_kernels=use_kernels, routed=True, mesh=mesh,
                                   split=None if dims is None else dims[group], stats=stats)
            x = (checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)
                 if remat else fn(x))
    if dims is not None and dims["lm_head"] is not None:
        return copy_to_model(rms_norm(x, params["final_norm"]), mesh) @ params["lm_head"]
    return _logits(params, x)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(c: TransformerConfig, batch: int, max_len: int, device="cuda") -> Dict:
    """Zeroed layer-stacked cache in ``c.dtype``, a ``"dense"`` and a
    ``"moe"`` group where the config has such layers: GQA ``(k, v)``, each
    ``[L, B, Hkv, max_len, Dh]``; MLA the latents ``(c_kv [L, B, max_len,
    kv_lora], k_rope [L, B, max_len, qk_rope])``."""
    def group(n):
        if c.attn == "gqa":
            shapes = [(n, batch, c.n_kv_heads, max_len, c.d_head)] * 2
        else:
            shapes = [(n, batch, max_len, c.kv_lora), (n, batch, max_len, c.qk_rope)]
        return tuple(torch.zeros(s, dtype=c.tdtype, device=device) for s in shapes)

    with torch.inference_mode():
        return {g: group(n) for g, _, n in _groups(c)}


def _fill(params, tokens, cache, c: TransformerConfig, pos: int, use_kernels: bool):
    """Run a chunk of tokens at positions ``pos …`` through the layers,
    writing the cache; the last position's logits ``[B, 1, V]``."""
    x = _embed(params, tokens, c)
    x = _run_layers(params, x, c, _positions(pos, tokens.shape[1], x.device),
                    use_kernels=use_kernels, caches=cache, pos=pos)
    return _logits(params, x[:, -1:])


def prefill(params, tokens, cache, c: TransformerConfig, *, use_kernels: bool):
    """Fill the cache with a whole prompt ``[B, S]`` in place; returns
    ``(logits of the last position [B, 1, V], cache)``."""
    with torch.inference_mode():
        return _fill(params, tokens, cache, c, 0, use_kernels), cache


def prefill_chunked(params, tokens, cache, c: TransformerConfig, *, chunk: int = 8192,
                    use_kernels: bool):
    """Chunked prefill: the prompt streams through the cache ``chunk``
    tokens at a time, each chunk attending over the cache with its
    offset. The prompt length must be a multiple of ``chunk`` (or at most
    one chunk). Returns ``(last logits [B, 1, V], cache)``."""
    b, s = tokens.shape
    if s <= chunk:
        return prefill(params, tokens, cache, c, use_kernels=use_kernels)
    if s % chunk:
        raise ValueError(f"prompt length {s} is not a multiple of the chunk {chunk}")
    with torch.inference_mode():
        for pos in range(0, s, chunk):
            logits = _fill(params, tokens[:, pos:pos + chunk], cache, c, pos, use_kernels)
        return logits, cache


def decode_step(params, token, cache, pos: int, c: TransformerConfig, *, use_kernels: bool):
    """One decode step: ``token [B, 1]`` at position ``pos``; writes the
    cache at ``pos`` in place and returns ``(logits [B, 1, V], cache)``."""
    with torch.inference_mode():
        return _fill(params, token, cache, c, pos, use_kernels), cache
