"""Decoder-only transformer serving: dense grouped-query attention.

Single-device port of the dense GQA part of ``repro/models/transformer.py``
(RoPE, SwiGLU, layer-stacked ``[L, …]`` parameters), for inference:
``forward`` (teacher forcing), ``prefill``, ``prefill_chunked`` and
``decode_step`` over a layer-stacked KV cache. The attention of every
layer goes through :func:`repro_torch.kernels.ops.flash_attention`, the
hand-written CUDA kernel with ``use_kernels=True`` and its plain version
otherwise; offsets are Python ints, so the kernel serves prefill, chunked
prefill and decode alike. Parameters are a nested dict keyed by the JAX
names, weights in JAX's ``[in, out]`` layout, so the JAX package's
parameters carry across unchanged (``convert.lm_params_from_numpy``).

Every entry point runs under ``torch.inference_mode()``. The serving
functions write the new keys and values into the cache **in place** and
return the same cache object.

MLA attention, mixture-of-experts layers and the sharding specs are not
ported (ROADMAP); configurations that need them raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from .common import apply_rope, rms_norm, rope, swiglu

__all__ = ["TransformerConfig", "param_shapes", "init_params", "forward", "init_cache",
           "prefill", "prefill_chunked", "decode_step"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Twin of ``repro.models.transformer.TransformerConfig``, field for
    field. ``attn_backend``, ``q_chunk``, ``moe_capacity_factor``,
    ``attn_seq_shard`` and ``remat`` steer JAX's compilation and sharding
    and are not read here: the port chooses its attention by
    ``use_kernels=``."""

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
    decode_absorbed: bool = False
    attn_seq_shard: bool = False
    remat: bool = True

    @property
    def tdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_dense if self.moe else 0

    @property
    def n_dense_layers(self) -> int:
        return self.n_layers if not self.moe else self.first_dense

    def param_count(self) -> int:
        """Total parameters, from the shapes."""
        return sum(math.prod(s) for s in _leaves(param_shapes(self)))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet (ROADMAP Queue 1)")


def _dense_layer_shapes(c: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    d, f = c.d_model, c.d_ff
    shapes = {"attn_norm": (d,), "mlp_norm": (d,), "wg": (d, f), "wu": (d, f), "wd": (f, d)}
    shapes.update(_attn_shapes(c))
    return shapes


def _attn_shapes(c: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    if c.attn != "gqa":
        raise _not_ported(f"{c.attn!r} attention")
    d = c.d_model
    return {
        "wq": (d, c.n_heads * c.d_head),
        "wk": (d, c.n_kv_heads * c.d_head),
        "wv": (d, c.n_kv_heads * c.d_head),
        "wo": (c.n_heads * c.d_head, d),
    }


def param_shapes(c: TransformerConfig) -> Dict:
    """The parameter tree's shapes, named as the JAX package names them;
    the layer leaves are stacked ``[L, …]``."""
    if c.n_moe_layers:
        raise _not_ported("the mixture-of-experts layer")
    shapes = {"embed": (c.vocab, c.d_model), "final_norm": (c.d_model,),
              "lm_head": (c.d_model, c.vocab)}
    if c.n_dense_layers:
        shapes["dense"] = {k: (c.n_dense_layers,) + s for k, s in _dense_layer_shapes(c).items()}
    return shapes


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def init_params(c: TransformerConfig, generator: torch.Generator, device="cuda") -> Dict:
    """Random parameters by the JAX ``init_params`` law: norms one; embed
    ``N(0, 1) · 0.02``; lm_head and the layer weights ``N(0, 1) /
    sqrt(fan_in)``, fan_in being a layer weight's first (input) axis. The
    draws, in float32 on ``generator``'s device, differ from ``jax.random``;
    they are taken leaf by leaf in sorted-name order (``dense/…``,
    ``embed``, ``final_norm``, ``lm_head``), then cast to ``c.dtype`` and
    moved to ``device``."""
    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=generator.device).mul_(std)
        return w.to(device=device, dtype=c.tdtype)

    def leaf(name, shape, fan_in):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=c.tdtype, device=device)
        return normal(shape, 1.0 / math.sqrt(fan_in))

    shapes = param_shapes(c)
    params = {}
    for key in sorted(shapes):
        if key == "dense":
            params[key] = {n: leaf(n, s, s[-2] if len(s) >= 3 else s[-1])
                           for n, s in sorted(shapes[key].items())}
        elif key == "embed":
            params[key] = normal(shapes[key], 0.02)
        else:
            params[key] = leaf(key, shapes[key], c.d_model)
    return params


# ---------------------------------------------------------------------------
# Layers + model
# ---------------------------------------------------------------------------

def _gqa_qkv(lp, x, c: TransformerConfig, positions):
    b, l, _ = x.shape
    q = (x @ lp["wq"]).view(b, l, c.n_heads, c.d_head)
    k = (x @ lp["wk"]).view(b, l, c.n_kv_heads, c.d_head)
    v = (x @ lp["wv"]).view(b, l, c.n_kv_heads, c.d_head)
    cos, sin = rope(positions, c.d_head, c.rope_theta)
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    return q, k, v.transpose(1, 2)


def _layer(lp, x, c: TransformerConfig, positions, *, use_kernels: bool, cache=None,
           pos: int = 0):
    """One dense GQA block. With ``cache`` (this layer's ``(k, v)`` views
    ``[B, Hkv, S, Dh]``) the chunk's keys and values are written at
    ``pos … pos + Lq - 1`` in place and the queries attend over the whole
    cache with ``q_offset = pos``: the causal mask hides the entries not
    written yet."""
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = _gqa_qkv(lp, h, c, positions)
    if cache is not None:
        ck, cv = cache
        ck[:, :, pos:pos + k.shape[2]] = k
        cv[:, :, pos:pos + v.shape[2]] = v
        k, v = ck, cv
    attn = ops.flash_attention(q, k, v, causal=True, q_offset=pos, use_kernels=use_kernels)
    attn = attn.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
    x = x + attn @ lp["wo"]
    h2 = rms_norm(x, lp["mlp_norm"])
    return x + swiglu(h2, lp["wg"], lp["wu"], lp["wd"])


def _run_layers(params, x, c: TransformerConfig, positions, *, use_kernels: bool,
                caches: Optional[Dict] = None, pos: int = 0):
    """The dense layers in order, each reading its slice of the stacked
    ``[L, …]`` parameters (and of the cache)."""
    stacked = params["dense"]
    for i in range(c.n_dense_layers):
        lp = {name: t[i] for name, t in stacked.items()}
        cache = None if caches is None else (caches["dense"][0][i], caches["dense"][1][i])
        x = _layer(lp, x, c, positions, use_kernels=use_kernels, cache=cache, pos=pos)
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


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(c: TransformerConfig, batch: int, max_len: int, device="cuda") -> Dict:
    """Zeroed layer-stacked KV cache: ``{"dense": (k, v)}``, each
    ``[L, B, Hkv, max_len, Dh]`` in ``c.dtype``."""
    if c.attn != "gqa" or c.n_moe_layers:
        raise _not_ported("a latent (MLA) or mixture-of-experts cache")
    shape = (c.n_dense_layers, batch, c.n_kv_heads, max_len, c.d_head)
    with torch.inference_mode():
        return {"dense": (torch.zeros(shape, dtype=c.tdtype, device=device),
                          torch.zeros(shape, dtype=c.tdtype, device=device))}


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
