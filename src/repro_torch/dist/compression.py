"""Gradient compression: error-feedback int8 quantization and a compressed
butterfly all-reduce; twins of ``repro/dist/compression.py`` on a mesh of
the port.

:func:`ef_compress` is the classic error-feedback scheme: the residual of
each quantization step is added back before the next one, so the
*decoded running sum* tracks the true running sum to within one
quantization step; the drift never accumulates.

:func:`butterfly_compressed_all_reduce` is a recursive-doubling
all-reduce that quantizes the payload to int8 (with a per-tensor float32
scale) at every stage: log2(n) hops to the XOR partner, about 4x less wire
traffic, a few percent of error that error feedback absorbs in training.

A tree of gradients is a tensor, or a dict, list or tuple of trees.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["ef_residual_init", "ef_compress", "butterfly_compressed_all_reduce"]


def ef_residual_init(grads):
    """Zero residuals shaped like ``grads`` (float32 accumulators)."""
    if isinstance(grads, dict):
        return {k: ef_residual_init(g) for k, g in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(ef_residual_init(g) for g in grads)
    return torch.zeros(grads.shape, dtype=torch.float32, device=grads.device)


def _quantize(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``t`` to int8 in steps of ``max|t| / 127`` (at least 1e-12), rounded
    half to even as ``jnp.round``; returns ``(q, scale)``."""
    scale = torch.clamp(t.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_compress(grads, residual):
    """Quantize ``grads + residual`` to int8; returns ``(q, scales,
    residual')`` as trees like ``grads``. Decoding is ``q * scale``; the new
    residual is the quantization error, re-injected on the next call."""
    if isinstance(grads, dict):
        parts = {k: ef_compress(grads[k], residual[k]) for k in grads}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(3))
    if isinstance(grads, (list, tuple)):
        parts = [ef_compress(g, r) for g, r in zip(grads, residual)]
        return tuple(type(grads)(p[i] for p in parts) for i in range(3))
    t = grads.to(torch.float32) + residual
    q, scale = _quantize(t)
    return q, scale, t - q.to(torch.float32) * scale


def butterfly_compressed_all_reduce(xs: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Recursive-doubling all-reduce with int8-compressed stages, one value
    a partition of ``mesh``. Each stage exchanges an int8 payload and one
    float32 scale with the XOR partner and accumulates in float32. The
    mesh's size must be a power of two."""
    n = mesh.size
    if n & (n - 1):
        raise ValueError("butterfly all-reduce needs a power-of-two device count")
    acc = [x.to(torch.float32) for x in xs]
    stage = 1
    while stage < n:
        perm = [(i, i ^ stage) for i in range(n)]
        qs, scales = zip(*(_quantize(a) for a in acc))
        qr = mesh.ppermute(list(qs), perm)
        sr = mesh.ppermute([s.reshape(1) for s in scales], perm)
        # accumulate the *quantized* local value, not acc itself: both
        # partners then compute the same sum, so every partition ends the
        # butterfly with the same tensor
        acc = [q.to(torch.float32) * s + r.to(torch.float32) * t[0]
               for q, s, r, t in zip(qs, scales, qr, sr)]
        stage <<= 1
    return [a.to(x.dtype) for a, x in zip(acc, xs)]
