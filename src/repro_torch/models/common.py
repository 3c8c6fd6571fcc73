"""Shared model substrate: RMS norm, rotary embedding, SwiGLU, the LM loss.

Twin of ``repro/models/common.py`` (``rms_norm``, ``rope``,
``apply_rope``, ``swiglu``, ``cross_entropy``); the sharding helpers wait
for a mesh.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "apply_rope", "swiglu", "cross_entropy"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / sqrt(mean(x²) + eps) · scale`` in float32, cast back to x's type."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(positions: torch.Tensor, dim: int,
         theta: float = 1e4) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 cos/sin tables of rotary embedding; positions ``[..., L]``
    give ``[..., L, dim / 2]``."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device),
                            exps)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved (even, odd) pairs of ``x [..., L, D]`` (the
    JAX package's layout, not the half-split one); computed in float32
    with the tables, returned in x's type."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    while cos.dim() < x1.dim():
        cos, sin = cos[None], sin[None]
    out1 = x1 * cos - x2 * sin
    out2 = x1 * sin + x2 * cos
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """``(silu(x W_g) ⊙ x W_u) W_d`` with weights in the ``[in, out]`` layout."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# Logits cells (rows x V) a block of cross_entropy converts to float32 at
# once: bounds its float32 transients at 256 MiB each whatever the batch.
_CE_CELLS = 1 << 26


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in float32: logits ``[..., V]``, labels ``[...]``
    integer. The logits are taken to float32 a block of rows at a time,
    forward and backward (:class:`_MeanNLL`): a [8,192, 200,064] bf16 head
    keeps its own 3.3 GB and never a float32 copy or gradient (6.6 GB
    each). Each row's log-sum-exp, label logit and gradient are those of
    the whole-tensor formula."""
    v = logits.shape[-1]
    return _MeanNLL.apply(logits.reshape(-1, v), labels.reshape(-1).long())


class _MeanNLL(torch.autograd.Function):
    """``mean(logsumexp(x) - x[label])`` over rows of ``x [N, V]``; the
    gradient ``g / N · (exp(x - lse) - onehot(label))``, the products in
    float32 and rounded once to x's type, as autograd of the float32
    formula gives it."""

    @staticmethod
    def forward(ctx, x, labels):
        n, v = x.shape
        step = max(1, _CE_CELLS // max(1, v))
        lse = torch.empty(n, dtype=torch.float32, device=x.device)
        ll = torch.empty_like(lse)
        for s in range(0, n, step):
            xf = x[s:s + step].float()
            lse[s:s + step] = torch.logsumexp(xf, dim=-1)
            ll[s:s + step] = xf.gather(-1, labels[s:s + step, None])[:, 0]
        ctx.save_for_backward(x, labels, lse)
        return torch.mean(lse - ll)

    @staticmethod
    def backward(ctx, grad):
        x, labels, lse = ctx.saved_tensors
        n, v = x.shape
        g = grad / n
        out = torch.empty_like(x)
        step = max(1, _CE_CELLS // max(1, v))
        for s in range(0, n, step):
            p = g * torch.exp(x[s:s + step].float() - lse[s:s + step, None])
            p.scatter_add_(-1, labels[s:s + step, None], (-g).expand(p.shape[0], 1))
            out[s:s + step] = p
        return out, None
