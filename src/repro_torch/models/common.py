"""Shared model substrate: RMS norm, rotary embedding, SwiGLU.

Twin of ``repro/models/common.py`` (``rms_norm``, ``rope``,
``apply_rope``, ``swiglu``); the sharding helpers and the loss stay with
the JAX package until the port trains.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "apply_rope", "swiglu"]


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
