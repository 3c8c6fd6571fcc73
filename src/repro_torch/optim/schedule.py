"""Learning-rate schedules (copy of ``repro/optim/schedule.py``)."""

from __future__ import annotations

import math
from typing import Union

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(step: Union[int, float, torch.Tensor], *, peak: float, warmup: int,
                  total: int, floor: float = 0.0) -> Union[float, torch.Tensor]:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor`` at ``total``, in float32 as JAX computes it. A tensor step
    gives a 0-d float32 tensor on its device; a Python step a Python float."""
    s = (step if isinstance(step, torch.Tensor) else torch.tensor(step)).to(torch.float32)
    warm = peak * s / max(warmup, 1)
    progress = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * progress))
    out = torch.where(s < warmup, warm, cos)
    return out if isinstance(step, torch.Tensor) else float(out)
