"""Dispatch of the engine's two kernels (twin of ``repro/kernels/ops.py``).

The path follows the tensor's device: a CUDA tensor with
``use_kernels=True`` launches the hand-written kernel; ``use_kernels=False``
runs the plain version (on either device); ``use_kernels=True`` on a CPU
tensor raises. A failed build or launch raises — nothing falls back.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import ref
from .member_probe import member_probe_cuda
from .set_intersect import set_intersect_cuda

__all__ = ["set_intersect", "member_probe", "launch_counts", "reset_launch_counts"]

_KERNELS = {"member_probe": member_probe_cuda, "set_intersect": set_intersect_cuda}


def _use_kernel(t: torch.Tensor, use_kernels: bool, name: str) -> bool:
    if not use_kernels:
        return False
    if not t.is_cuda:
        raise ValueError(f"{name}: use_kernels=True needs CUDA tensors, got {t.device}")
    return True


def set_intersect(a: torch.Tensor, b: torch.Tensor, *, pad: int,
                  use_kernels: bool) -> torch.Tensor:
    """``mask[g, i] = a[g, i] ≠ pad ∧ a[g, i] ∈ b[g, :] \\ {pad}``."""
    if _use_kernel(a, use_kernels, "set_intersect"):
        return set_intersect_cuda(a.contiguous(), b.contiguous(), pad)
    return ref.set_intersect_ref(a, b, pad)


def member_probe(q_hi: torch.Tensor, q_lo: torch.Tensor, t_hi: torch.Tensor,
                 t_lo: torch.Tensor, *, use_kernels: bool) -> torch.Tensor:
    """``out[i] = (q_hi[i], q_lo[i]) ∈ zip(t_hi, t_lo)`` over a lex-sorted
    PAD-tailed table."""
    if _use_kernel(q_hi, use_kernels, "member_probe"):
        return member_probe_cuda(q_hi.contiguous(), q_lo.contiguous(),
                                 t_hi.contiguous(), t_lo.contiguous())
    return ref.member_probe_ref(q_hi, q_lo, t_hi, t_lo)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
