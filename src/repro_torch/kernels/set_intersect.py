"""Padded-set intersection — the CUDA kernel ``csrc/set_intersect.cu``.

Replaces ``repro/kernels/set_intersect.py`` ``set_intersect_pallas``:
``mask[g, i] = a[g, i] ≠ pad ∧ a[g, i] ∈ b[g, :] \\ {pad}``, the
compressed-set intersection of the CC-join. One block per row stages
``b[g, :]`` in shared memory and each thread scans it for its ``a[g, i]``.
Bound by bytes at the engine's shapes. The plain version is
:func:`repro_torch.kernels.ref.set_intersect_ref`.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["set_intersect_cuda"]


def _check(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous() or t.dim() != 2:
        raise ValueError(f"set_intersect: {name} must be a contiguous 2-D int32 CUDA "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on {t.device}")


def set_intersect_cuda(a: torch.Tensor, b: torch.Tensor, pad: int) -> torch.Tensor:
    """mask[g, i] = a[g, i] ≠ pad ∧ a[g, i] ∈ b[g, :] \\ {pad} on the card.

    Raises on anything but contiguous 2-D int32 CUDA tensors with equal
    row counts, and on a row count or width of 2**31 or more (the grid
    has a block per row); an empty input is answered without a launch.
    """
    _check("a", a)
    _check("b", b)
    g, ca = a.shape
    if b.shape[0] != g:
        raise ValueError(f"set_intersect: {g} rows of a vs {b.shape[0]} rows of b")
    cb = b.shape[1]
    out = torch.zeros((g, ca), dtype=torch.bool, device=a.device)
    if g == 0 or ca == 0 or cb == 0:
        return out
    g, ca, cb, pad = (build.int32_arg("set_intersect", k, v)
                      for k, v in (("rows", g), ("ca", ca), ("cb", cb), ("pad", int(pad))))
    lib = build.library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.set_intersect_launch(a.data_ptr(), b.data_ptr(), g, ca, cb, pad,
                                   out.data_ptr(), stream)
    build.check_launch("set_intersect", err)
    set_intersect_cuda.launches += 1
    return out


set_intersect_cuda.launches = 0
