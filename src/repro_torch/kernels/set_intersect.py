"""Padded-set intersection — the CUDA kernel ``csrc/set_intersect.cu``.

Replaces ``repro/kernels/set_intersect.py`` ``set_intersect_pallas``:
``mask[g, i] = a[g, i] ≠ pad ∧ a[g, i] ∈ b[g, :] \\ {pad}``, the
compressed-set intersection of the CC-join, for any rows. The TPU kernel
compares every ``a`` value with every ``b`` value; this kernel checks each
``b`` row for the CompTensors layout (ascending values, then a pad tail)
as it stages it, and searches rows in layout in O(CA log CB): a warp a row
up to 2,048 values of ``b``, a block a row above that (in shared memory
while the row fits, else in global memory). Rows out of
layout are compacted and scanned, so the result is exact on every row.
Bound by bytes. The plain version is
:func:`repro_torch.kernels.ref.set_intersect_ref`;
:func:`repro_torch.kernels.ref.set_intersect_search_ref` mirrors the
kernel's steps.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["set_intersect_cuda", "set_intersect_route"]


def _check(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous() or t.dim() != 2:
        raise ValueError(f"set_intersect: {name} must be a contiguous 2-D int32 CUDA "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on {t.device}")


def set_intersect_route(cb: int, device: torch.device) -> str:
    """The kernel's path for rows of ``cb`` values of ``b`` on ``device``:
    ``"warp"``, ``"shared"`` (a block a row, ``b`` in shared memory) or
    ``"global"`` (a block a row, ``b`` searched in global memory)."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    limits = (ctypes.c_int * 2)()
    err = build.library().set_intersect_limits(index, limits)
    build.check_launch("set_intersect_limits", err)
    return "warp" if cb <= limits[0] else "shared" if cb <= limits[1] else "global"


def set_intersect_cuda(a: torch.Tensor, b: torch.Tensor, pad: int) -> torch.Tensor:
    """mask[g, i] = a[g, i] ≠ pad ∧ a[g, i] ∈ b[g, :] \\ {pad} on the card.

    Raises on anything but contiguous 2-D int32 CUDA tensors with equal
    row counts, and on a row count, width or pad outside int32; an empty
    input is answered without a launch.
    """
    _check("a", a)
    _check("b", b)
    g, ca = a.shape
    if b.shape[0] != g or b.device != a.device:
        raise ValueError(f"set_intersect: {g} rows of a on {a.device} vs {b.shape[0]} rows "
                         f"of b on {b.device}")
    cb = b.shape[1]
    dev = a.device
    if g == 0 or ca == 0 or cb == 0:
        return torch.zeros((g, ca), dtype=torch.bool, device=dev)
    g, ca, cb, pad = (build.int32_arg("set_intersect", k, v)
                      for k, v in (("rows", g), ("ca", ca), ("cb", cb), ("pad", int(pad))))
    out = torch.empty((g, ca), dtype=torch.bool, device=dev)   # the kernel writes every element
    lib = build.library()
    # the current stream's raw handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = lib.set_intersect_launch(a.data_ptr(), b.data_ptr(), g, ca, cb, pad,
                                   out.data_ptr(), dev.index, stream)
    if err:
        build.check_launch("set_intersect", err)
    set_intersect_cuda.launches += 1
    return out


set_intersect_cuda.launches = 0
