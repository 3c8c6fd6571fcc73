"""Segment sum — the CUDA kernel ``csrc/segment_sum.cu``.

Replaces ``repro/kernels/segment_sum.py`` ``segment_sum_pallas``:
``acc[s, :] += Σ_{i : seg[i] = s} data[i, :]`` for ``0 ≤ s < n``, the
reduction of every GNN aggregation. The TPU kernel is a one-hot matmul per
(segment tile × edge tile); this kernel adds each row into a float64
accumulator (``ref.ACC_DTYPE``) with atomics, so ids need no order and
those outside ``[0, n)`` are dropped. It is bound by the accumulator's read-modify-write
traffic. The plain version is :func:`repro_torch.kernels.ref.segment_sum_ref`.
"""

from __future__ import annotations

import torch

from . import build
from .ref import ACC_DTYPE

__all__ = ["segment_sum_cuda"]

_DTYPES = (torch.float32, torch.bfloat16)


def segment_sum_cuda(data: torch.Tensor, seg: torch.Tensor,
                     acc: torch.Tensor) -> torch.Tensor:
    """Add the rows of ``data`` into ``acc[seg]`` on the card; returns ``acc``.

    ``data``: contiguous ``[E, D]`` float32 or bfloat16; ``seg``:
    contiguous ``[E]`` int32; ``acc``: contiguous ``[n, D]`` float64, all on
    one CUDA device. Raises on anything else; an empty input is answered
    without a launch.
    """
    if (not data.is_cuda or data.dtype not in _DTYPES or data.dim() != 2
            or not data.is_contiguous()):
        raise ValueError(f"segment_sum: data must be a contiguous 2-D float32 or bfloat16 "
                         f"CUDA tensor, got {data.dtype} {tuple(data.shape)} on {data.device}")
    if (seg.device != data.device or seg.dtype != torch.int32 or seg.dim() != 1
            or not seg.is_contiguous() or seg.shape[0] != data.shape[0]):
        raise ValueError(f"segment_sum: seg must be a contiguous [{data.shape[0]}] int32 "
                         f"tensor on {data.device}, got {seg.dtype} {tuple(seg.shape)} "
                         f"on {seg.device}")
    if (acc.device != data.device or acc.dtype != ACC_DTYPE or acc.dim() != 2
            or not acc.is_contiguous() or acc.shape[1] != data.shape[1]):
        raise ValueError(f"segment_sum: acc must be a contiguous [n, {data.shape[1]}] "
                         f"float64 tensor on {data.device}, got {acc.dtype} "
                         f"{tuple(acc.shape)} on {acc.device}")
    rows, d = data.shape
    n = acc.shape[0]
    if rows == 0 or d == 0 or n == 0:
        return acc
    lib = build.library()
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = lib.segment_sum_launch(data.data_ptr(), int(data.dtype == torch.bfloat16),
                                 seg.data_ptr(), rows, d, n, acc.data_ptr(), stream)
    build.check_launch("segment_sum", err)
    segment_sum_cuda.launches += 1
    return acc


segment_sum_cuda.launches = 0
