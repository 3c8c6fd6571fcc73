"""Segment sum — the CUDA kernel ``csrc/segment_sum.cu`` and its plan.

Replaces ``repro/kernels/segment_sum.py`` ``segment_sum_pallas``:
``acc[s, :] += Σ_{i : seg[i] = s} data[i, :]`` for ``0 ≤ s < n``, the
reduction of every GNN aggregation. The TPU kernel takes sorted ids; here
the ids become a :class:`SegmentPlan` once (:func:`segment_plan`: a stable
argsort and a ``searchsorted`` in plain PyTorch, as the JAX wrapper sorts
outside Pallas), and the kernel sums each segment's rows in float64
(``ref.ACC_DTYPE``), one owner thread per (segment, column group), with
no atomics. Ids outside ``[0, n)`` sort outside ``[offsets[0],
offsets[n])`` and are dropped. The plain versions are
:func:`repro_torch.kernels.ref.segment_sum_ref` (from the ids) and
:func:`repro_torch.kernels.ref.segment_sum_plan_ref` (from a plan).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import build
from .ref import ACC_DTYPE

__all__ = ["SegmentPlan", "segment_plan", "segment_sum_cuda", "CHUNK_ROWS", "MAX_PARTS"]

_DTYPES = (torch.float32, torch.bfloat16)
# A segment of more than CHUNK_ROWS rows is heavy: the kernel sums it in
# up to MAX_PARTS parts of at least CHUNK_ROWS rows each, then adds the
# parts in order, so that a hub does not serialise on one thread.
CHUNK_ROWS = 256
MAX_PARTS = 4096
# The combining kernel's grid has a block row per 32 columns (grid.y).
_MAX_D = 32 * 65535
# Threads per (heavy part, column): enough that a part of narrow rows
# (d = 1, 3) is summed by about 32 threads, as a 32-column part is.
_PIECE_COLS = 32


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """The rows of one set of ids in segment order.

    ``order``: ``[rows]`` int32, a stable argsort of the ids, or None when
    they are already ascending. ``offsets``: ``[n + 1]`` int64; segment
    ``s`` owns the sorted rows ``[offsets[s], offsets[s + 1])``; ids below
    0 sort before ``offsets[0]``, ids ``≥ n`` after ``offsets[n]``.
    ``lo``, ``hi``: the first and one-past-last segment with rows (equal
    when none has any). ``heavy``: int32 ids of the segments of more than
    :data:`CHUNK_ROWS` rows, ascending; ``parts``: ``[len(heavy) + 1]``
    int64 prefix of their part counts, ``n_parts`` its last value;
    ``chunk``: the :data:`CHUNK_ROWS` they were split by.
    """

    order: Optional[torch.Tensor]
    offsets: torch.Tensor
    lo: int
    hi: int
    rows: int
    heavy: torch.Tensor
    parts: torch.Tensor
    n_parts: int
    chunk: int = CHUNK_ROWS

    @property
    def n(self) -> int:
        return self.offsets.shape[0] - 1

    def check(self, rows: int, n: int, device: torch.device) -> None:
        """Raise unless this plan was built for ``rows`` ids over ``n``
        segments on ``device``."""
        if self.rows != rows or self.n != n:
            raise ValueError(f"segment_sum: the plan was built for {self.rows} ids over "
                             f"{self.n} segments, not {rows} over {n}")
        if self.offsets.device != torch.device(device):
            raise ValueError(f"segment_sum: the plan lies on {self.offsets.device}, "
                             f"the data on {device}")


def segment_plan(seg: torch.Tensor, n: int) -> SegmentPlan:
    """The :class:`SegmentPlan` of the ids ``seg`` (``[rows]`` int32, any
    order) over ``n`` segments, on ``seg``'s device.

    Sorts (stable) unless the ids are ascending, finds each segment's
    first row with ``searchsorted``, and reads ``lo``, ``hi`` and the
    heavy segments' count back to the host. Raises where a row index would
    not fit the kernel's int32 ``order``.
    """
    if seg.dim() != 1 or seg.dtype != torch.int32:
        raise ValueError(f"segment_plan: ids must be 1-D int32, got {seg.dtype} "
                         f"{tuple(seg.shape)}")
    if n < 0:
        raise ValueError(f"segment_plan: n must be >= 0, got {n}")
    rows, dev, chunk = seg.shape[0], seg.device, CHUNK_ROWS
    seg = seg.contiguous()
    ascending = rows < 2 or bool((seg[1:] >= seg[:-1]).all())
    if ascending:
        order, keys = None, seg
    else:
        build.int32_arg("segment_sum", "rows", rows)
        keys, idx = torch.sort(seg, stable=True)
        order = idx.to(torch.int32)
        del idx
    if n >= 2**31 - 1:  # n itself is a boundary: search in int64
        keys = keys.long()
    offsets = torch.searchsorted(keys, torch.arange(n + 1, dtype=keys.dtype, device=dev))
    del keys
    counts = offsets.diff()
    has = counts > 0
    big = counts > chunk
    if n > 0:
        lo_t, hi_t = has.int().argmax(), n - has.flip(0).int().argmax()
        stats = torch.stack([has.any().long(), lo_t, hi_t, big.sum()]).tolist()
    else:
        stats = [0, 0, 0, 0]
    any_rows, lo, hi, n_heavy = stats
    if not any_rows:
        lo = hi = 0
    if n_heavy:
        heavy = big.nonzero().flatten()
        n_part = ((counts[heavy] + chunk - 1) // chunk).clamp_max(MAX_PARTS)
        parts = torch.cat([n_part.new_zeros(1), n_part.cumsum(0)])
        heavy, n_parts = heavy.to(torch.int32), int(parts[-1])
    else:
        heavy = torch.zeros(0, dtype=torch.int32, device=dev)
        parts = torch.zeros(1, dtype=torch.int64, device=dev)
        n_parts = 0
    return SegmentPlan(order, offsets, int(lo), int(hi), rows, heavy, parts, n_parts, chunk)


def segment_sum_cuda(data: torch.Tensor, plan: SegmentPlan,
                     acc: torch.Tensor) -> torch.Tensor:
    """Add the rows of ``data`` into ``acc`` by ``plan`` on the card;
    returns ``acc``.

    ``data``: contiguous ``[rows, D]`` float32 or bfloat16; ``plan``: the
    :func:`segment_plan` of the rows' ids over ``n`` segments; ``acc``:
    contiguous ``[n, D]`` float64, all on one CUDA device. Only the rows
    ``[plan.lo, plan.hi)`` of ``acc`` are written. Raises on anything
    else; a plan without rows is answered without a launch.
    """
    if (not data.is_cuda or data.dtype not in _DTYPES or data.dim() != 2
            or not data.is_contiguous()):
        raise ValueError(f"segment_sum: data must be a contiguous 2-D float32 or bfloat16 "
                         f"CUDA tensor, got {data.dtype} {tuple(data.shape)} on {data.device}")
    if (acc.device != data.device or acc.dtype != ACC_DTYPE or acc.dim() != 2
            or not acc.is_contiguous() or acc.shape[1] != data.shape[1]):
        raise ValueError(f"segment_sum: acc must be a contiguous [n, {data.shape[1]}] "
                         f"float64 tensor on {data.device}, got {acc.dtype} "
                         f"{tuple(acc.shape)} on {acc.device}")
    rows, d = data.shape
    plan.check(rows, acc.shape[0], data.device)
    if d > _MAX_D:
        raise ValueError(f"segment_sum: d={d} exceeds {_MAX_D}")
    if plan.hi <= plan.lo or d == 0:
        return acc
    split = max(1, _PIECE_COLS // d)
    partial = (torch.empty((plan.n_parts * split, d), dtype=ACC_DTYPE, device=data.device)
               if plan.n_parts else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = build.library()
    dev = data.device.index
    # the current stream's raw handle: torch.cuda.current_stream(dev).cuda_stream
    # without building a Stream object, which costs more host time than a
    # small launch takes on the card
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = lib.segment_sum_launch(
        data.data_ptr(), int(data.dtype == torch.bfloat16), d, ptr(plan.order),
        plan.offsets.data_ptr(), plan.lo, plan.hi, plan.chunk, plan.heavy.data_ptr(),
        plan.parts.data_ptr(), plan.heavy.shape[0], plan.n_parts, split, ptr(partial),
        acc.data_ptr(), dev, stream)
    build.check_launch("segment_sum", err)
    segment_sum_cuda.launches += 1
    return acc


segment_sum_cuda.launches = 0
