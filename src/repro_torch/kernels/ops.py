"""Dispatch of the port's kernels (twin of ``repro/kernels/ops.py``).

The path follows the tensor's device: a CUDA tensor with
``use_kernels=True`` launches the hand-written kernel; ``use_kernels=False``
runs the plain version (on either device); ``use_kernels=True`` on a CPU
tensor raises. A failed build or launch raises — nothing falls back.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import ref
from .ref import ACC_DTYPE
from .embedding_bag import embedding_bag_cuda
from .flash_attention import flash_attention_cuda
from .member_probe import member_probe_cuda
from .segment_sum import SegmentPlan, segment_plan, segment_sum_cuda
from .set_intersect import set_intersect_cuda

__all__ = ["set_intersect", "member_probe", "segment_sum", "segment_plan", "SegmentPlan",
           "embedding_bag", "flash_attention", "ACC_DTYPE", "launch_counts",
           "reset_launch_counts"]

# kernel name: (wrapper, its attribute that counts the kernel's launches).
# "flash_attention" counts every Lq > 16 call; "flash_attention_tc" the
# ones among them that took the tensor-core kernel.
_COUNTERS = {"member_probe": (member_probe_cuda, "launches"),
             "set_intersect": (set_intersect_cuda, "launches"),
             "segment_sum": (segment_sum_cuda, "launches"),
             "embedding_bag": (embedding_bag_cuda, "launches"),
             "flash_attention": (flash_attention_cuda, "launches"),
             "flash_attention_tc": (flash_attention_cuda, "tc_launches"),
             "flash_decode": (flash_attention_cuda, "decode_launches")}


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


def segment_sum(data: torch.Tensor, seg: torch.Tensor, n: int, *, use_kernels: bool,
                acc: Optional[torch.Tensor] = None,
                plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """``out[s, :] = Σ_{i : seg[i] = s} data[i, :]``; ids outside ``[0, n)``
    are dropped and need not be sorted.

    Sums in ``ACC_DTYPE`` (float64). Without ``acc`` it returns
    ``[n, D]`` in ``data.dtype``; with ``acc`` (``ACC_DTYPE`` ``[n, D]``)
    it adds into that buffer and returns it, so a caller can sum over
    slices of the rows. ``plan``, the :func:`segment_plan` of ``seg``, lets
    a caller that sums by the same ids again build it once; without one the
    kernel path builds it for this call (building a plan is not a launch).
    """
    if acc is not None and (acc.dtype != ACC_DTYPE or tuple(acc.shape) != (n, data.shape[1])):
        raise ValueError(f"segment_sum: acc must be {ACC_DTYPE} [{n}, {data.shape[1]}], "
                         f"got {acc.dtype} {tuple(acc.shape)}")
    if plan is not None:
        plan.check(seg.shape[0], n, seg.device)
    if not _use_kernel(data, use_kernels, "segment_sum"):
        if plan is None:
            return ref.segment_sum_ref(data, seg, n, acc)
        return ref.segment_sum_plan_ref(data, plan, n, acc)
    if plan is None:
        plan = segment_plan(seg, n)
    out = acc if acc is not None else torch.zeros((n, data.shape[1]), dtype=ACC_DTYPE,
                                                  device=data.device)
    segment_sum_cuda(data.contiguous(), plan, out)
    return out if acc is not None else out.to(data.dtype)


def sort_by_bag(indices: torch.Tensor,
                bag_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(indices, bag_ids)`` reordered by a stable sort of the bag ids:
    the embedding-bag kernel's input order (``repro/kernels/ops.py:100``)."""
    bags, order = torch.sort(bag_ids, stable=True)
    return indices[order], bags


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, bag_ids: torch.Tensor,
                  num_bags: int, *, use_kernels: bool) -> torch.Tensor:
    """``out[b, :] = Σ_{i : bag_ids[i] = b} table[indices[i], :]`` in the
    table's type: bags with no rows are zero, bag ids outside
    ``[0, num_bags)`` are dropped, a row index outside ``[0, V)`` makes its
    bag NaN. ``indices`` and ``bag_ids`` are int32 in any order; the kernel
    path sorts them by bag first, as the JAX wrapper does."""
    if not _use_kernel(table, use_kernels, "embedding_bag"):
        return ref.embedding_bag_ref(table, indices, bag_ids, num_bags)
    idx, bags = sort_by_bag(indices, bag_ids)
    return embedding_bag_cuda(table.contiguous(), idx, bags, num_bags)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    q_offset: int = 0, use_kernels: bool) -> torch.Tensor:
    """Grouped-query attention of ``q [B, Hq, Lq, Dh]`` over ``k, v
    [B, Hkv, Lk, Dh]``: query ``i`` sees keys ``j ≤ i + q_offset`` when
    ``causal``. The kernel keeps the TPU kernel's contracts and raises on
    them; the plain version, like the JAX reference, does not."""
    if _use_kernel(q, use_kernels, "flash_attention"):
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=causal, q_offset=q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    """Zero every count."""
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)
