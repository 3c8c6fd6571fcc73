"""Dispatch of the port's kernels (twin of ``repro/kernels/ops.py``).

The path follows the tensor's device: a CUDA tensor with
``use_kernels=True`` launches the hand-written kernel; ``use_kernels=False``
runs the plain version (on either device); ``use_kernels=True`` on a CPU
tensor raises. A failed build or launch raises — nothing falls back.
:func:`segment_sum`, :func:`gather_rows`, :func:`embedding_bag` and
:func:`flash_attention` are differentiable. The gather's and the
embedding bag's backward are segment sums into the rows the ids touch,
so on the card they launch the ``segment_sum`` kernel; the attention's
backward launches its own kernels, ``flash_attention_bwd`` (in bf16 on
the tensor cores, from the log-sum-exp the forward kept).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import ref
from .ref import ACC_DTYPE
from .embedding_bag import embedding_bag_cuda
from .flash_attention import bwd_route, flash_attention_cuda
from .flash_attention_bwd import flash_attention_bwd_cuda
from .member_probe import member_probe_cuda
from .segment_sum import SegmentPlan, segment_plan, segment_sum_cuda
from .set_intersect import set_intersect_cuda

__all__ = ["set_intersect", "member_probe", "segment_sum", "gather_rows", "segment_plan",
           "SegmentPlan", "embedding_bag", "flash_attention", "ACC_DTYPE", "launch_counts",
           "reset_launch_counts"]

# kernel name: (wrapper, its attribute that counts the kernel's launches).
# "flash_attention" counts every Lq > 16 call; "flash_attention_tc" the
# ones among them that took the tensor-core kernel; "flash_attention_bwd"
# every backward, "flash_attention_bwd_tc" the ones on the tensor cores.
_COUNTERS = {"member_probe": (member_probe_cuda, "launches"),
             "set_intersect": (set_intersect_cuda, "launches"),
             "segment_sum": (segment_sum_cuda, "launches"),
             "embedding_bag": (embedding_bag_cuda, "launches"),
             "flash_attention": (flash_attention_cuda, "launches"),
             "flash_attention_tc": (flash_attention_cuda, "tc_launches"),
             "flash_decode": (flash_attention_cuda, "decode_launches"),
             "flash_attention_bwd": (flash_attention_bwd_cuda, "launches"),
             "flash_attention_bwd_tc": (flash_attention_bwd_cuda, "tc_launches")}


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
                acc: Optional[torch.Tensor] = None, plan: Optional[SegmentPlan] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``out[s, :] = Σ_{i : seg[i] = s} data[i, :]``; ids outside ``[0, n)``
    are dropped and need not be sorted.

    Sums in ``ACC_DTYPE`` (float64). Without ``acc`` it returns
    ``[n, D]`` in ``dtype`` (default ``data.dtype``; ``ACC_DTYPE`` keeps
    the float64 sum); with ``acc`` (``ACC_DTYPE`` ``[n, D]``) it adds into
    that buffer and returns it, so a caller can sum over slices of the
    rows. ``plan``, the :func:`segment_plan` of ``seg``, lets a caller that
    sums by the same ids again build it once; without one the kernel path
    builds it for this call (building a plan is not a launch).

    Without ``acc``, with grad mode on and ``data`` requiring grad, the
    sum is differentiable (:class:`_SegmentSum`): the gradient of
    ``data`` is the gather ``grad[seg]``, zero for dropped ids, in
    ``data``'s type, the transpose ``jax.ops.segment_sum`` has.
    """
    if acc is not None and (acc.dtype != ACC_DTYPE or tuple(acc.shape) != (n, data.shape[1])):
        raise ValueError(f"segment_sum: acc must be {ACC_DTYPE} [{n}, {data.shape[1]}], "
                         f"got {acc.dtype} {tuple(acc.shape)}")
    if plan is not None:
        plan.check(seg.shape[0], n, seg.device)
    if acc is None and torch.is_grad_enabled() and data.requires_grad:
        out = _SegmentSum.apply(data, seg, n, plan, use_kernels)
    else:
        out = _sum64(data, seg, n, use_kernels, acc, plan)
        if acc is not None:
            return out
    return out.to(dtype or data.dtype)


def _sum64(data, seg, n, use_kernels, acc, plan) -> torch.Tensor:
    """The float64 sums added into ``acc`` (zeros when None)."""
    out = acc if acc is not None else torch.zeros((n, data.shape[1]), dtype=ACC_DTYPE,
                                                  device=data.device)
    if not _use_kernel(data, use_kernels, "segment_sum"):
        if plan is None:
            return ref.segment_sum_ref(data, seg, n, out)
        return ref.segment_sum_plan_ref(data, plan, n, out)
    segment_sum_cuda(data.contiguous(), plan if plan is not None else segment_plan(seg, n), out)
    return out


class _SegmentSum(torch.autograd.Function):
    """:func:`segment_sum` as a function of ``data``: the float64 sums;
    backward, the gather of the gradient (cast to ``data``'s type first)
    by the ids, through a zero row for the dropped ones."""

    @staticmethod
    def forward(ctx, data, seg, n, plan, use_kernels):
        ctx.save_for_backward(seg)
        ctx.n, ctx.dtype, ctx.use_kernels = n, data.dtype, use_kernels
        return _sum64(data, seg, n, use_kernels, None, plan)

    @staticmethod
    def backward(ctx, grad):
        (seg,) = ctx.saved_tensors
        _use_kernel(grad, ctx.use_kernels, "segment_sum")
        n = ctx.n
        padded = torch.cat([grad.to(ctx.dtype),
                            grad.new_zeros((1, grad.shape[1]), dtype=ctx.dtype)])
        rows = padded.index_select(0, torch.where((seg >= 0) & (seg < n), seg, n))
        return rows, None, None, None, None


def gather_rows(h: torch.Tensor, idx: torch.Tensor, *, use_kernels: bool,
                plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """``h[idx]`` along the first axis (``idx`` int32 in ``[0, len(h))``).

    With grad mode on and ``h`` requiring grad it is differentiable
    (:class:`_GatherRows`), and its transpose is a segment sum of the rows'
    gradients onto ``h``'s rows through :func:`segment_sum`: the CUDA
    kernel for ``use_kernels=True``, deterministic and summed in float64,
    where autograd's own ``index_select`` backward adds with float
    atomics in ``h``'s type. ``plan`` is the segment plan of the ids that
    sum: those of ``idx``, or of ``idx`` with the rows whose gradient is
    known to be zero set to ``len(h)``, which drops them; without one the
    backward sums into the rows ``idx`` touches only (:func:`_touched_sum`),
    as the LM embedding's 8,192 tokens into its 200,064 rows.
    ``use_kernels=True`` on a CPU tensor raises here too, as in the
    backward.
    """
    _use_kernel(h, use_kernels, "gather_rows")
    if plan is not None:
        plan.check(idx.shape[0], h.shape[0], h.device)
    if torch.is_grad_enabled() and h.requires_grad:
        return _GatherRows.apply(h, idx, plan, use_kernels)
    return h.index_select(0, idx)


class _GatherRows(torch.autograd.Function):
    """:func:`gather_rows` as a function of ``h``."""

    @staticmethod
    def forward(ctx, h, idx, plan, use_kernels):
        ctx.save_for_backward(idx)
        ctx.n, ctx.plan, ctx.use_kernels = h.shape[0], plan, use_kernels
        return h.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        rows = grad.reshape(grad.shape[0], -1)
        if ctx.plan is not None:
            out = segment_sum(rows, idx, ctx.n, use_kernels=ctx.use_kernels, plan=ctx.plan)
        else:
            out = _touched_sum(rows, idx, ctx.n, ctx.use_kernels)
        return out.reshape((ctx.n,) + tuple(grad.shape[1:])), None, None, None


def _touched_sum(rows: torch.Tensor, ids: torch.Tensor, n: int,
                 use_kernels: bool) -> torch.Tensor:
    """``segment_sum(rows, ids, n)`` in ``rows``' type, summed only into the
    rows the ids touch: the ids in ``[0, n)`` are made 0 … u - 1 over their
    u distinct values (``torch.unique``, sorted), summed into a float64
    ``[u, D]`` through :func:`segment_sum` (the kernel on the card), rounded
    once and written into a zero ``[n, D]``. Each touched row's float64 sum
    has the same terms in the same order as the dense sum's, so the result
    is the same; the accumulator is u rows instead of n (a table gradient
    touches a few of its rows)."""
    out = rows.new_zeros((n, rows.shape[1]))
    keep = (ids >= 0) & (ids < n)
    if not bool(keep.all()):
        rows, ids = rows[keep], ids[keep]
    if ids.shape[0] == 0:
        return out
    uniq, compact = torch.unique(ids, sorted=True, return_inverse=True)
    sums = segment_sum(rows, compact.to(torch.int32), uniq.shape[0], use_kernels=use_kernels)
    return out.index_copy_(0, uniq.long(), sums)


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
    path sorts them by bag first, as the JAX wrapper does.

    With grad mode on and ``table`` requiring grad it is differentiable
    (:class:`_EmbeddingBag`): the table's gradient is each lookup's bag
    gradient summed into its row, over the rows the lookups touch
    (:func:`_touched_sum`: the ``segment_sum`` kernel on the card, float64,
    rounded once); lookups of a dropped bag or an out-of-range row add
    nothing, as JAX's gather transposes them."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbeddingBag.apply(table, indices, bag_ids, num_bags, use_kernels)
    return _embedding_bag(table, indices, bag_ids, num_bags, use_kernels)


def _embedding_bag(table, indices, bag_ids, num_bags, use_kernels) -> torch.Tensor:
    if not _use_kernel(table, use_kernels, "embedding_bag"):
        return ref.embedding_bag_ref(table, indices, bag_ids, num_bags)
    idx, bags = sort_by_bag(indices, bag_ids)
    return embedding_bag_cuda(table.contiguous(), idx, bags, num_bags)


class _EmbeddingBag(torch.autograd.Function):
    """:func:`embedding_bag` as a function of the table."""

    @staticmethod
    def forward(ctx, table, indices, bag_ids, num_bags, use_kernels):
        ctx.save_for_backward(indices, bag_ids)
        ctx.shape, ctx.num_bags, ctx.use_kernels = table.shape, num_bags, use_kernels
        return _embedding_bag(table, indices, bag_ids, num_bags, use_kernels)

    @staticmethod
    def backward(ctx, grad):
        indices, bag_ids = ctx.saved_tensors
        _use_kernel(grad, ctx.use_kernels, "embedding_bag")
        v = ctx.shape[0]
        keep = (bag_ids >= 0) & (bag_ids < ctx.num_bags) & (indices >= 0) & (indices < v)
        if not bool(keep.all()):
            indices, bag_ids = indices[keep], bag_ids[keep]
        rows = grad.index_select(0, bag_ids)
        return _touched_sum(rows, indices, v, ctx.use_kernels), None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    q_offset: int = 0, use_kernels: bool) -> torch.Tensor:
    """Grouped-query attention of ``q [B, Hq, Lq, Dqk]`` over ``k [B, Hkv,
    Lk, Dqk]`` and ``v [B, Hkv, Lk, Dv]`` (``Dv ≤ Dqk``; MLA's V at its own
    ``v_head`` width), scores scaled by ``1/√Dqk``: query ``i`` sees keys
    ``j ≤ i + q_offset`` when ``causal``; returns ``[B, Hq, Lq, Dv]``. The
    kernels keep the TPU kernel's contracts and raise on them (and on
    widths :func:`~repro_torch.kernels.flash_attention.flash_attention_cuda`
    does not take); the plain version, like the JAX reference, does not.
    ``use_kernels=True`` on a CPU tensor raises.

    With grad mode on and any input requiring grad it is differentiable
    (:class:`_FlashAttention`): on the card the backward is the
    ``flash_attention_bwd`` kernels (causal, offset 0, ``Lq = Lk``, the
    route :func:`~repro_torch.kernels.flash_attention.bwd_route` names: bf16
    at ``(Dqk, Dv)`` (64, 64), (128, 128) and MLA's (96, 64), (192, 128) on the tensor
    cores, float32 at Dqk = Dv of 64 or 128; it raises on anything else, a
    float32 MLA gradient among them), with ``use_kernels=False`` the plain
    :func:`~repro_torch.kernels.ref.flash_attention_bwd_ref` (any Dv)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, q_offset, use_kernels)
    return _flash_attention(q, k, v, causal, q_offset, use_kernels)


def _flash_attention(q, k, v, causal, q_offset, use_kernels) -> torch.Tensor:
    if _use_kernel(q, use_kernels, "flash_attention"):
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v, causal=causal,
                                    q_offset=q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` as a function of q, k and v (V at its own
    width). The kernel route saves the output, whose ``rowsum(dO ∘ O)`` the
    backward kernel reads, and, where the backward takes the tensor cores,
    the forward kernel's log-sum-exp of each row (under remat, the
    recompute's); the plain backward recomputes everything from q, k and
    v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, use_kernels):
        lse = None
        if (_use_kernel(q, use_kernels, "flash_attention") and causal and q_offset == 0
                and bwd_route(q.dtype, q.shape[-1], v.shape[-1]) == "tc"):
            out, lse = flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                            causal=True, q_offset=0, return_lse=True)
        else:
            out = _flash_attention(q, k, v, causal, q_offset, use_kernels)
        ctx.causal, ctx.q_offset, ctx.use_kernels = causal, q_offset, use_kernels
        ctx.save_for_backward(q, k, v, out if use_kernels else None, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if _use_kernel(dout, ctx.use_kernels, "flash_attention"):
            if not ctx.causal or ctx.q_offset != 0:
                raise NotImplementedError("flash_attention_bwd: the kernel takes causal "
                                          "attention at offset 0 only")
            grads = flash_attention_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                             out, dout.contiguous(), lse)
        else:
            grads = ref.flash_attention_bwd_ref(q, k, v, dout, causal=ctx.causal,
                                                q_offset=ctx.q_offset)
        return (*grads, None, None, None)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    """Zero every count."""
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, 0)
