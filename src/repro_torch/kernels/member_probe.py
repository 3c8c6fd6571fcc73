"""Sorted-table membership probe — the CUDA kernel ``csrc/member_probe.cu``.

Replaces ``repro/kernels/member_probe.py`` ``member_probe_pallas``: the
engine's edge-existence predicate ``(hi, lo) ∈ E``, with int32 lanes
``(min, max)`` and the pad ``(-1, -1)``. The TPU kernel tiles an all-pairs
compare (O(N·M)); this kernel searches a lexicographically sorted table
with its pads at the tail, which every caller passes (``pad_partition``'s
edge list, the ``dedup_rows`` drop tables, the delete table), as 64-bit
keys. A table of at most :data:`SMEM_KEYS` rows is searched whole in shared
memory; a larger one in two levels: every ``s``-th key (a fence, at most
:data:`MAX_FENCES` of them) in shared memory, then one window of ``s``
keys in L2, or, for fewer queries than rows, whole in global memory
(:func:`probe_stride` picks ``s``). It is bound by bytes: 8
bytes read and 1 written per query. The plain version is
:func:`repro_torch.kernels.ref.member_probe_ref`;
:func:`repro_torch.kernels.ref.member_probe_two_level_ref` mirrors the
kernel's search step for step.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["member_probe_cuda", "probe_stride", "SMEM_KEYS", "MAX_FENCES"]

# The kernel's limits (csrc/member_probe.cu kSmemKeys, kMaxFences): 64 KiB
# of shared memory each.
SMEM_KEYS = 8192
MAX_FENCES = 8192


def probe_stride(m: int, n: int) -> int:
    """Rows per window for ``n`` queries against an ``m``-row table: 1 (one
    search over all keys: in shared memory up to :data:`SMEM_KEYS` rows,
    else in global memory while the queries are fewer than the rows), else
    the least power of two that leaves at most :data:`MAX_FENCES` fences
    (16 for 116,669 rows)."""
    if m <= SMEM_KEYS or n < m:
        return 1
    s = 2
    while -(-m // s) > MAX_FENCES:
        s *= 2
    return s


def _check(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous() or t.ndim != 1:
        raise ValueError(f"member_probe: {name} must be a contiguous 1-D int32 CUDA "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on {t.device}")


def member_probe_cuda(q_hi: torch.Tensor, q_lo: torch.Tensor,
                      t_hi: torch.Tensor, t_lo: torch.Tensor) -> torch.Tensor:
    """out[i] = (q_hi[i], q_lo[i]) ∈ zip(t_hi, t_lo) on the card.

    Precondition: ``(t_hi, t_lo)`` sorted lexicographically with the
    ``(-1, -1)`` pads last. Raises on anything but contiguous 1-D int32
    CUDA tensors and on a table of 2**31 rows or more; an empty query or
    table is answered without a launch.
    """
    for name, t in (("q_hi", q_hi), ("q_lo", q_lo), ("t_hi", t_hi), ("t_lo", t_lo)):
        _check(name, t)
    n, m = q_hi.shape[0], t_hi.shape[0]
    if q_lo.shape[0] != n or t_lo.shape[0] != m:
        raise ValueError("member_probe: hi/lo lanes differ in length")
    dev = q_hi.device
    if n == 0 or m == 0:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    m = build.int32_arg("member_probe", "table rows", m)
    out = torch.empty(n, dtype=torch.bool, device=dev)   # the kernel writes every element
    s = probe_stride(m, n)
    scratch = None
    if s > 1:   # packed keys in whole windows, then the fences
        nf = -(-m // s)
        scratch = torch.empty(nf * s + nf, dtype=torch.int64, device=dev)
    lib = build.library()
    # the current stream's raw handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = lib.member_probe_launch(q_hi.data_ptr(), q_lo.data_ptr(), t_hi.data_ptr(),
                                  t_lo.data_ptr(), n, m, s,
                                  None if scratch is None else scratch.data_ptr(),
                                  out.data_ptr(), dev.index, stream)
    if err:
        build.check_launch("member_probe", err)
    member_probe_cuda.launches += 1
    return out


member_probe_cuda.launches = 0
