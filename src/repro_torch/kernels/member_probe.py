"""Sorted-table membership probe — the CUDA kernel ``csrc/member_probe.cu``.

Replaces ``repro/kernels/member_probe.py`` ``member_probe_pallas``: the
engine's edge-existence predicate ``(hi, lo) ∈ E``, with int32 lanes
``(min, max)`` and the pad ``(-1, -1)``. The TPU kernel tiles an all-pairs
compare (O(N·M)); this kernel binary-searches a lexicographically sorted
table with its pads at the tail, which every caller passes
(``pad_partition``'s edge list, the ``dedup_rows`` drop tables, the
delete table). It is bound by bytes: 8 bytes read and 1 written per query.
The plain version is :func:`repro_torch.kernels.ref.member_probe_ref`.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["member_probe_cuda"]


def _check(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous() or t.dim() != 1:
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
    out = torch.zeros(n, dtype=torch.bool, device=q_hi.device)
    if n == 0 or m == 0:
        return out
    m = build.int32_arg("member_probe", "table rows", m)
    lib = build.library()
    stream = torch.cuda.current_stream(q_hi.device).cuda_stream
    err = lib.member_probe_launch(q_hi.data_ptr(), q_lo.data_ptr(), t_hi.data_ptr(),
                                  t_lo.data_ptr(), n, m, out.data_ptr(), stream)
    build.check_launch("member_probe", err)
    member_probe_cuda.launches += 1
    return out


member_probe_cuda.launches = 0
