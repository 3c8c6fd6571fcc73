"""Plain PyTorch versions of the port's kernels.

Each is the semantic ground truth of its CUDA kernel: the CPU runs them,
and ``chip_smoke.py`` holds each kernel against its plain version on the
card. They are torch twins of ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["set_intersect_ref", "member_probe_ref"]

_BIG = 2**31 - 1
# Rows per slice of the [rows, CA, CB] broadcast compare: bounds the
# transient at 2**28 bools whatever the row count.
_SLICE_CELLS = 1 << 28
# Queries per slice of the binary search: bounds its int32 transients.
_PROBE_SLICE = 1 << 26


def set_intersect_ref(a: torch.Tensor, b: torch.Tensor, pad: int) -> torch.Tensor:
    """mask[g, i] = (a[g, i] != pad) and a[g, i] ∈ {b[g, :]} \\ {pad}.

    Twin of ``repro.kernels.ref.set_intersect_ref``; the row axis is
    sliced so the broadcast compare never exceeds ``_SLICE_CELLS`` cells.
    """
    g, ca = a.shape
    cb = b.shape[1]
    out = torch.zeros((g, ca), dtype=torch.bool, device=a.device)
    if g == 0 or ca == 0 or cb == 0:
        return out
    step = max(1, _SLICE_CELLS // (ca * cb))
    for s in range(0, g, step):
        aa, bb = a[s:s + step], b[s:s + step]
        hit = (aa[:, :, None] == bb[:, None, :]) & (bb[:, None, :] != pad)
        out[s:s + step] = hit.any(dim=-1) & (aa != pad)
    return out


def member_probe_ref(q_hi: torch.Tensor, q_lo: torch.Tensor,
                     t_hi: torch.Tensor, t_lo: torch.Tensor) -> torch.Tensor:
    """out[i] = (q_hi[i], q_lo[i]) ∈ zip(t_hi, t_lo); pad = (-1, -1).

    Twin of ``repro.kernels.ref.member_probe_ref``: a lexicographic
    binary search, so the table must be sorted by (hi, lo) with its pads
    at the tail. The queries are searched ``_PROBE_SLICE`` at a time.
    """
    out = torch.zeros(q_hi.shape, dtype=torch.bool, device=q_hi.device)
    m = t_hi.shape[0]
    if m == 0:
        return out
    pad_t = (t_hi == -1) & (t_lo == -1)
    th = torch.where(pad_t, _BIG, t_hi.to(torch.int32))
    tl = torch.where(pad_t, _BIG, t_lo.to(torch.int32))
    steps = max(1, int(math.ceil(math.log2(m + 1))) + 1)
    flat = out.view(-1)
    q_hi, q_lo = q_hi.reshape(-1), q_lo.reshape(-1)
    for s in range(0, flat.shape[0], _PROBE_SLICE):
        qh = q_hi[s:s + _PROBE_SLICE].to(torch.int32)
        ql = q_lo[s:s + _PROBE_SLICE].to(torch.int32)
        lo = torch.zeros(qh.shape, dtype=torch.int32, device=qh.device)
        hi = torch.full(qh.shape, m, dtype=torch.int32, device=qh.device)
        for _ in range(steps):
            mid = (lo + hi) // 2
            midc = mid.clamp(0, m - 1)
            th_m, tl_m = th[midc], tl[midc]
            less = (th_m < qh) | ((th_m == qh) & (tl_m < ql))
            lo = torch.where(less, mid + 1, lo)
            hi = torch.where(less, hi, mid)
        pos = lo.clamp(0, m - 1)
        found = (th[pos] == qh) & (tl[pos] == ql)
        flat[s:s + _PROBE_SLICE] = found & ~((qh == -1) & (ql == -1))
    return out
