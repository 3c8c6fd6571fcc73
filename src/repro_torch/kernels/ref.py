"""Plain PyTorch versions of the port's kernels.

Each is the semantic ground truth of its CUDA kernel: the CPU runs them,
and ``chip_smoke.py`` holds each kernel against its plain version on the
card. They are torch twins of ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["set_intersect_ref", "member_probe_ref", "segment_sum_ref", "flash_attention_ref",
           "ACC_DTYPE"]

_BIG = 2**31 - 1
# Rows per slice of the [rows, CA, CB] broadcast compare: bounds the
# transient at 2**28 bools whatever the row count.
_SLICE_CELLS = 1 << 28
# Queries per slice of the binary search: bounds its int32 transients.
_PROBE_SLICE = 1 << 26
# Cells per slice of the segment sum: bounds its float64 copy of the rows.
_SEGMENT_CELLS = 1 << 26
# Score cells (b · hq · rows · lk) per query slice of the plain attention:
# bounds its float32 scores and probabilities at 1 GiB each.
_ATTN_CELLS = 1 << 28
# The segment sum's accumulator type, kernel and plain version alike. The
# float64 sum of m float32 (bfloat16) values is exact while their exponents
# span fewer than 29 - log2(m) (45 - log2(m)) binades, so its rounding to the
# output type almost never depends on the order of the adds: the kernel's
# atomics and index_add_ give the same output, run after run. With float32
# sums the order decides some roundings, and the 16-layer bf16 gatedgcn
# grows those last-bit flips into large differences (PERF.md). Float32 is
# the function's own accumulator type. Float64 stays until the segment-sum
# kernel is redesigned for this card; the redesign chooses between a
# deterministic float32 CSR sum and float64, with a check that both paths
# share (ROADMAP Queue 2 item 3).
ACC_DTYPE = torch.float64


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


def segment_sum_ref(data: torch.Tensor, seg: torch.Tensor, n: int,
                    acc: torch.Tensor | None = None) -> torch.Tensor:
    """out[s, :] = Σ_{i : seg[i] = s} data[i, :]; ids outside [0, n) dropped.

    Twin of ``repro.kernels.ref.segment_sum_ref`` (``jax.ops.segment_sum``,
    which drops negative ids too). Ids need not be sorted. The rows are
    summed in :data:`ACC_DTYPE` with ``index_add_``, ``_SEGMENT_CELLS``
    cells at a time. Without ``acc`` the result is cast to ``data.dtype``;
    with ``acc`` (``ACC_DTYPE`` ``[n, D]``) the sums are added into it and
    it is returned as it is.
    """
    d = data.shape[1]
    out = acc if acc is not None else torch.zeros((n, d), dtype=ACC_DTYPE, device=data.device)
    if n > 0 and d > 0:
        step = max(1, _SEGMENT_CELLS // d)
        for s in range(0, data.shape[0], step):
            ids = seg[s:s + step]
            keep = (ids >= 0) & (ids < n)
            rows = torch.where(keep[:, None], data[s:s + step].to(ACC_DTYPE), 0.0)
            out.index_add_(0, ids.clamp(0, n - 1), rows)
    return out if acc is not None else out.to(data.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Grouped-query attention: query ``i`` of head ``h`` attends to keys
    ``j ≤ i + q_offset`` (all keys if not ``causal``) of KV head
    ``h // (Hq / Hkv)``. q: ``[B, Hq, Lq, Dh]``, k, v: ``[B, Hkv, Lk, Dh]``.

    Twin of ``repro.kernels.ref.flash_attention_ref``: scores, softmax and
    sums in float32, the output in q's type. The query axis is taken
    ``_ATTN_CELLS // (B · Hq · Lk)`` rows at a time, so the score
    transient stays bounded whatever the prompt length.
    """
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = hq // hkv
    kt = k.float().transpose(-1, -2)       # [B, Hkv, Dh, Lk]
    vf = v.float()
    root = torch.sqrt(torch.tensor(float(dh), dtype=torch.float32, device=q.device))
    qg = q.reshape(b, hkv, group, lq, dh)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    step = max(1, _ATTN_CELLS // max(1, b * hq * lk))
    for s in range(0, lq, step):
        rows = min(step, lq - s)
        qs = qg[:, :, :, s:s + rows].float().reshape(b, hkv, group * rows, dh)
        logits = (torch.matmul(qs, kt) / root).view(b, hkv, group, rows, lk)
        if causal:
            qpos = torch.arange(s, s + rows, device=q.device)[:, None] + q_offset
            kpos = torch.arange(lk, device=q.device)[None, :]
            logits.masked_fill_(kpos > qpos, -math.inf)
        probs = torch.softmax(logits, dim=-1).view(b, hkv, group * rows, lk)
        out[:, :, s:s + rows] = torch.matmul(probs, vf).view(b, hq, rows, dh).to(q.dtype)
    return out
