"""Plain PyTorch versions of the port's kernels.

Each is the semantic ground truth of its CUDA kernel: the CPU runs them,
and ``chip_smoke.py`` holds each kernel against its plain version on the
card. They are torch twins of ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["set_intersect_ref", "member_probe_ref", "probe_key", "member_probe_two_level_ref",
           "segment_sum_ref", "segment_sum_plan_ref",
           "embedding_bag_ref",
           "flash_attention_ref", "split_p", "flash_attention_hilo_ref", "split_k_partials",
           "merge_split_k", "ACC_DTYPE"]

_BIG = 2**31 - 1
# Rows per slice of the [rows, CA, CB] broadcast compare: bounds the
# transient at 2**28 bools whatever the row count.
_SLICE_CELLS = 1 << 28
# Queries per slice of the binary search: bounds its int32 transients.
_PROBE_SLICE = 1 << 26
# Cells per slice of the segment sum: bounds its float64 copy of the rows.
_SEGMENT_CELLS = 1 << 26
# Cells per slice of the embedding bag: bounds its float32 copy of the
# gathered rows at 256 MiB.
_BAG_CELLS = 1 << 26
# Score cells (b · hq · rows · lk) per query slice of the plain attention:
# bounds its float32 scores and probabilities at 1 GiB each.
_ATTN_CELLS = 1 << 28
# The segment sum's accumulator type, kernel and plain version alike:
# float64, kept when the kernel became an atomic-free CSR sum. The float64
# sum of m float32 (bfloat16) values is exact while their exponents span
# fewer than 29 - log2(m) (45 - log2(m)) binades, so its rounding to the
# output type almost never depends on the order of the adds. That is what
# lets the plain version (index_add_, whose order no kernel reproduces) and
# the kernel agree within the unchanged limits, and what lets the kernel
# split a heavy segment across threads without changing the result. In
# the CSR kernel the accumulator is written once per segment, so float64
# no longer sets its time. With float32 sums the order decides some
# roundings, and the 16-layer bf16 gatedgcn grows those last-bit flips into
# large differences (PERF.md, PR 12): the kernel-against-plain check and
# gnn_equal would have to be widened.
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


def probe_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit key of int32 lanes: ``hi * 2**32 + (lo ^
    0x80000000)`` as unsigned, so that int64 order is signed lexicographic
    order on ``(hi, lo)``."""
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) + (1 << 31))


def member_probe_two_level_ref(q_hi: torch.Tensor, q_lo: torch.Tensor, t_hi: torch.Tensor,
                               t_lo: torch.Tensor, stride: int) -> torch.Tensor:
    """:func:`member_probe_ref` computed as ``csrc/member_probe.cu`` does it,
    step for step; for tests only.

    The table becomes 64-bit keys (:func:`probe_key`; pads INT64_MAX).
    ``stride = 1``: the fixed-trip search for the last key ``<= q`` over
    all keys, found where it equals ``q``. ``stride = s > 1``: the keys
    padded to whole windows of ``s`` with the key of ``(-1, -1)``, every
    ``s``-th key a fence; the same search over the fences picks a window,
    found where one of its ``s`` keys equals ``q``. A ``(-1, -1)`` query
    is false.
    """
    m = t_hi.shape[0]
    q = probe_key(q_hi, q_lo)
    if m == 0:
        return torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    pad_t = (t_hi == -1) & (t_lo == -1)
    keys = torch.where(pad_t, torch.iinfo(torch.int64).max, probe_key(t_hi, t_lo))
    if stride > 1:
        nf = -(-m // stride)
        none = probe_key(torch.tensor(-1), torch.tensor(-1))
        keys = torch.cat([keys, none.expand(nf * stride - m)])
        search = keys[::stride]
    else:
        search = keys
    base = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    size = search.shape[0]
    while size > 1:   # the last search key <= q: ceil(log2 len) steps
        half = size >> 1
        base = torch.where(search[base + half] <= q, base + half, base)
        size -= half
    if stride > 1:
        window = keys.view(-1, stride)[base]
        hit = (window == q[:, None]).any(1)
    else:
        hit = search[base] == q
    return hit & ~((q_hi == -1) & (q_lo == -1))


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


def segment_sum_plan_ref(data: torch.Tensor, plan, n: int,
                         acc: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`segment_sum_ref` driven by a segment plan
    (``segment_sum.SegmentPlan``) instead of the ids.

    Gathers ``data[plan.order]`` (or takes the rows as they are when the
    plan has no order) over the sorted rows ``[offsets[lo], offsets[hi])``
    and ``index_add_``s them by their sorted ids in :data:`ACC_DTYPE`,
    ``_SEGMENT_CELLS`` cells at a time. The rows of other ids are never
    read. ``acc`` as in :func:`segment_sum_ref`.
    """
    d = data.shape[1]
    plan.check(data.shape[0], n, data.device)
    out = acc if acc is not None else torch.zeros((n, d), dtype=ACC_DTYPE, device=data.device)
    if plan.hi > plan.lo and d > 0:
        lo, hi = plan.lo, plan.hi
        bounds = plan.offsets[lo:hi + 1]
        start, stop = (int(v) for v in bounds[[0, -1]].tolist())
        ids = torch.repeat_interleave(torch.arange(lo, hi, device=data.device), bounds.diff(),
                                      output_size=stop - start)
        step = max(1, _SEGMENT_CELLS // d)
        for s in range(start, stop, step):
            e = min(s + step, stop)
            rows = data[plan.order[s:e].long()] if plan.order is not None else data[s:e]
            out.index_add_(0, ids[s - start:e - start], rows.to(ACC_DTYPE))
    return out if acc is not None else out.to(data.dtype)


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor, bag_ids: torch.Tensor,
                      num_bags: int) -> torch.Tensor:
    """out[b, :] = Σ_{i : bag_ids[i] = b} table[indices[i], :]; bag ids
    outside [0, num_bags) dropped, in any order.

    Twin of ``repro.kernels.ref.embedding_bag_ref`` (``jnp.take`` then
    ``jax.ops.segment_sum``): ``index_select`` then ``index_add_`` in
    float32, ``_BAG_CELLS`` cells of gathered rows at a time, the result in
    the table's type. A row index outside [0, V) makes its bag NaN, as a
    JAX gather fills it (negative indices are not wrapped).
    """
    v, d = table.shape
    out = torch.zeros((num_bags, d), dtype=torch.float32, device=table.device)
    if num_bags > 0 and d > 0:
        step = max(1, _BAG_CELLS // d)
        for s in range(0, indices.shape[0], step):
            idx, bag = indices[s:s + step], bag_ids[s:s + step]
            rows = table.index_select(0, idx.clamp(0, max(v - 1, 0))).float()
            rows.masked_fill_(((idx < 0) | (idx >= v))[:, None], math.nan)
            keep = (bag >= 0) & (bag < num_bags)
            out.index_add_(0, bag.clamp(0, num_bags - 1), rows.masked_fill_(~keep[:, None], 0.0))
    return out.to(table.dtype)


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


# ---------------------------------------------------------------------------
# Mirrors of the attention kernels' algebra (for the tests only): the
# tensor-core kernel's split of P and the decode kernel's split-K merge.
# Both take scores in the log2 domain, s · (1/√Dh · log2 e), as the
# kernels do, and exp2.
# ---------------------------------------------------------------------------

_LOG2E = 1.4426950408889634


def split_p(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core kernel's split of float32 probabilities into bf16
    ``hi = bf16(p)`` and ``lo = bf16(p - hi)``: ``hi + lo`` is ``p`` within
    2⁻¹⁶ · p, where ``hi`` alone errs by up to 2⁻⁹ · p."""
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


def _grouped(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int):
    """Float32 queries as ``[B, Hkv, group·Lq, Dh]`` (head-major, the
    decode kernel's row order) scaled into the log2 domain, the keys'
    transpose, and each row's end of the admitted keys."""
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = torch.tensor(1.0 / math.sqrt(dh) * _LOG2E, dtype=torch.float32)
    qs = q.float().reshape(b, hkv, group * lq, dh)
    rows = torch.arange(group * lq, device=q.device) % lq
    kend = torch.clamp(rows + q_offset + 1, max=lk) if causal else torch.full_like(rows, lk)
    return qs, k.float().transpose(-1, -2), scale, kend


def flash_attention_hilo_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = True, q_offset: int = 0, tile: int = 64,
                             split: bool = True) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain PyTorch: float32
    scores over key tiles of ``tile``, an online softmax, P split by
    :func:`split_p` and ``hi·V + lo·V`` summed in float32, ``l`` summed from
    the float32 p, the output rounded once to q's type. ``split=False``
    rounds P once to bf16 instead (what the kernel does not do)."""
    b, hq, lq, dh = q.shape
    lk = k.shape[2]
    qs, kt, scale, kend = _grouped(q, k, causal, q_offset)
    vf = v.float()
    m = torch.full(qs.shape[:-1], -math.inf)
    l = torch.zeros(qs.shape[:-1])
    acc = torch.zeros(qs.shape)
    for k0 in range(0, lk, tile):
        s = torch.matmul(qs, kt[..., k0:k0 + tile]) * scale
        keys = torch.arange(k0, min(k0 + tile, lk))
        s = s.masked_fill(keys[None, :] >= kend[:, None], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        l = l * corr + p.sum(-1)
        vt = vf[:, :, k0:k0 + tile]
        if split:
            hi, lo = split_p(p)
            pv = torch.matmul(hi.float(), vt) + torch.matmul(lo.float(), vt)
        else:
            pv = torch.matmul(p.to(torch.bfloat16).float(), vt)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = torch.where(l[..., None] > 0, acc / l[..., None], 0.0)
    return out.reshape(b, hq, lq, dh).to(q.dtype)


def split_k_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                     q_offset: int, splits: int, kps: int):
    """The decode kernel's partial states: split ``s`` takes the keys
    ``[s·kps, (s+1)·kps)`` of ``[0, admitted)`` (each row stopping at its
    own causal end) and keeps ``(m, l, acc)`` in float32, ``m`` in the
    log2 domain. A split that admits no key of a row has ``m = -inf``,
    ``l = 0``, ``acc = 0``. Returns ``m, l [B, Hkv, group·Lq, S]`` and
    ``acc [B, Hkv, group·Lq, S, Dh]``."""
    lk = k.shape[2]
    qs, kt, scale, kend = _grouped(q, k, causal, q_offset)
    kmax = min(lk, q_offset + q.shape[2]) if causal else lk
    s = torch.matmul(qs, kt) * scale
    s = s.masked_fill(torch.arange(lk)[None, :] >= kend[:, None], -math.inf)
    ms, ls, accs = [], [], []
    for i in range(splits):
        lo, hi = min(i * kps, kmax), min((i + 1) * kps, kmax)
        si = s[..., lo:hi]
        mi = si.amax(-1) if hi > lo else torch.full(s.shape[:-1], -math.inf)
        p = torch.exp2(si - torch.where(mi == -math.inf, 0.0, mi)[..., None])
        ms.append(mi)
        ls.append(p.sum(-1))
        accs.append(torch.matmul(p, v.float()[:, :, lo:hi]))
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


def merge_split_k(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, shape,
                  dtype: torch.dtype) -> torch.Tensor:
    """The decode kernel's merge of :func:`split_k_partials`: weights
    ``2^(m_s - max m)``, a split with ``m = -inf`` weighing 0, a row with
    no key written as 0; reshaped to ``shape`` ``[B, Hq, Lq, Dh]``."""
    top = m.amax(-1, keepdim=True)
    w = torch.exp2(m - torch.where(top == -math.inf, 0.0, top))
    lsum = (l * w).sum(-1)
    out = (acc * w[..., None]).sum(-2)
    out = torch.where(lsum[..., None] > 0, out / lsum[..., None], 0.0)
    return out.reshape(shape).to(dtype)
