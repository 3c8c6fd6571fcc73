"""Flash attention — three CUDA kernels behind one wrapper.

Replaces ``repro/kernels/flash_attention.py`` ``flash_attention_pallas``:
grouped-query attention, causal or not, with a query offset (query ``i``
sees keys ``j ≤ i + q_offset``), float32 softmax and sums, the output in
q's type. V may be narrower than Q and K (MLA: ``Dv = v_head`` under
``Dqk = qk_nope + qk_rope``, as JAX's model reference takes it). :func:`route`
picks the kernel from Lq, the type and the widths alone:

- ``"decode"`` — ``Lq ≤ 16`` (:data:`DECODE_ROWS`), float32 or bf16:
  ``csrc/flash_decode.cu``. Bound by bytes. The grid is (b·hkv · row
  chunks, splits): a block holds every query row of its KV head (up to 8)
  and streams its split of the keys once, so each K/V byte crosses HBM
  once per call; the last split to finish merges the splits' float32
  ``(m, l, acc)`` (one launch). Its tickets and workspace are kept per
  (device, stream), so calls on different streams never share them.
  :func:`decode_rows` and :func:`plan_splits` size the grid to one wave of
  the card's resident blocks. Counted in
  ``flash_attention_cuda.decode_launches``.
- ``"tc"`` — ``Lq > 16``, bf16, ``(Dqk, Dv)`` in :data:`TC_WIDTHS` ((64, 64),
  (128, 128) and MLA's (96, 64) and (192, 128)): ``csrc/flash_attention_tc.cu``.
  Bound by operations. ``S = Q·Kᵀ`` over Dqk and ``O += P·V`` over V's own
  Dv columns on the tensor cores (``wgmma``) in three free-running
  consumer warpgroups, K/V tiles loaded by TMA from a producer warpgroup
  into a ring of four stages (three at (192, 128), for shared memory; its
  tensor maps made per call with ``cuTensorMapEncodeTiled``), the online
  softmax in float32 registers. P is split into bf16 ``hi + lo`` and both
  products summed: one bf16 rounding of P would break the float32
  reference's limit (the source says by how much), the split keeps it at
  ``2·Dqk + 4·Dv`` tensor-core FLOP per admitted pair instead of ``2·Dqk +
  2·Dv``. Counted in ``launches`` and ``tc_launches``. Asked with
  ``return_lse=True`` (the training forward, at the widths of
  :data:`BWD_WIDTHS`) it also writes each row's log-sum-exp, in the log2
  domain of its scaled scores, for the backward's tensor-core route; such a
  call takes this kernel at any Lq.
- ``"simt"`` — the other ``Lq > 16`` calls (float32, the models' float32
  gates; bf16 at other widths, which no model has):
  ``csrc/flash_attention.cu``, a 64-row tile on the float32 CUDA cores.
  Counted in ``launches``.

``"decode"`` and ``"simt"`` are built for one width: there a narrower V is
zero-padded to Dqk by this wrapper (one ``F.pad``) and their output sliced
back to Dv, so the zero columns cost bytes and FLOP on those routes only.

The backward's route, :func:`bwd_route`, is ``"tc"`` (bf16, ``(Dqk, Dv)``
in :data:`BWD_WIDTHS`: (64, 64), (128, 128) and MLA's (96, 64) and (192, 128);
``csrc/flash_attention_bwd_tc.cu``, from the forward's log-sum-exp) or
``"simt"`` (float32, Dqk = Dv of 64 or 128: ``csrc/flash_attention_bwd.cu``).

The plain version is :func:`repro_torch.kernels.ref.flash_attention_ref`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import build

__all__ = ["flash_attention_cuda", "check_contract", "route", "bwd_route", "lse_row_stride",
           "plan_splits", "decode_rows", "decode_slots", "kernel_attributes"]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HEAD_DIM = 256
_MAX_GRID_Y = 65_535
DECODE_ROWS = 16  # Lq up to this takes the decode kernel
# bf16 (Dqk, Dv) the tensor-core forward is built for (its log-sum-exp at
# each), and those the tensor-core backward is built for; the float32
# backward takes Dqk = Dv of BWD_SIMT_DIMS
TC_WIDTHS = ((64, 64), (128, 128), (96, 64), (192, 128))
BWD_WIDTHS = ((64, 64), (128, 128), (96, 64), (192, 128))
BWD_SIMT_DIMS = (64, 128)
LSE_ROW_ALIGN = 64  # the log-sum-exp's rows: whole boxes of the backward's TMA loads
DECODE_BLOCK_ROWS = 8  # query rows a decode block holds at most
DECODE_MIN_KEYS = 256  # keys a split takes at least


def check_contract(lq: int, lk: int, *, causal: bool, q_offset: int) -> None:
    """The TPU kernel's two contracts (``flash_attention_pallas``): KV
    padding is only defined under the causal mask, and causal queries may
    not reach past the last key."""
    if lk == 0:
        raise ValueError("flash_attention: no keys (lk = 0)")
    if not causal and lk % min(128, lk):
        raise NotImplementedError("non-causal KV padding is not needed by the models")
    if causal and q_offset + lq > lk:
        raise ValueError("queries would attend past the last real key")


def route(lq: int, dtype: torch.dtype, dh: int, dv: Optional[int] = None) -> str:
    """The kernel a call takes: ``"decode"`` for ``Lq ≤ 16``, else ``"tc"``
    for bf16 with ``(Dqk, Dv) = (dh, dv)`` (``dv`` defaults to ``dh``) in
    :data:`TC_WIDTHS`, else ``"simt"``."""
    if lq <= DECODE_ROWS:
        return "decode"
    dv = dh if dv is None else dv
    return "tc" if dtype == torch.bfloat16 and (dh, dv) in TC_WIDTHS else "simt"


def lse_row_stride(lq: int) -> int:
    """Floats between two heads' log-sum-exp rows: ``Lq`` rounded up to
    :data:`LSE_ROW_ALIGN`."""
    return -(-lq // LSE_ROW_ALIGN) * LSE_ROW_ALIGN


def bwd_route(dtype: torch.dtype, dh: int, dv: Optional[int] = None) -> Optional[str]:
    """The backward kernel a call takes: ``"tc"`` for bf16 with ``(Dqk, Dv)
    = (dh, dv)`` (``dv`` defaults to ``dh``) in :data:`BWD_WIDTHS` (the
    tensor cores, from the forward's log-sum-exp), ``"simt"`` for float32
    with Dqk = Dv in :data:`BWD_SIMT_DIMS` (the CUDA cores); None where no
    kernel is built (a float32 MLA gradient among them)."""
    dv = dh if dv is None else dv
    if dtype == torch.bfloat16 and (dh, dv) in BWD_WIDTHS:
        return "tc"
    return "simt" if dtype == torch.float32 and dh == dv and dh in BWD_SIMT_DIMS else None


def plan_splits(heads: int, admitted: int, slots: int, max_splits: int) -> tuple[int, int]:
    """``(splits, keys per split)`` for ``heads`` decode blocks a split
    (b·hkv · row chunks) over ``admitted`` keys, on a card that holds
    ``slots`` such blocks at once (its SM count times the blocks an SM
    holds): as many splits as fill one wave of blocks without starting
    another, none under :data:`DECODE_MIN_KEYS` keys (unless the call has
    fewer), at most ``max_splits`` (the kernel's cap,
    ``flash_decode_max_splits``). Split ``s`` takes keys ``[s·kps,
    (s+1)·kps)`` of ``[0, admitted)``: every key once, no split empty."""
    fill = slots // max(1, heads)
    most = -(-admitted // DECODE_MIN_KEYS)
    n = max(1, min(fill, most, max_splits))
    kps = -(-admitted // n)
    return -(-admitted // kps), kps


def decode_rows(hq: int, hkv: int, lq: int) -> tuple[int, int, int]:
    """``(rows a block, row chunks, rows the kernel is built for)``: the
    ``group·Lq`` (head, query row) pairs of a KV head in as few blocks of at
    most :data:`DECODE_BLOCK_ROWS` rows as hold them, balanced; the kernel
    is built for 1, 2, 3, 4 or 8 rows."""
    pairs = hq // hkv * lq
    chunks = -(-pairs // DECODE_BLOCK_ROWS)
    rows = -(-pairs // chunks)
    return rows, chunks, rows if rows <= 4 else 8


# State of the decode kernel kept across calls: the occupancy query's
# answer per device and variant, and per (device, stream) the tickets the
# kernel leaves zero for the next call and its float32 workspace. Each
# call's partials are written and read inside its own launch, so calls in
# one stream's order can share them; a call on another stream gets its own.
_SLOTS: Dict[tuple, int] = {}
_TICKETS: Dict[tuple, torch.Tensor] = {}
_WORKSPACE: Dict[tuple, torch.Tensor] = {}


def decode_slots(device: torch.device, is_bf16: int, dh: int, rows: int) -> int:
    """Decode blocks of this variant the card holds at once: its SM count
    times the blocks one SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    key = (device.index, is_bf16, dh, rows)
    if key not in _SLOTS:
        n = ctypes.c_int()
        build.check_launch("flash_decode occupancy",
                           build.library().flash_decode_occupancy(is_bf16, dh, rows,
                                                                  ctypes.byref(n)))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _SLOTS[key] = sms * max(1, n.value)
    return _SLOTS[key]


def _tickets(key: tuple, device: torch.device, n: int) -> torch.Tensor:
    """The decode kernel's int32 tickets of ``key`` = (device, stream):
    zero between calls (the kernel resets the ones it uses), allocated once
    and grown."""
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _workspace(key: tuple, device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` float32 of the decode kernel's workspace of ``key`` =
    (device, stream), allocated with ``torch.empty`` once and grown."""
    w = _WORKSPACE.get(key)
    if w is None or w.numel() < n:
        w = torch.empty(max(n, 1 << 20), dtype=torch.float32, device=device)
        _WORKSPACE[key] = w
    return w


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, q_offset: int = 0, return_lse: bool = False):
    """Attention of ``q [B, Hq, Lq, Dqk]`` over ``k [B, Hkv, Lk, Dqk]`` and
    ``v [B, Hkv, Lk, Dv]`` on the card, scores scaled by ``1/√Dqk``;
    returns ``[B, Hq, Lq, Dv]`` in q's type, through the kernel
    :func:`route` names (on the ``"decode"`` and ``"simt"`` routes a view of
    the padded call's output when ``Dv < Dqk``). With ``return_lse`` it
    returns ``(out, lse)`` from the tensor-core kernel at any Lq (bf16,
    ``(Dqk, Dv)`` in :data:`TC_WIDTHS`): ``lse [B, Hq, Lq]`` float32, each
    row's ``log2 Σⱼ 2^(sⱼ/√Dh · log2 e)`` over its admitted keys (+inf for
    a row with none), a view whose head rows are :func:`lse_row_stride`
    floats apart; ``out`` is the tensor-core kernel's output bit for bit.

    ``v`` may have any strides: the one copy into the layout its route
    reads (zero-padded to Dqk on the ``"decode"`` and ``"simt"`` routes
    when ``Dv < Dqk``, else contiguous) is made here, and none where v
    already has it.

    Raises on the TPU kernel's contracts (:func:`check_contract`), and on
    anything but CUDA tensors of one type (float32 or bfloat16) on one
    device, q and k contiguous, with ``v.shape[:3] == k.shape[:3]``,
    ``Hq % Hkv == 0``, ``Dv ≤ Dqk ≤ 256``, ``q_offset ≥ 0``, and Dqk and Dv
    whole numbers of 16-byte chunks (multiples of 4 in float32, of 8 in
    bfloat16) with q, k and v 16-byte aligned. ``Lq = 0`` is answered
    without a launch.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: q must be [B, Hq, Lq, Dqk], k [B, Hkv, Lk, Dqk] "
                         f"and v [B, Hkv, Lk, Dv], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, lq, dh = q.shape
    hkv, lk, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != dh or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not group over k "
                         f"{tuple(k.shape)} (batch and Dh must match, Hq % Hkv == 0)")
    if not 1 <= dv <= dh <= _MAX_HEAD_DIM or q_offset < 0:
        raise ValueError(f"flash_attention: needs 1 <= Dv <= Dh <= {_MAX_HEAD_DIM} (Dh of q "
                         f"and k, Dv of v) and q_offset >= 0, got Dh={dh}, Dv={dv}, "
                         f"q_offset={q_offset}")
    if dh * q.element_size() % 16 or dv * q.element_size() % 16:
        raise ValueError(f"flash_attention: Dh={dh} and Dv={dv} must be whole numbers of "
                         f"16-byte {q.dtype} chunks")
    check_contract(lq, lk, causal=causal, q_offset=q_offset)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (not t.is_cuda or t.device != q.device or t.dtype != q.dtype
                or t.dtype not in _DTYPES or not (name == "v" or t.is_contiguous())):
            raise ValueError(f"flash_attention: {name} must be a float32 or bfloat16 CUDA "
                             f"tensor of q's type and device (q and k contiguous), got "
                             f"{t.dtype} on {t.device} (contiguous: {t.is_contiguous()})")
    if return_lse and not (q.dtype == torch.bfloat16 and (dh, dv) in TC_WIDTHS):
        raise ValueError(f"flash_attention: the log-sum-exp comes from the tensor-core kernel "
                         f"(bf16, (Dqk, Dv) in {TC_WIDTHS}), got {q.dtype}, Dh={dh}, Dv={dv}")
    kind = "tc" if return_lse else route(lq, q.dtype, dh, dv)
    if kind != "tc" and dv < dh:
        # the one-width kernels: V zero-padded to Dqk, the output sliced back
        out = flash_attention_cuda(q, k, F.pad(v, (0, dh - dv)), causal=causal,
                                   q_offset=q_offset)
        return out[..., :dv]
    v = v.contiguous()
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    out = torch.empty((b, hq, lq, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, lse_row_stride(lq)), dtype=torch.float32,
                       device=q.device)[..., :lq] if return_lse else None)
    if b == 0 or hq == 0 or lq == 0:
        return (out, lse) if return_lse else out
    lib = build.library()
    if kind != "decode":
        tile = (lib.flash_attention_tc_block_rows() if kind == "tc"
                else lib.flash_attention_block_rows())
        if math.ceil(lq / tile) > _MAX_GRID_Y:
            raise ValueError(f"flash_attention: Lq={lq} needs more than {_MAX_GRID_Y} "
                             f"query tiles of {tile} rows")
    for name, x in (("b*hq", b * hq), ("lk", lk), ("q_offset", q_offset)):
        build.int32_arg("flash_attention", name, x)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    is_bf16 = int(q.dtype == torch.bfloat16)
    scale = 1.0 / math.sqrt(dh)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if kind == "decode":
        admitted = min(lk, q_offset + lq) if causal else lk
        rows, chunks, rtile = decode_rows(hq, hkv, lq)
        blocks = b * hkv * chunks
        build.int32_arg("flash_decode", "b*hkv*chunks", blocks)
        splits, kps = plan_splits(blocks, admitted, decode_slots(q.device, is_bf16, dh, rows),
                                  lib.flash_decode_max_splits())
        key = (q.device.index, stream)
        ws = _workspace(key, q.device, blocks * splits * rtile * (dh + 2))
        err = lib.flash_decode_launch(*ptrs, ws.data_ptr(),
                                      _tickets(key, q.device, blocks).data_ptr(),
                                      is_bf16, b, hq, hkv, lq, lk, dh, int(causal), q_offset,
                                      scale, rows, splits, kps, stream)
        build.check_launch("flash_decode", err)
        flash_attention_cuda.decode_launches += 1
    elif kind == "tc":
        lse_ptr, lse_ld = (None, 0) if lse is None else (lse.data_ptr(), lse.stride(1))
        build.int32_arg("flash_attention", "b*hq*lse_ld", b * hq * lse_ld)
        err = lib.flash_attention_tc_launch(*ptrs, lse_ptr, lse_ld, b, hq, hkv, lq, lk, dh, dv,
                                            int(causal), q_offset, scale, stream)
        build.check_launch("flash_attention (tensor cores)", err)
        flash_attention_cuda.launches += 1
        flash_attention_cuda.tc_launches += 1
    else:
        err = lib.flash_attention_launch(*ptrs, is_bf16, b, hq, hkv, lq, lk, dh, int(causal),
                                         q_offset, scale, stream)
        build.check_launch("flash_attention", err)
        flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.tc_launches = 0
flash_attention_cuda.decode_launches = 0


def kernel_attributes(kind: str, dtype: torch.dtype, dh: int, rows: int = 1,
                      dv: Optional[int] = None) -> Dict[str, int]:
    """Registers a thread, static shared bytes, local (spill) bytes a
    thread and dynamic shared bytes of the kernel that :func:`route`'s
    ``kind`` launches for ``dtype`` and ``dh`` (``rows``: query rows a
    decode block; ``dv``: the tensor-core kernel's V width, ``dh`` by
    default), from ``cudaFuncGetAttributes``."""
    lib = build.library()
    vals = (ctypes.c_int * 4)()
    is_bf16 = int(dtype == torch.bfloat16)
    if kind == "decode":
        err = lib.flash_decode_attributes(is_bf16, dh, rows, vals)
    elif kind == "tc":
        err = lib.flash_attention_tc_attributes(dh, dh if dv is None else dv, vals)
    else:
        err = lib.flash_attention_attributes(is_bf16, dh, vals)
    build.check_launch(f"{kind} attributes", err)
    return dict(zip(("registers", "static_smem_bytes", "local_bytes", "dynamic_smem_bytes"),
                    vals))
