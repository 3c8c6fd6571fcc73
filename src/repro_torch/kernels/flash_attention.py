"""Flash attention — the CUDA kernel ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py`` ``flash_attention_pallas``:
grouped-query attention, causal or not, with a query offset (query ``i``
sees keys ``j ≤ i + q_offset``), float32 softmax and sums, the output in
q's type. One block per (b·hq, query tile) walks the keys with an online
softmax in registers; keys past the causal diagonal are skipped and keys
at ``≥ lk`` masked by bounds. The source holds two kernels: a 64-row tile
(``flash_attention_kernel``, launches counted in
``flash_attention_cuda.launches``) and, for ``Lq ≤ 16``, a one-row tile
(``flash_decode_kernel``, counted in ``flash_attention_cuda.decode_launches``).
Prefill is bound by operations, decode by bytes (the source says how far
the kernel is from each). The plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.
"""

from __future__ import annotations

import math

import torch

from . import build

__all__ = ["flash_attention_cuda", "check_contract"]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HEAD_DIM = 256
_MAX_GRID_Y = 65_535
DECODE_ROWS = 16  # Lq up to this takes the one-row kernel


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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Attention of ``q [B, Hq, Lq, Dh]`` over ``k, v [B, Hkv, Lk, Dh]`` on
    the card; returns ``[B, Hq, Lq, Dh]`` in q's type.

    Raises on the TPU kernel's contracts (:func:`check_contract`), and on
    anything but contiguous CUDA tensors of one type (float32 or bfloat16)
    on one device with ``Hq % Hkv == 0``, ``Dh ≤ 256``, ``q_offset ≥ 0``,
    and Dh a whole number of 16-byte chunks (a multiple of 4 in float32, of
    8 in bfloat16) with k and v 16-byte aligned. ``Lq = 0`` is answered
    without a launch.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be [B, Hq, Lq, Dh] and k, v one "
                         f"[B, Hkv, Lk, Dh] shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not group over k "
                         f"{tuple(k.shape)} (batch and Dh must match, Hq % Hkv == 0)")
    if not 1 <= dh <= _MAX_HEAD_DIM or q_offset < 0:
        raise ValueError(f"flash_attention: needs 1 <= Dh <= {_MAX_HEAD_DIM} and "
                         f"q_offset >= 0, got Dh={dh}, q_offset={q_offset}")
    if dh * q.element_size() % 16:
        raise ValueError(f"flash_attention: Dh={dh} is not a whole number of 16-byte "
                         f"{q.dtype} chunks")
    check_contract(lq, lk, causal=causal, q_offset=q_offset)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (not t.is_cuda or t.device != q.device or t.dtype != q.dtype
                or t.dtype not in _DTYPES or not t.is_contiguous()):
            raise ValueError(f"flash_attention: {name} must be a contiguous float32 or "
                             f"bfloat16 CUDA tensor of q's type and device, got {t.dtype} "
                             f"on {t.device} (contiguous: {t.is_contiguous()})")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention: k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0 or hq == 0 or lq == 0:
        return out
    one_row = lq <= DECODE_ROWS
    if (lq if one_row else math.ceil(lq / 64)) > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: Lq={lq} exceeds the grid's query tiles")
    for name, x in (("b*hq", b * hq), ("lk", lk), ("q_offset", q_offset)):
        build.int32_arg("flash_attention", name, x)
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     int(q.dtype == torch.bfloat16), int(one_row), b, hq, hkv,
                                     lq, lk, dh, int(causal), q_offset, 1.0 / math.sqrt(dh),
                                     stream)
    build.check_launch("flash_attention", err)
    if one_row:
        flash_attention_cuda.decode_launches += 1
    else:
        flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.decode_launches = 0
