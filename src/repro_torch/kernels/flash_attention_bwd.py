"""The attention backward — the CUDA kernels ``csrc/flash_attention_bwd_tc.cu``
(bf16) and ``csrc/flash_attention_bwd.cu`` (float32).

The gradient of ``repro/kernels/flash_attention.py:84``
(``flash_attention_pallas``) as the LM training step calls it: causal,
query offset 0, as many queries as keys. The JAX package has no backward
kernel; it differentiates its plain ``_attention``, recomputing each query
chunk's softmax in the backward. Here two launches compute ``dQ``, ``dK``
and ``dV`` from ``q``, ``k``, ``v``, the forward's output and ``dO``: (a)
per query tile, ``D = rowsum(dO ∘ O)`` (kept in a float32 scratch), then
``dQ``; (b) per key tile, ``dK`` and ``dV`` summed over the group's query
heads inside the block, the causal tiles skipped. Deterministic, no
atomics. :func:`~repro_torch.kernels.flash_attention.bwd_route` picks the
kernels:

- ``"tc"`` — bf16, Dh 64 or 128: the products on the tensor cores
  (``wgmma``, tiles by TMA), P from the forward's log-sum-exp
  (``flash_attention_cuda(..., return_lse=True)``), P split into bf16
  ``hi + lo`` for dV and dS rounded once to bf16 for dQ and dK. Counted in
  ``launches`` and ``tc_launches``.
- ``"simt"`` — float32, Dh 64 or 128: the CUDA cores, each row's
  log-sum-exp recomputed in (a). Counted in ``launches``.

Bound by operations; the sources say how each design stands against it.
The plain version is :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import build
from .flash_attention import BWD_HEAD_DIMS, LSE_ROW_ALIGN, bwd_route

__all__ = ["flash_attention_bwd_cuda", "kernel_attributes"]

_MAX_GRID_Y = 65_535
_TILE = 64  # the smallest tile of either route's grid


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, dout: torch.Tensor,
                             lse: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of causal attention (query offset 0) of ``q [B, Hq,
    L, Dh]`` over ``k, v [B, Hkv, L, Dh]``, whose output was ``out`` and its
    gradient ``dout`` (both ``[B, Hq, L, Dh]``), on the card; each in its
    input's type. ``lse`` is the forward's ``[B, Hq, L]`` float32
    log-sum-exp (``flash_attention_cuda(..., return_lse=True)``, its head
    rows a multiple of 64 floats apart and 16-byte aligned): the bf16 route
    needs it, the float32 route recomputes its own and takes none.

    Raises on anything but contiguous, 16-byte aligned CUDA tensors of one
    type (float32 or bfloat16) on one device, ``Hq % Hkv == 0``, Dh 64 or
    128, ``out`` and ``dout`` of q's shape, and ``lse`` as the route wants
    it. ``L = 0`` is answered without a launch.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_bwd: q must be [B, Hq, L, Dh] and k, v one "
                         f"[B, Hkv, L, Dh] shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, l, dh = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != l or k.shape[3] != dh or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)} does not group over k "
                         f"{tuple(k.shape)} (batch, length and Dh must match, Hq % Hkv == 0)")
    if dh not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: the kernels are built for Dh {BWD_HEAD_DIMS}, "
                         f"got {dh}")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape:
            raise ValueError(f"flash_attention_bwd: {name} must be {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
    kind = bwd_route(q.dtype, dh)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        if (kind is None or not t.is_cuda or t.device != q.device or t.dtype != q.dtype
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"flash_attention_bwd: {name} must be a contiguous, 16-byte "
                             f"aligned float32 or bfloat16 CUDA tensor of q's type and device, "
                             f"got {t.dtype} on {t.device} (contiguous: {t.is_contiguous()})")
    ld = l  # floats between two heads' rows of the LSE and D
    if kind == "tc":
        ld = lse.stride(1) if lse is not None and lse.dim() == 3 else 0
        if (lse is None or lse.shape != (b, hq, l) or lse.dtype != torch.float32
                or lse.device != q.device or lse.stride() != (hq * ld, ld, 1) or ld < l
                or ld % LSE_ROW_ALIGN or lse.data_ptr() % 16):
            raise ValueError(f"flash_attention_bwd: the bf16 route needs the forward's "
                             f"log-sum-exp, a float32 [B, Hq, L] = {(b, hq, l)} tensor on q's "
                             f"device, 16-byte aligned, its rows a multiple of "
                             f"{LSE_ROW_ALIGN} floats apart")
    elif lse is not None:
        raise ValueError("flash_attention_bwd: the float32 route recomputes the log-sum-exp; "
                         "lse must be None")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or hq == 0 or l == 0:
        return dq, dk.zero_(), dv.zero_()
    if math.ceil(l / _TILE) > _MAX_GRID_Y:
        raise ValueError(f"flash_attention_bwd: L={l} needs more than {_MAX_GRID_Y} tiles")
    build.int32_arg("flash_attention_bwd", "b*hq*ld", b * hq * ld)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / math.sqrt(dh)
    lib = build.library()
    if kind == "tc":
        delta = torch.empty(b * hq * ld, dtype=torch.float32, device=q.device)
        err = lib.flash_attention_bwd_tc_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), ld, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b,
            hq, hkv, l, dh, scale, stream)
        build.check_launch("flash_attention_bwd (tensor cores)", err)
        flash_attention_bwd_cuda.tc_launches += 1
    else:
        stats = torch.empty((2, b * hq * ld), dtype=torch.float32, device=q.device)
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), b, hq, hkv, l, dh, scale, stream)
        build.check_launch("flash_attention_bwd", err)
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.tc_launches = 0


def kernel_attributes(kind: str, dh: int) -> Dict[str, Dict[str, int]]:
    """Registers a thread, static shared bytes, local (spill) bytes a
    thread and dynamic shared bytes of each of the two kernels (``"dq"``,
    ``"dkdv"``) of the route ``kind`` (``"tc"`` or ``"simt"``) for ``dh``,
    from ``cudaFuncGetAttributes``."""
    lib = build.library()
    fn = {"tc": lib.flash_attention_bwd_tc_attributes,
          "simt": lib.flash_attention_bwd_attributes}[kind]
    out = {}
    for which, name in enumerate(("dq", "dkdv")):
        vals = (ctypes.c_int * 4)()
        build.check_launch(f"flash_attention_bwd {kind} {name} attributes", fn(dh, which, vals))
        out[name] = dict(zip(("registers", "static_smem_bytes", "local_bytes",
                              "dynamic_smem_bytes"), vals))
    return out
