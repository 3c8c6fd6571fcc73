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

- ``"tc"`` — bf16, ``(Dqk, Dv)`` (64, 64), (128, 128) or MLA's (96, 64)
  (minicpm3-4b) and (192, 128) (deepseek-v2-lite-16b), V at its own width:
  the products on the tensor cores
  (``wgmma``, tiles by TMA), P from the forward's log-sum-exp
  (``flash_attention_cuda(..., return_lse=True)``), P split into bf16
  ``hi + lo`` for dV and dS rounded once to bf16 for dQ and dK. Counted in
  ``launches`` and ``tc_launches``.
- ``"simt"`` — float32, Dqk = Dv of 64 or 128: the CUDA cores, each
  row's log-sum-exp recomputed in (a). Counted in ``launches``. A float32
  MLA gradient has no kernel and raises.

Bound by operations; the sources say how each design stands against it.
The plain version is :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import build
from .flash_attention import BWD_SIMT_DIMS, BWD_WIDTHS, LSE_ROW_ALIGN, bwd_route

__all__ = ["flash_attention_bwd_cuda", "kernel_attributes"]

_MAX_GRID_Y = 65_535
_TILE = 64  # the smallest tile of either route's grid


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, dout: torch.Tensor,
                             lse: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of causal attention (query offset 0) of ``q [B, Hq,
    L, Dqk]`` over ``k [B, Hkv, L, Dqk]`` and ``v [B, Hkv, L, Dv]``, whose
    output was ``out`` and its gradient ``dout`` (both ``[B, Hq, L, Dv]``),
    on the card; each in its input's type. ``lse`` is the forward's ``[B, Hq, L]`` float32
    log-sum-exp (``flash_attention_cuda(..., return_lse=True)``, its head
    rows a multiple of 64 floats apart and 16-byte aligned): the bf16 route
    needs it, the float32 route recomputes its own and takes none.

    Raises on anything but contiguous, 16-byte aligned CUDA tensors of one
    type (float32 or bfloat16) on one device, ``Hq % Hkv == 0``, widths a
    route is built for (:func:`~repro_torch.kernels.flash_attention.bwd_route`),
    ``out`` and ``dout`` ``[B, Hq, L, Dv]``, and ``lse`` as the route wants
    it. ``L = 0`` is answered without a launch.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention_bwd: q must be [B, Hq, L, Dqk], k [B, Hkv, L, Dqk] "
                         f"and v [B, Hkv, L, Dv], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, l, dh = q.shape
    hkv, dv = k.shape[1], v.shape[3]
    if k.shape[0] != b or k.shape[2] != l or k.shape[3] != dh or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)} does not group over k "
                         f"{tuple(k.shape)} (batch, length and Dh must match, Hq % Hkv == 0)")
    kind = bwd_route(q.dtype, dh, dv)
    if kind is None and q.dtype in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention_bwd: no kernel for {q.dtype} at Dh (Dqk, Dv) = "
                         f"({dh}, {dv}): bf16 is built for {BWD_WIDTHS}, float32 for Dqk = Dv "
                         f"in {BWD_SIMT_DIMS}")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != (b, hq, l, dv):
            raise ValueError(f"flash_attention_bwd: {name} must be {(b, hq, l, dv)}, got "
                             f"{tuple(t.shape)}")
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
    gq, gk, gv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or hq == 0 or l == 0:
        return gq, gk.zero_(), gv.zero_()
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
            lse.data_ptr(), ld, gq.data_ptr(), gk.data_ptr(), gv.data_ptr(), delta.data_ptr(),
            b, hq, hkv, l, dh, dv, scale, stream)
        build.check_launch("flash_attention_bwd (tensor cores)", err)
        flash_attention_bwd_cuda.tc_launches += 1
    else:
        stats = torch.empty((2, b * hq * ld), dtype=torch.float32, device=q.device)
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            gq.data_ptr(), gk.data_ptr(), gv.data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), b, hq, hkv, l, dh, scale, stream)
        build.check_launch("flash_attention_bwd", err)
    flash_attention_bwd_cuda.launches += 1
    return gq, gk, gv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.tc_launches = 0


def kernel_attributes(kind: str, dh: int, dv: Optional[int] = None) -> Dict[str, Dict[str, int]]:
    """Registers a thread, static shared bytes, local (spill) bytes a
    thread and dynamic shared bytes of each of the two kernels (``"dq"``,
    ``"dkdv"``) of the route ``kind`` (``"tc"`` or ``"simt"``) for Dqk
    ``dh`` and (``"tc"`` only) Dv ``dv`` (``dh`` by default), from
    ``cudaFuncGetAttributes``."""
    lib = build.library()
    dv = dh if dv is None else dv
    out = {}
    for which, name in enumerate(("dq", "dkdv")):
        vals = (ctypes.c_int * 4)()
        err = (lib.flash_attention_bwd_tc_attributes(dh, dv, which, vals) if kind == "tc"
               else lib.flash_attention_bwd_attributes(dh, which, vals))
        build.check_launch(f"flash_attention_bwd {kind} {name} attributes", err)
        out[name] = dict(zip(("registers", "static_smem_bytes", "local_bytes",
                              "dynamic_smem_bytes"), vals))
    return out
