"""The attention backward — the CUDA kernels ``csrc/flash_attention_bwd.cu``.

The gradient of ``repro/kernels/flash_attention.py:84``
(``flash_attention_pallas``) as the LM training step calls it: causal,
query offset 0, as many queries as keys. The JAX package has no backward
kernel; it differentiates its plain ``_attention``, recomputing each query
chunk's softmax in the backward. Here two launches compute ``dQ``, ``dK``
and ``dV`` from ``q``, ``k``, ``v``, the forward's output and ``dO``, in
float32 on the CUDA cores: (a) per 64-query tile, the rows' log-sum-exp
and ``D = rowsum(dO ∘ O)`` (kept in a float32 scratch), then ``dQ``; (b)
per 64-key tile, ``dK`` and ``dV`` summed over the group's query heads
inside the block, the causal tiles skipped. Deterministic, no atomics.
Bound by operations; the source says how this design stands against it.
The plain version is :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from . import build

__all__ = ["flash_attention_bwd_cuda", "HEAD_DIMS", "kernel_attributes"]

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 128)  # the Dh the kernels are built for
_TILE = 64
_MAX_GRID_Y = 65_535


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, dout: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of causal attention (query offset 0) of ``q [B, Hq,
    L, Dh]`` over ``k, v [B, Hkv, L, Dh]``, whose output was ``out`` and its
    gradient ``dout`` (both ``[B, Hq, L, Dh]``), on the card; each in its
    input's type.

    Raises on anything but contiguous, 16-byte aligned CUDA tensors of one
    type (float32 or bfloat16) on one device, ``Hq % Hkv == 0``, Dh 64 or
    128, and ``out`` and ``dout`` of q's shape. ``L = 0`` is answered
    without a launch.
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
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: the kernels are built for Dh {HEAD_DIMS}, "
                         f"got {dh}")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape:
            raise ValueError(f"flash_attention_bwd: {name} must be {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        if (not t.is_cuda or t.device != q.device or t.dtype != q.dtype
                or t.dtype not in _DTYPES or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"flash_attention_bwd: {name} must be a contiguous, 16-byte "
                             f"aligned float32 or bfloat16 CUDA tensor of q's type and device, "
                             f"got {t.dtype} on {t.device} (contiguous: {t.is_contiguous()})")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or hq == 0 or l == 0:
        return dq, dk.zero_(), dv.zero_()
    if math.ceil(l / _TILE) > _MAX_GRID_Y:
        raise ValueError(f"flash_attention_bwd: L={l} needs more than {_MAX_GRID_Y} tiles")
    build.int32_arg("flash_attention_bwd", "b*hq", b * hq)
    stats = torch.empty((2, b * hq * l), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        int(q.dtype == torch.bfloat16), b, hq, hkv, l, dh, 1.0 / math.sqrt(dh), stream)
    build.check_launch("flash_attention_bwd", err)
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


def kernel_attributes(dtype: torch.dtype, dh: int) -> Dict[str, Dict[str, int]]:
    """Registers a thread, static shared bytes, local (spill) bytes a
    thread and dynamic shared bytes of each of the two kernels (``"dq"``,
    ``"dkdv"``) for ``dtype`` and ``dh``, from ``cudaFuncGetAttributes``."""
    lib = build.library()
    out = {}
    for which, name in enumerate(("dq", "dkdv")):
        vals = (ctypes.c_int * 4)()
        build.check_launch(f"flash_attention_bwd {name} attributes",
                           lib.flash_attention_bwd_attributes(int(dtype == torch.bfloat16), dh,
                                                              which, vals))
        out[name] = dict(zip(("registers", "static_smem_bytes", "local_bytes",
                              "dynamic_smem_bytes"), vals))
    return out
