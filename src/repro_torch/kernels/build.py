"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file of this package is compiled by ``nvcc`` for
``sm_90a`` into one shared library with
:func:`torch.utils.cpp_extension.load`, on first use, into
``<repo>/build/torch_ext/`` (git-ignored). The sources include no PyTorch
header: each exports a plain C launcher, bound here with :mod:`ctypes`, so
the build takes seconds. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import os
import time

__all__ = ["BUILD_DIR", "SOURCES", "library", "build_seconds", "int32_arg"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(sorted(glob.glob(os.path.join(_HERE, "csrc", "*.cu"))))
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_HERE))), "build", "torch_ext")
CUDA_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17")

_LIB = None
_BUILD_SECONDS = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # q_hi, q_lo, t_hi, t_lo, n, m, s, scratch, out, device, stream
    "member_probe_launch": (_P, _P, _P, _P, _L, _I, _I, _P, _P, _I, _P),
    # a, b, g, ca, cb, pad, out, device, stream
    "set_intersect_launch": (_P, _P, _L, _I, _I, _I, _P, _I, _P),
    # device, out[2]
    "set_intersect_limits": (_I, _P),
    # data, is_bf16, d, order, offsets, lo, hi, chunk, heavy, parts, n_heavy, n_parts,
    # split, partial, acc, device, stream
    "segment_sum_launch": (_P, _I, _L, _P, _P, _L, _L, _L, _P, _P, _L, _L, _L, _P, _P, _I,
                           _P),
    # table, is_bf16, rows, d, idx, bag, n, num_bags, out, device, stream
    "embedding_bag_launch": (_P, _I, _L, _L, _P, _P, _L, _L, _P, _I, _P),
    # q, k, v, out, is_bf16, b, hq, hkv, lq, lk, dh, causal, q_offset, scale, stream
    "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P),
    # q, k, v, out, lse (or null), lse row stride, b, hq, hkv, lq, lk, dqk, dv, causal,
    # q_offset, scale, stream
    "flash_attention_tc_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  ctypes.c_float, _P),
    # q, k, v, out, ws, tickets, is_bf16, b, hq, hkv, lq, lk, dh, causal, q_offset, scale,
    # rows, splits, kps, stream
    "flash_decode_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            ctypes.c_float, _I, _I, _I, _P),
    # q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq, hkv, l, dh, scale, stream
    "flash_attention_bwd_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   ctypes.c_float, _P),
    # q, k, v, o, dout, lse, lse row stride, dq, dk, dv, delta, b, hq, hkv, l, dqk, dv, scale,
    # stream
    "flash_attention_bwd_tc_launch": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _I, ctypes.c_float, _P),
    # dh (tc: dqk, dv), which kernel, out[4]
    "flash_attention_bwd_attributes": (_I, _I, _P),
    "flash_attention_bwd_tc_attributes": (_I, _I, _I, _P),
    # (is_bf16,) dh (tc: dqk, dv), (rows,) out[4]
    "flash_attention_attributes": (_I, _I, _P),
    "flash_attention_tc_attributes": (_I, _I, _P),
    "flash_decode_attributes": (_I, _I, _I, _P),
    # is_bf16, dh, rows, out
    "flash_decode_occupancy": (_I, _I, _I, _P),
    # kernel constants the wrappers plan with
    "flash_attention_block_rows": (),
    "flash_attention_tc_block_rows": (),
    "flash_decode_max_splits": (),
}


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB, _BUILD_SECONDS
    if _LIB is None:
        from torch.utils.cpp_extension import load

        if not SOURCES:
            raise RuntimeError(f"no CUDA sources under {os.path.join(_HERE, 'csrc')}")
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        path = load(name="repro_torch_kernels", sources=list(SOURCES),
                    build_directory=BUILD_DIR, extra_cuda_cflags=list(CUDA_FLAGS),
                    is_python_module=False, verbose=verbose)
        # Called with the GIL held (PyDLL, not CDLL): a launcher only queues
        # work, and releasing and retaking the GIL around it costs host time
        # of its own, several times more once torch.profiler has run in the
        # process.
        lib = ctypes.PyDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _BUILD_SECONDS = time.perf_counter() - t0
        _LIB = lib
    return _LIB


def build_seconds() -> float | None:
    """Wall time of the build (and load) in this process, if it happened."""
    return _BUILD_SECONDS


def int32_arg(kernel: str, name: str, value: int) -> int:
    """``value`` as a C ``int`` argument; raises where it does not fit
    (ctypes would truncate it silently)."""
    if not -2**31 <= value < 2**31:
        raise ValueError(f"{kernel}: {name}={value} does not fit in int32")
    return value


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        import torch

        msg = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no device"
        raise RuntimeError(f"{name} failed to launch: cudaError {err} on {msg}")
