"""Embedding bag — the CUDA kernel ``csrc/embedding_bag.cu``.

Replaces ``repro/kernels/embedding_bag.py:41`` ``embedding_bag_pallas``:
``out[b, :] = Σ_{i : bag_ids[i] = b} table[indices[i], :]`` over inputs
sorted by bag, the DLRM embedding lookup. The TPU kernel steps through the
rows in order and keeps the running bag in its output block; here each warp
owns a run of consecutive bags, finds its first row with a 32-way search of
the sorted bag ids and walks the rows from there, summing in float32. Every
bag is written once (zeros where it has no rows), bag ids outside
``[0, num_bags)`` are never reached, and a row index outside ``[0, V)``
makes its bag NaN without being read. It is bound by bytes: each row read
once, each bag written once, so the kernel keeps many random row loads in
flight: it walks the rows in windows of 32, hands the window's bags to
workers of a few lanes in turn, and each worker loads several of its rows
before it adds them, in input order. The plain version is
:func:`repro_torch.kernels.ref.embedding_bag_ref`.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["embedding_bag_cuda"]

_DTYPES = (torch.float32, torch.bfloat16)


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor, bag_ids: torch.Tensor,
                       num_bags: int) -> torch.Tensor:
    """Sum the rows ``table[indices]`` into their bags on the card; returns
    ``[num_bags, D]`` in the table's type.

    ``table``: contiguous ``[V, D]`` float32 or bfloat16; ``indices`` and
    ``bag_ids``: contiguous ``[N]`` int32 on the same CUDA device, sorted
    by ``bag_ids`` (the kernel's contract, as the TPU kernel's: it is not
    checked). Raises on anything else; ``N = 0`` or ``num_bags = 0`` is
    answered without a launch.
    """
    if (not table.is_cuda or table.dtype not in _DTYPES or table.ndim != 2
            or not table.is_contiguous()):
        raise ValueError(f"embedding_bag: table must be a contiguous 2-D float32 or bfloat16 "
                         f"CUDA tensor, got {table.dtype} {tuple(table.shape)} on "
                         f"{table.device}")
    # attributes rather than method calls where both exist: a serve_p99
    # launch is host-bound, and these checks are a good part of its host work
    dev = table.device
    n = indices.shape[0] if indices.ndim == 1 else -1
    for name, t in (("indices", indices), ("bag_ids", bag_ids)):
        if (t.dtype != torch.int32 or t.ndim != 1 or t.device != dev
                or not t.is_contiguous() or t.shape[0] != n):
            raise ValueError(f"embedding_bag: {name} must be a contiguous [N] int32 tensor "
                             f"on {dev}, one length for both, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if num_bags < 0:
        raise ValueError(f"embedding_bag: num_bags={num_bags} is negative")
    build.int32_arg("embedding_bag", "num_bags", num_bags)
    rows, d = table.shape
    if n == 0 or num_bags == 0 or d == 0:
        return table.new_zeros((num_bags, d))
    out = table.new_empty((num_bags, d))
    lib = build.library()
    # the current stream's raw handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = lib.embedding_bag_launch(table.data_ptr(), int(table.dtype == torch.bfloat16), rows, d,
                                   indices.data_ptr(), bag_ids.data_ptr(), n, num_bags,
                                   out.data_ptr(), dev.index, stream)
    if err:
        build.check_launch("embedding_bag", err)
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
