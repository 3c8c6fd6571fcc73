"""Rows a batch's deletions destroy (paper Lemma 6.1), on host tables.

Host copy (NumPy only) of :func:`removed_rows` and its helpers
:func:`_codes_of` and :func:`_in_sorted` from ``repro/core/incremental.py``;
the rest of that module (the host oracle's Alg. 5) is not copied here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .graph import edge_codes
from .vcbc import CompressedTable

__all__ = ["removed_rows"]


def _codes_of(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    return (lo << np.int64(32)) | hi


def _in_sorted(q: np.ndarray, sorted_codes: np.ndarray) -> np.ndarray:
    if not sorted_codes.size or not q.size:
        return np.zeros(q.shape, bool)
    pos = np.clip(np.searchsorted(sorted_codes, q), 0, sorted_codes.shape[0] - 1)
    return sorted_codes[pos] == q


def removed_rows(table: CompressedTable, deleted: np.ndarray,
                 ord_: Sequence[Tuple[int, int]] = ()) -> np.ndarray:
    """Plain rows of ``table`` that map a pattern edge into ``E_d(U)``: the
    decompressed complement of the Lemma 6.1 delete filter, which match-delta
    sinks read to learn exactly which matches a batch destroyed."""
    del_codes = np.sort(edge_codes(deleted)) if np.asarray(deleted).size else np.empty(0, np.int64)
    if not del_codes.size:
        return np.empty((0, table.pattern.n), np.int64)
    cols, rows = table.decompress(ord_)
    if not rows.shape[0]:
        return rows[:0]
    col_of = {c: j for j, c in enumerate(cols)}
    hit = np.zeros(rows.shape[0], dtype=bool)
    for a, b in table.pattern.edges:
        q = _codes_of(rows[:, col_of[a]], rows[:, col_of[b]])
        hit |= _in_sorted(q, del_codes)
    return rows[hit]
