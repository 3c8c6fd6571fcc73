"""Unit Match Listing (paper Alg. 1) and full-tree initial calculation.

Host copy (NumPy only) of ``repro/core/listing.py``.
``list_unit_compressed`` lists the anchor-center-constrained matches
``M_ac(q, d_j)`` of an R1 unit from one NP partition and groups them into
the consistently-compressed (CC) form under the global cover.
``execute_join_tree`` then runs the optimal join tree bottom-up with
:func:`~repro_torch.core.vcbc.cc_join`, producing the compressed ``M(p, d)``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from .join_tree import JoinTree
from .match_engine import list_matches
from .pattern import R1Unit
from .storage import NPStorage, Partition
from .vcbc import CompressedTable, cc_join, compress_table, concat_tables

__all__ = ["list_unit_compressed", "list_unit_all_parts", "execute_join_tree", "ExecutionReport"]


@dataclasses.dataclass
class ExecutionReport:
    """I/O-cost instrumentation mirroring Eq. 10's terms (integer counts)."""

    unit_ints: int = 0          # Σ S(q) over leaves
    intermediate_ints: int = 0  # Σ S(p_i) over internal nodes (excl. root)
    root_ints: int = 0          # S(p)
    joins: int = 0

    def total_join_cost(self) -> int:
        # Eq. 10 rearrangement: 6·S for every non-root node + S(root),
        # ignoring the tree-independent constants.
        return 6 * (self.unit_ints + self.intermediate_ints) + self.root_ints


def list_unit_compressed(
    part: Partition,
    unit: R1Unit,
    cover: Sequence[int],
    ord_: Sequence[Tuple[int, int]],
    *,
    require_edge_codes: np.ndarray | None = None,
    anchor_candidates: np.ndarray | None = None,
) -> CompressedTable:
    """Alg. 1: compressed ``M_ac(q, d_j)`` listed directly from Φ(d)."""
    anchor = unit.anchor_in(cover)
    if anchor is None:
        raise ValueError("unit anchor must lie inside the cover (CC condition 3)")
    cols, table = list_matches(
        part,
        unit.pattern,
        ord_,
        anchor=anchor,
        anchor_to_centers=True,
        require_edge_codes=require_edge_codes,
    )
    if anchor_candidates is not None and table.shape[0]:
        keep = np.isin(table[:, cols.index(anchor)], anchor_candidates)
        table = table[keep]
    return compress_table(unit.pattern, cover, cols, table)


def list_unit_all_parts(
    storage: NPStorage,
    unit: R1Unit,
    cover: Sequence[int],
    ord_: Sequence[Tuple[int, int]],
    *,
    require_edge_codes: np.ndarray | None = None,
) -> CompressedTable:
    """Union over partitions — complete & duplicate-free by Lemma 3.1."""
    tables = [
        list_unit_compressed(p, unit, cover, ord_, require_edge_codes=require_edge_codes)
        for p in storage.parts
    ]
    return concat_tables(tables)


def execute_join_tree(
    storage: NPStorage,
    tree: JoinTree,
    cover: Sequence[int],
    ord_: Sequence[Tuple[int, int]],
    report: ExecutionReport | None = None,
) -> CompressedTable:
    """Bottom-up execution of the optimal join tree (initial calculation)."""
    report = report if report is not None else ExecutionReport()

    def run(node: JoinTree, is_root: bool) -> CompressedTable:
        if node.is_leaf:
            t = list_unit_all_parts(storage, node.unit, cover, ord_)
            report.unit_ints += t.storage_ints()
            return t
        lt = run(node.left, False)
        rt = run(node.right, False)
        out = cc_join(lt, rt, ord_)
        report.joins += 1
        if is_root:
            report.root_ints += out.storage_ints()
        else:
            report.intermediate_ints += out.storage_ints()
        return out

    return run(tree, True)
