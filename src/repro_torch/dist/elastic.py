"""Elastic re-partitioning of NP storage (m → m' hosts).

Copy of ``repro/dist/elastic.py`` on the port's
:mod:`repro_torch.core.storage` (NumPy only). When the device pool grows or
shrinks, the storage must be re-cut under a new partition count.
:func:`repartition_delta` reports how much state would move (the decision
input); :func:`repartition_storage` performs the cut. The rebuilt storage
is bit-identical to building Φ(d) from scratch at ``new_m``, so listings
before and after agree exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.storage import NPStorage, PartitionFn, build_np_storage

__all__ = ["repartition_delta", "repartition_storage"]


def repartition_delta(storage: NPStorage, new_m: int) -> Dict[str, int]:
    """Cost report of moving from ``m`` to ``new_m`` partitions.

    moved_centers  — vertices whose owning partition changes
    moved_edges    — directed edge stubs that must be re-shipped
                     (edges incident to a moved center)
    old_m/new_m    — partition counts
    """
    g = storage.graph
    ids = np.arange(g.n, dtype=np.int64)
    h_old = storage.h(ids)
    h_new = PartitionFn(new_m)(ids)
    moved = h_old != h_new
    return {
        "old_m": storage.m,
        "new_m": int(new_m),
        "moved_centers": int(np.count_nonzero(moved)),
        "moved_edges": int(g.degrees[moved].sum()),
    }


def repartition_storage(storage: NPStorage, new_m: int) -> NPStorage:
    """Re-cut Φ(d) at ``new_m`` parts (== fresh build at ``new_m``)."""
    return build_np_storage(storage.graph, int(new_m))
