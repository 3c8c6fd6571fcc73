"""NP-storage rebalancing away from slow partitions.

Copy of ``rebalance_plan`` and ``apply_rebalance`` from
``repro/dist/straggler.py`` on the port's :mod:`repro_torch.core.storage`
(NumPy only); its ``StragglerMonitor`` has no twin, since nothing in the
port records per-host step times. :func:`rebalance_plan` moves a fraction
of a slow partition's *center vertices* to fast partitions, and
:func:`apply_rebalance` rebuilds Φ(d) under the overridden partition
function — listed results are invariant (Lemma 3.1 holds for any partition
function), only the per-host work distribution changes.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..core.storage import NPStorage, build_np_storage

__all__ = ["rebalance_plan", "apply_rebalance"]


def rebalance_plan(
    storage: NPStorage,
    slow: Sequence[int],
    fast: Sequence[int],
    fraction: float = 0.5,
) -> Dict[int, int]:
    """Move ``fraction`` of each slow partition's centers to fast parts.

    Highest-degree centers move first (they carry the most listing
    work). Returns ``{vertex: new_partition}`` overrides.
    """
    fast = list(fast)
    if not fast:
        return {}
    plan: Dict[int, int] = {}
    g = storage.graph
    k = 0
    for pid in slow:
        centers = storage.parts[pid].center_vertices()
        if centers.size == 0:
            continue
        deg = g.degrees[np.clip(centers, 0, g.n - 1)]
        order = np.argsort(-deg, kind="stable")
        n_move = max(1, int(round(fraction * centers.size)))
        for u in centers[order][:n_move]:
            plan[int(u)] = fast[k % len(fast)]
            k += 1
    return plan


def apply_rebalance(storage: NPStorage, plan: Dict[int, int]) -> NPStorage:
    """Rebuild Φ(d) under the overridden partition function."""
    if not plan:
        return storage
    h2 = storage.h.rebalanced(plan)
    return build_np_storage(storage.graph, storage.m, h2)
