"""Straggler detection and NP-storage rebalancing away from slow partitions.

Copy of ``repro/dist/straggler.py`` on the port's
:mod:`repro_torch.core.storage` (NumPy only). A :class:`StragglerMonitor`
keeps a sliding window of per-host step times (the LM training driver,
``launch/train.py``, records its steps there); hosts whose windowed mean
exceeds ``threshold ×`` the median are flagged. :func:`rebalance_plan` moves
a fraction of a slow partition's *center vertices* to fast partitions, and
:func:`apply_rebalance` rebuilds Φ(d) under the overridden partition
function — listed results are invariant (Lemma 3.1 holds for any partition
function), only the per-host work distribution changes.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Sequence

import numpy as np

from ..core.storage import NPStorage, build_np_storage

__all__ = ["StragglerMonitor", "rebalance_plan", "apply_rebalance"]


class StragglerMonitor:
    """Sliding-window per-host step-time monitor."""

    def __init__(self, n_hosts: int, window: int = 8, threshold: float = 1.5):
        self.n_hosts = int(n_hosts)
        self.window = int(window)
        self.threshold = float(threshold)
        self._times: deque = deque(maxlen=self.window)

    def record(self, step_times: np.ndarray) -> None:
        """Add one step's seconds, one per host."""
        t = np.asarray(step_times, dtype=np.float64).reshape(self.n_hosts)
        self._times.append(t)

    def means(self) -> np.ndarray:
        """Each host's mean over the window (zeros before any record)."""
        if not self._times:
            return np.zeros(self.n_hosts)
        return np.stack(self._times).mean(axis=0)

    def stragglers(self) -> List[int]:
        """Hosts whose windowed mean exceeds threshold × median."""
        if not self._times:
            return []
        m = self.means()
        med = float(np.median(m))
        if med <= 0:
            return []
        return [i for i in range(self.n_hosts) if m[i] > self.threshold * med]


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
