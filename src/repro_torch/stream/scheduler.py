"""The per-batch shared update delta and the work counters.

Host copy of the parts of ``repro/stream/scheduler.py`` that the device
backend reads: :class:`SharedDelta` (its fields; the host storage update
``ensure_storage`` and the seed cache ``seed_provider`` belong to the host
backend and are not copied yet), and the work counters ``_PROBE_KEYS``,
``PROBE_METRIC_NAMES``, :data:`PROBE`, :func:`reset_probe` and
:func:`probe_inc`.

:data:`PROBE` is this package's own process-global view; a service's
isolated counts live in its own registry (``obs.metrics``), which
:func:`probe_inc` mirrors into, so a backend plugged into any service
reports there under ``PROBE_METRIC_NAMES``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core.estimator import GraphStats
from ..core.graph import GraphUpdate
from ..core.storage import NPStorage
from ..obs.metrics import MetricsRegistry, ProbeView

__all__ = ["PROBE", "PROBE_METRIC_NAMES", "reset_probe", "probe_inc", "SharedDelta"]

# Work counters: how many times per-batch work ran.
#
# - ``delta_decodes``     — journal window → netted GraphUpdate
# - ``storage_updates``   — Φ(d) → Φ(d') (Alg. 4)
# - ``stats_refreshes``   — GraphStats.of(d')
# - ``seed_listings``     — per-unit Nav-join seed derivations
# - ``host_materializations`` — device→host pulls of a running match set
#                           (``materialize``); count-only batches must not
#                           advance it
# - ``cache_hits`` / ``cache_misses`` / ``invalidated_parts`` — unit-table
#                           cache traffic (the device unit-table carries)
_PROBE_KEYS = (
    "delta_decodes",
    "storage_updates",
    "stats_refreshes",
    "seed_listings",
    "host_materializations",
    "cache_hits",
    "cache_misses",
    "invalidated_parts",
)

#: metric name each PROBE key mirrors into a per-service registry
PROBE_METRIC_NAMES: Dict[str, str] = {
    "delta_decodes": "stream_delta_decodes_total",
    "storage_updates": "stream_storage_updates_total",
    "stats_refreshes": "stream_stats_refreshes_total",
    "seed_listings": "stream_seed_listings_total",
    "host_materializations": "stream_host_materializations_total",
    "cache_hits": "unit_cache_hits_total",
    "cache_misses": "unit_cache_misses_total",
    "invalidated_parts": "unit_cache_invalidated_parts_total",
}

_LEGACY_REGISTRY = MetricsRegistry()
PROBE: ProbeView = ProbeView(_LEGACY_REGISTRY, _PROBE_KEYS)


def reset_probe() -> None:
    """Zero the global ``PROBE`` counters (and nothing else)."""
    PROBE.reset()


def probe_inc(key: str, n: int = 1, metrics: Optional[MetricsRegistry] = None) -> None:
    """Advance a ``PROBE`` counter and, when a per-service registry is
    given, its isolated mirror counter too."""
    PROBE._inc(key, n)
    if metrics is not None:
        metrics.counter(PROBE_METRIC_NAMES[key],
                        f"per-service mirror of PROBE[{key!r}]").inc(n)


@dataclasses.dataclass
class SharedDelta:
    """Everything derivable from one journal window, computed once and
    handed to every registered pattern: the netted ``update`` of ops
    ``[lo, hi)`` and its sorted edge codes. ``storage`` / ``storage_report``
    / ``stats`` are the host backend's lazily built Φ(d') (the device
    backend applies the update on the card and leaves them None)."""

    lo: int
    hi: int
    update: GraphUpdate
    add_codes: np.ndarray
    delete_codes: np.ndarray
    storage: Optional[NPStorage] = None
    storage_report: Optional[Any] = None
    stats: Optional[GraphStats] = None
    #: the owning service's registry (None = the global PROBE only)
    metrics: Optional[MetricsRegistry] = None
    _seed_plain: Dict[Tuple, Tuple[Tuple[int, ...], np.ndarray]] = dataclasses.field(
        default_factory=dict)

    @property
    def n_ops(self) -> int:
        return self.hi - self.lo

    @property
    def net_size(self) -> int:
        return self.update.size
