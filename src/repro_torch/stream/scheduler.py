"""Adaptive micro-batching + the per-batch **shared update delta**.

Host copy of ``repro/stream/scheduler.py``. :class:`BatchScheduler` does
the same float64 operations in the same order as the original, so the same
``observe()`` series gives the same batch sizes, predictions and drift.

Two jobs:

1. :class:`BatchScheduler` picks batch boundaries. The *model* half uses
   the paper's §IV-D PR estimator: the expected number of Nav-join seed
   matches per inserted edge for unit ``q`` is ``|E(q)|·E|M(q,d)|/|E(d)|``
   (each unit edge is equally likely to be the one mapped onto the
   insert), and each seed is pushed through a chain of ``len(units)-1``
   CC-joins — summed over units and registered patterns this gives a
   per-operation work estimate in "cost units" (integers touched, the
   same currency as :mod:`repro_torch.core.cost`). The *measurement* half
   calibrates cost units to wall-clock with an EWMA of observed batch
   latency, so a latency target turns into a batch size that tracks the
   actual hardware and the actual graph.

2. :func:`compute_shared_delta` decodes one journal window into a
   :class:`SharedDelta` — netted update, sorted edge codes, and (lazily)
   the updated NP storage Φ(d'), fresh :class:`GraphStats`, and memoized
   per-unit Nav-join seed listings. The delta is computed **once per
   batch** and handed to every registered pattern; :data:`PROBE`
   counters make "once" an assertable fact rather than a comment.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.estimator import GraphStats, match_size_estimate
from ..core.graph import GraphUpdate
from ..core.match_engine import list_matches
from ..core.pattern import Pattern, R1Unit
from ..core.storage import NPStorage, UpdateCostReport
from ..core.unit_cache import PartitionUnitCache, _restrict_ord, require_edge_rows
from ..core.vcbc import CompressedTable, compress_table
from ..obs.metrics import MetricsRegistry, ProbeView

from .journal import UpdateJournal

__all__ = ["PROBE", "PROBE_METRIC_NAMES", "reset_probe", "probe_inc", "SharedDelta",
           "compute_shared_delta", "BatchScheduler"]


# Instrumentation counters: how many times per-batch work actually ran.
# The multi-pattern service tests assert these advance by exactly one
# per micro-batch no matter how many patterns are registered.
#
# ``PROBE`` keys and what they count:
#
# - ``delta_decodes``     — journal window → netted GraphUpdate
# - ``storage_updates``   — Φ(d) → Φ(d') (Alg. 4)
# - ``stats_refreshes``   — GraphStats.of(d')
# - ``seed_listings``     — per-unit Nav-join seed *derivations* (one per
#                           distinct unit per batch; with a unit cache
#                           the actual listings behind them are
#                           cache_misses)
# - ``host_materializations`` — device→host pulls of a sharded backend's
#                           running match set (`StreamBackend.materialize`).
#                           Count-only batches must not advance this —
#                           the match sets stay on the mesh end to end.
# - ``cache_hits`` / ``cache_misses`` / ``invalidated_parts`` —
#                           delta-maintained unit-table cache traffic
#                           (core.unit_cache / the sharded per-device
#                           carries). On a warm stream, cache_misses per
#                           batch is bounded by |units| · |dirty parts|,
#                           not |units| · m — asserted in tests.
#
# **Deprecated surface.** ``PROBE`` is now a :class:`~repro_torch.obs.metrics.ProbeView`
# — a dict-shaped shim over a module-level legacy registry — kept so
# existing tests/scripts using ``PROBE["k"]`` / ``reset_probe()`` work
# unchanged. It is still process-global: two ``ListingService`` instances
# in one process both advance it (aggregate view). *Isolated* counts
# live on each service's own registry (``service.obs.metrics``, names
# like ``stream_storage_updates_total`` / ``unit_cache_hits_total``) —
# new code should read those. Reset semantics are explicit:
# :func:`reset_probe` zeroes exactly these eight global counters and
# never touches any service's registry.
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
    """Zero the global legacy ``PROBE`` counters (and nothing else)."""
    PROBE.reset()


def probe_inc(key: str, n: int = 1,
              metrics: Optional[MetricsRegistry] = None) -> None:
    """Advance a legacy ``PROBE`` counter and, when a per-service
    registry is given, its isolated mirror counter too."""
    PROBE._inc(key, n)
    if metrics is not None:
        metrics.counter(PROBE_METRIC_NAMES[key],
                        f"per-service mirror of PROBE[{key!r}]").inc(n)


@dataclasses.dataclass
class SharedDelta:
    """Everything derivable from one journal window, computed once.

    ``storage``/``stats`` are filled lazily by :meth:`ensure_storage`
    (the host backend calls it; the device backend applies the update
    on the card and never materializes a host Φ(d')). ``seed_provider``
    returns a ``seed_fn`` for :func:`repro_torch.core.navjoin.nav_join_patch`
    that memoizes the *plain* per-unit seed tables across patterns —
    keyed by (unit pattern, anchor, restricted ord), so two patterns
    sharing a triangle unit list its seeds once.
    """

    lo: int
    hi: int
    update: GraphUpdate
    add_codes: np.ndarray
    delete_codes: np.ndarray
    storage: Optional[NPStorage] = None
    storage_report: Optional[UpdateCostReport] = None
    stats: Optional[GraphStats] = None
    #: the owning service's registry — per-batch work counters mirror
    #: into it alongside the legacy global ``PROBE`` (None = global only)
    metrics: Optional[MetricsRegistry] = None
    _seed_plain: Dict[Tuple, Tuple[Tuple[int, ...], np.ndarray]] = dataclasses.field(default_factory=dict)

    @property
    def n_ops(self) -> int:
        return self.hi - self.lo

    @property
    def net_size(self) -> int:
        return self.update.size

    def ensure_storage(self, storage: NPStorage) -> NPStorage:
        """Φ(d) → Φ(d') exactly once per batch, shared across patterns.

        A window that nets to the empty update is a no-op: Φ(d') is
        Φ(d) itself, so no storage update (and no ``PROBE`` advance)
        happens — the watermark still moves, but nothing is recomputed.
        """
        if self.storage is None:
            if self.update.size == 0:
                self.storage = storage
                return self.storage
            self.storage, self.storage_report = storage.updated(self.update)
            probe_inc("storage_updates", metrics=self.metrics)
            self.stats = GraphStats.of(self.storage.graph)
            probe_inc("stats_refreshes", metrics=self.metrics)
        return self.storage

    def seed_provider(self, cover: Sequence[int], ord_: Sequence[Tuple[int, int]],
                      cache: "PartitionUnitCache | None" = None):
        """A memoizing Nav-join ``seed_fn`` for one pattern's (cover, ord).

        The plain (uncompressed) seed tables are shared across patterns;
        only the cheap VCBC regrouping is cover-specific. With ``cache``
        (the backend's delta-maintained
        :class:`~repro_torch.core.unit_cache.PartitionUnitCache`, already
        advanced to this batch's Φ(d')) the seeds are *derived* from the
        cached full per-partition unit tables by the inserted-edge row
        filter — re-listing only the partitions this delta invalidated
        instead of all ``m`` (byte-identical either way: the engine
        applies ``require_edge_codes`` as the same post-filter).
        """
        if self.storage is None:
            raise RuntimeError("call ensure_storage() before seed_provider()")
        if cache is not None and cache.storage is not self.storage:
            raise RuntimeError("unit cache is bound to a different Φ(d') "
                               "than this delta — advance() it first")
        storage = self.storage
        cover_t = tuple(sorted(int(c) for c in cover))
        ins_codes = self.add_codes
        sorted_codes = np.sort(np.asarray(ins_codes, np.int64).reshape(-1))

        def seed_fn(unit: R1Unit) -> CompressedTable:
            anchor = unit.anchor_in(cover_t)
            if anchor is None:
                raise ValueError("unit anchor must lie inside the cover")
            # Canonical memo key: the listing depends on the unit
            # pattern, the anchor, and the *set* of ord pairs restricted
            # to the unit's vertices (ord checks are conjunctive, so
            # pair order is irrelevant). Anything less (dropping the
            # anchor or the restricted ord) would serve a stale table to
            # a pattern sharing the unit shape; anything order-sensitive
            # would miss legitimate sharing across patterns.
            # _restrict_ord (shared with the unit cache, so the memo key
            # and the cache key can never diverge) already yields the
            # canonical frozenset.
            key = (unit.pattern.key(), anchor,
                   _restrict_ord(ord_, unit.pattern.vertices))
            if key not in self._seed_plain:
                probe_inc("seed_listings", metrics=self.metrics)
                cols: Tuple[int, ...] | None = None
                pieces = []
                for pi, part in enumerate(storage.parts):
                    if cache is not None:
                        cols, t = cache.unit_plain(pi, unit, anchor, ord_)
                        t = require_edge_rows(cols, t, unit.pattern, sorted_codes)
                    else:
                        cols, t = list_matches(
                            part, unit.pattern, ord_, anchor=anchor,
                            anchor_to_centers=True, require_edge_codes=ins_codes,
                        )
                    pieces.append(t)
                table = (np.concatenate(pieces, axis=0) if pieces
                         else np.empty((0, unit.pattern.n), np.int64))
                self._seed_plain[key] = (cols, table)
            cols, table = self._seed_plain[key]
            return compress_table(unit.pattern, cover_t, cols, table)

        return seed_fn


def compute_shared_delta(journal: UpdateJournal, lo: int, hi: int,
                         metrics: Optional[MetricsRegistry] = None) -> SharedDelta:
    """Decode one ``(lo, hi]`` journal window into a :class:`SharedDelta`."""
    update = journal.window(lo, hi)
    probe_inc("delta_decodes", metrics=metrics)
    return SharedDelta(
        lo=lo, hi=hi, update=update,
        add_codes=update.add_codes(), delete_codes=update.delete_codes(),
        metrics=metrics,
    )


@dataclasses.dataclass
class _PatternCost:
    pattern: Pattern
    ord_: Tuple[Tuple[int, int], ...]
    units: Tuple[R1Unit, ...]
    per_op: float = 1.0   # marginal cost of one more journal op in a batch
    fixed: float = 0.0    # batch-size-independent cost (chain unit listings)


class BatchScheduler:
    """Cost-model-seeded, latency-calibrated micro-batch sizing.

    ``target_cost`` is the per-batch work budget in estimator cost
    units; ``target_latency_s`` (optional) further shrinks batches once
    wall-clock observations exist. ``max_ops`` is the hard ceiling —
    the sharded backend sets it to its static ``UpdateShapes`` so a
    batch always fits the compiled device step.

    The `fixed` term of the §IV-D model (chain-step unit listings) is
    split into **cold** and **warm** halves: *cold* assumes every unit
    table is re-listed per batch (a cache-less backend, or one whose
    cache a batch fully invalidated), *warm* scales it by the miss rate
    the backend actually observes on its delta-maintained unit-table
    cache (:meth:`observe_cache`). On a steady-state stream where
    deltas dirty few partitions, warm `fixed` → ~0, so the budget binds
    on the marginal ``per_op`` term and micro-batches can shrink at
    constant throughput instead of being forced wide to amortize
    re-listing.
    """

    def __init__(
        self,
        target_cost: float = 250_000.0,
        target_latency_s: float | None = None,
        min_ops: int = 1,
        max_ops: int = 256,
    ):
        # Degenerate configs (0/negative bounds, zero budget) must not
        # collapse the batch size to 0 — that would spin advance()
        # forever — nor let it explode past the static device shapes.
        self.target_cost = max(float(target_cost), 1.0)
        self.target_latency_s = target_latency_s
        self.min_ops = max(1, int(min_ops))
        self.max_ops = max(self.min_ops, int(max_ops))
        self._patterns: Dict[str, _PatternCost] = {}
        self._sec_per_op: float | None = None   # EWMA of observed batch latency
        self._miss_rate: float | None = None    # EWMA of unit-cache miss rate
        # §IV-D cost-model drift monitor: `_unit_scale` calibrates cost
        # units (fixed_warm + k·per_op) to wall-clock seconds; each
        # observed batch is compared against the *pre-update* prediction
        # and the observed/predicted ratio feeds a drift EWMA — the
        # sensor the future online plan re-compiler reads (drift ≈ 1.0
        # means the model still describes this graph + hardware).
        self._unit_scale: float | None = None   # EWMA seconds per cost unit
        self._drift: float | None = None        # EWMA of observed/predicted
        self.last_predicted_s: float | None = None
        self.last_observed_s: float | None = None
        self.last_drift: float | None = None

    def clamp_max_ops(self, cap: int) -> None:
        """Impose a hard batch ceiling (e.g. a backend's static shapes),
        keeping ``min_ops ≤ max_ops ≥ 1`` invariant."""
        self.max_ops = max(1, min(self.max_ops, int(cap)))
        self.min_ops = min(self.min_ops, self.max_ops)

    # ---------------------------------------------------------------- model
    def register(self, name: str, pattern: Pattern,
                 ord_: Sequence[Tuple[int, int]], units: Sequence[R1Unit]) -> None:
        self._patterns[name] = _PatternCost(
            pattern=pattern, ord_=tuple(ord_), units=tuple(units))

    def unregister(self, name: str) -> None:
        self._patterns.pop(name, None)

    def refresh(self, stats: GraphStats) -> None:
        """Re-estimate batch cost terms from fresh graph stats (§IV-D).

        A micro-batch for one pattern costs ``fixed + k · per_op``:
        *fixed* is the chain-step unit listings of the Nav-join (every
        non-seed unit's ``M_ac`` table is listed per batch, independent
        of batch size — Eq. 10's local listing term), *per_op* is the
        seed matches one more inserted edge contributes, pushed through
        the chain (``|E(q)|·E|M(q,d)|/|E(d)|`` seeds per op per unit).
        """
        edges = max(stats.m, 1)
        for pc in self._patterns.values():
            chain = max(len(pc.units), 1)
            per_op = 0.0
            fixed = 0.0
            size_of = {u: match_size_estimate(u.pattern, pc.ord_, stats)
                       for u in pc.units}
            for u in pc.units:
                seeds_per_op = u.pattern.m * size_of[u] / edges
                per_op += seeds_per_op * u.pattern.n * chain
                fixed += sum(size_of[k] * k.pattern.n
                             for k in pc.units if k is not u)
            pc.per_op = max(per_op, 1.0)
            pc.fixed = fixed

    def cost_per_op(self) -> float:
        """Estimated marginal cost units per journal op, over all patterns."""
        return sum(pc.per_op for pc in self._patterns.values()) or 1.0

    def fixed_cost_cold(self) -> float:
        """Batch-size-independent cost with every unit table re-listed."""
        return sum(pc.fixed for pc in self._patterns.values())

    def fixed_miss_rate(self) -> float:
        """Calibrated fraction of unit tables a batch actually re-lists
        (1.0 until the backend reports cache observations)."""
        return 1.0 if self._miss_rate is None else self._miss_rate

    def fixed_cost_warm(self) -> float:
        """Cold `fixed` scaled by the observed cache-miss rate — the
        expected re-listing cost of the *next* batch."""
        return self.fixed_cost_cold() * self.fixed_miss_rate()

    def fixed_cost(self) -> float:
        """Estimated batch-size-independent cost units per micro-batch
        (the warm, hit-rate-calibrated term — what sizing decisions use)."""
        return self.fixed_cost_warm()

    # ------------------------------------------------------------- decisions
    def next_batch_size(self, pending: int) -> int:
        if pending <= 0:
            return 0
        fixed = self.fixed_cost()
        per_op = self.cost_per_op()
        if self.target_cost > fixed and per_op > 0:
            k = (self.target_cost - fixed) / per_op
        else:
            # The per-batch fixed cost alone blows the budget (or the
            # estimator degenerated to zero marginal cost — empty
            # graph): the only lever left is amortization — take the
            # largest batch allowed.
            k = float(self.max_ops)
        if (self.target_latency_s is not None
                and self._sec_per_op is not None and self._sec_per_op > 0):
            k = min(k, self.target_latency_s / self._sec_per_op)
        if not np.isfinite(k):
            k = float(self.max_ops)
        k = int(max(self.min_ops, min(self.max_ops, round(k))))
        return min(k, pending)

    def observe(self, n_ops: int, elapsed_s: float, alpha: float = 0.3) -> None:
        """Fold one measured batch into the wall-clock calibration.

        Batches that complete below clock resolution (``elapsed_s ≤ 0``)
        carry no calibration signal and are skipped — seeding the
        cold-start EWMA with a zero would poison every later average
        (and a zero ``_sec_per_op`` would otherwise make the latency
        target divide by zero / explode the batch size).
        """
        if n_ops <= 0 or not np.isfinite(elapsed_s):
            return
        per_op = elapsed_s / n_ops
        if per_op <= 0.0:
            return
        # Drift bookkeeping first, against the *pre-observation* model:
        # the prediction a caller could have made before this batch ran.
        units = self.fixed_cost() + n_ops * self.cost_per_op()
        pred = self.predict_seconds(n_ops)
        self.last_predicted_s = pred
        self.last_observed_s = elapsed_s
        if pred is not None and pred > 0:
            ratio = elapsed_s / pred
            self.last_drift = ratio
            self._drift = (ratio if self._drift is None
                           else (1 - alpha) * self._drift + alpha * ratio)
        if units > 0:
            scale = elapsed_s / units
            self._unit_scale = (scale if self._unit_scale is None
                                else (1 - alpha) * self._unit_scale + alpha * scale)
        if self._sec_per_op is None:
            self._sec_per_op = per_op
        else:
            self._sec_per_op = (1 - alpha) * self._sec_per_op + alpha * per_op

    def predict_seconds(self, n_ops: int) -> float | None:
        """§IV-D model prediction for a ``n_ops``-op batch in seconds:
        ``unit_scale · (fixed_warm + k · per_op)``. None until at least
        one batch has calibrated the cost-unit → seconds scale."""
        if self._unit_scale is None:
            return None
        return self._unit_scale * (self.fixed_cost()
                                   + max(int(n_ops), 0) * self.cost_per_op())

    def drift(self) -> float | None:
        """EWMA of observed/predicted batch latency (None until two
        calibrated batches exist). ≈1.0 while the cost model tracks
        reality; sustained excursions are the re-optimization trigger."""
        return self._drift

    def reset_drift(self) -> None:
        """Zero the drift EWMA (keep the wall-clock calibration). The
        plan manager calls this after a swap — the old drift measured
        the *old* plan, and carrying it over would immediately re-fire
        the trigger against the new one."""
        self._drift = None
        self.last_drift = None

    def observe_cache(self, hits: int, misses: int, alpha: float = 0.3) -> None:
        """Fold one batch's unit-cache hit/miss counts into the warm
        `fixed` calibration. Batches that consulted the cache zero times
        (no-op windows) carry no signal and are skipped.
        """
        total = int(hits) + int(misses)
        if total <= 0:
            return
        rate = float(np.clip(int(misses) / total, 0.0, 1.0))
        if self._miss_rate is None:
            self._miss_rate = rate
        else:
            self._miss_rate = (1 - alpha) * self._miss_rate + alpha * rate
