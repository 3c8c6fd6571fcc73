"""`ListingService` — continuous multi-pattern subgraph listing.

Host copy of ``repro/stream/service.py`` without ``ShardedBackend``, whose
twin is :class:`~repro_torch.backend.TorchBackend`. The streaming
composition of the paper's two stages::

    ingest()  →  UpdateJournal  →  BatchScheduler  →  SharedDelta
                                                        │ once per batch
                      ┌─────────────────────────────────┤
                      ▼                                 ▼
               HostBackend                        TorchBackend
         (NumPy Alg. 4 + Nav-join;       (device storage update step
          shared Φ(d') + seed cache +     once + ONE fused multi-pattern
          delta-maintained                maintain megastep over every
          PartitionUnitCache)             device-resident MatchStore +
                      │                   per-partition unit-table carries)
                      └────────────── sinks ────────────┘
                           (count deltas, match deltas)

Both backends obey the same contract (:class:`StreamBackend`): register
patterns, apply one shared delta to all of them, report per-pattern
results, and :meth:`~StreamBackend.materialize` full match tables only
on demand — the device backend keeps running match sets on the card
end to end and byte-accounts every device→host pull
(``BatchMetrics.host_bytes``). The service owns the journal, the
committed watermark, batch metrics, periodic from-scratch audits, and
sink fan-out. ``backend="sharded"`` builds the device backend, under the
name the reference uses, so callers and snapshots carry over unchanged;
snapshots are the reference's files, byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.ddsl import DDSL
from ..core.estimator import GraphStats
from ..core.graph import Graph, GraphUpdate, decode_edges, edge_codes
from ..core.incremental import removed_rows
from ..core.pattern import Pattern, R1Unit
from ..core.storage import build_np_storage
from ..core.unit_cache import PartitionUnitCache
from ..core.vcbc import CompressedTable, Ragged, compress_table
from ..obs import Observability
from ..planner import CompileContext, CompiledPlan, compile_plan
from .journal import UpdateJournal
from .scheduler import (
    BatchScheduler,
    SharedDelta,
    compute_shared_delta,
    probe_inc,
)
from .sinks import BatchEvent, Sink

__all__ = [
    "PatternMeta",
    "PatternReport",
    "BatchMetrics",
    "StreamBackend",
    "HostBackend",
    "ListingService",
]


@dataclasses.dataclass(frozen=True)
class PatternMeta:
    """Static per-pattern facts shared by backends, scheduler, audits.

    ``cover``/``ord_``/``units`` are views into ``plan`` (kept flat
    because every consumer reads them); the full
    :class:`~repro_torch.planner.CompiledPlan` — tree, IR program, caps,
    per-pass report — rides along for the obs export and plan swaps.
    """

    name: str
    pattern: Pattern
    cover: Tuple[int, ...]
    ord_: Tuple[Tuple[int, int], ...]
    units: Tuple[R1Unit, ...]
    plan: Optional[CompiledPlan] = None


@dataclasses.dataclass
class PatternReport:
    """One pattern's outcome for one committed micro-batch."""

    name: str
    count_before: int
    count_after: int
    latency_s: float
    patch_groups: int = 0
    removed_groups: int = 0
    overflow: int = 0
    added: Optional[np.ndarray] = None
    removed: Optional[np.ndarray] = None


@dataclasses.dataclass
class BatchMetrics:
    """Service-level record of one committed micro-batch."""

    batch_index: int
    lo: int
    hi: int
    n_ops: int
    net_add: int
    net_delete: int
    latency_s: float
    patterns: Dict[str, PatternReport]
    storage_overflow: int = 0   # device storage-step overflow (once per batch)
    # Candidate-set sizes of the delta-restricted device update (C1–C3);
    # -1 where not applicable (host backend / full-gather mode). Reset
    # every micro-batch — these are per-batch sizes, not running totals.
    cand_vertices: int = -1
    cand_edges: int = -1
    # Bytes of match/patch state pulled device→host while applying this
    # batch (sharded backend; always 0 on the host backend). Count-only
    # batches keep the running match sets on the mesh, so this is 0
    # unless a sink demanded decompressed rows — asserted in tests.
    host_bytes: int = 0
    # Delta-maintained unit-table cache traffic of this batch: tables
    # served from cache vs re-listed, and partitions the netted delta
    # invalidated. On a warm stream cache_misses is bounded by
    # |units| · invalidated_parts — the §IV-D `fixed` term scales with
    # the delta, not the graph. -1 where the backend has no cache.
    cache_hits: int = -1
    cache_misses: int = -1
    invalidated_parts: int = -1
    # §IV-D scheduler prediction for this batch (seconds); -1 until the
    # cost-unit → wall-clock scale is calibrated (first batches). The
    # drift EWMA over observed/predicted is the scheduler gauge.
    predicted_s: float = -1.0

    @property
    def throughput_ops_s(self) -> float:
        # Batches finishing below clock resolution have no measurable
        # rate: report 0.0, never inf (they are likewise excluded from
        # the throughput gauge — dashboards must not render infinities).
        return self.n_ops / self.latency_s if self.latency_s > 0 else 0.0

    @property
    def overflow(self) -> int:
        return self.storage_overflow + sum(r.overflow for r in self.patterns.values())


def _save_table(path: str, table: CompressedTable) -> None:
    """One pattern's compressed match set as an ``.npz`` (snapshot half;
    the pattern itself travels in the snapshot's ``meta.json``)."""
    arrs = {
        "skeleton": np.asarray(table.skeleton, np.int64),
        "skeleton_cols": np.asarray(table.skeleton_cols, np.int64),
        "cover": np.asarray(table.cover, np.int64),
        "comp_labels": np.asarray(sorted(table.comp), np.int64),
    }
    for v, r in table.comp.items():
        arrs[f"offsets_{int(v)}"] = np.asarray(r.offsets, np.int64)
        arrs[f"values_{int(v)}"] = np.asarray(r.values, np.int64)
    np.savez(path, **arrs)


def _load_table(path: str, pattern: Pattern) -> CompressedTable:
    z = np.load(path)
    comp = {int(v): Ragged(offsets=z[f"offsets_{int(v)}"],
                           values=z[f"values_{int(v)}"])
            for v in z["comp_labels"]}
    return CompressedTable(
        pattern=pattern,
        cover=tuple(int(c) for c in z["cover"]),
        skeleton_cols=tuple(int(c) for c in z["skeleton_cols"]),
        skeleton=z["skeleton"], comp=comp,
    )


def _meta_from_plan(name: str, plan: CompiledPlan) -> PatternMeta:
    return PatternMeta(name=name, pattern=plan.pattern, cover=plan.cover,
                       ord_=plan.ord, units=plan.units, plan=plan)


class StreamBackend:
    """Interface both execution backends implement (duck-typed)."""

    #: scheduler batch ceiling imposed by static shapes (None = unbounded)
    max_batch_ops: Optional[int] = None
    #: whether this process writes the service's files (snapshots): of the
    #: ranks of a process mesh, which all run the same service, rank 0 alone
    writes_files: bool = True
    #: the owning service's observability object. The service assigns it
    #: in ``__init__`` (before any pattern registers); a backend driven
    #: standalone lazily grows its own default (registry on, tracing
    #: off) so instrumentation never needs None guards.
    obs: Optional[Observability] = None
    #: overflow of the last batch's shared (pattern-independent) storage
    #: update — reported once per batch, not per pattern
    last_storage_overflow: int = 0
    #: device→host bytes of the last batch / of the backend's lifetime.
    #: Host backends never move anything (0); sharded backends account
    #: every match-set / patch materialization here.
    last_host_bytes: int = 0
    total_host_bytes: int = 0
    #: unit-table cache traffic of the last batch (-1 = no cache)
    last_cache_hits: int = -1
    last_cache_misses: int = -1
    last_invalidated_parts: int = -1

    def _obs(self) -> Observability:
        o = self.obs
        if o is None:
            o = self.obs = Observability()
        return o

    def _jaxprof(self):
        """Late-bound profiler resolver for :class:`ProfiledStep` — the
        service attaches ``obs`` after backend construction, so wrapped
        steps must look it up at call time."""
        o = self.obs
        return o.jaxprof if o is not None else None

    def register(self, name: str, pattern: Pattern, cover=None) -> int:
        raise NotImplementedError

    def compile(self, pattern: Pattern, cover=None,
                stats: GraphStats | None = None,
                objective: str = "r_lower") -> CompiledPlan:
        """Run the staged plan compiler against this backend's machine
        shape (mesh width, engine caps, store headroom). The **single
        entry point** for plan construction: register, restore, and the
        plan manager's live recompiles all come through here, so no two
        paths can ever pick different trees from the same stats.
        ``objective`` is the free-cover policy (§IV-F ``"r_lower"``
        storage argmax, or ``"cost"`` — the Eq. 11 runtime argmin the
        online re-optimizer uses)."""
        raise NotImplementedError

    def plan(self, name: str) -> Optional[CompiledPlan]:
        """The compiled plan the pattern is currently executing."""
        return self.meta(name).plan

    def remove_pattern(self, name: str) -> None:
        """Forget a pattern (engine/device state and counts). The swap
        half-step between :meth:`materialize` and :meth:`install_plan`;
        the caller owns scheduler bookkeeping."""
        raise NotImplementedError

    def install_plan(self, name: str, plan: CompiledPlan, table) -> int:
        """Install a precompiled plan with a known match set at the
        committed watermark (``table.cover`` must equal ``plan.cover``)
        — :meth:`restore_pattern` with the compile step factored out, so
        a plan swap can install the exact plan it costed."""
        raise NotImplementedError

    def apply_batch(self, delta: SharedDelta, want_matches) -> Dict[str, PatternReport]:
        raise NotImplementedError

    def materialize(self, name: str):
        """The pattern's current match set as a host
        :class:`~repro_torch.core.vcbc.CompressedTable` — the **on-demand**
        half of the contract. Backends keeping results device-resident
        pull (and byte-account) them only when this is called; sinks
        that set ``wants_matches`` and from-scratch parity checks are
        the intended triggers."""
        raise NotImplementedError

    def restore_pattern(self, name: str, pattern: Pattern,
                        cover: Tuple[int, ...], table) -> int:
        """Register a pattern whose match set is already known (a
        snapshot table at the service's committed watermark) — skips the
        from-scratch initial listing."""
        raise NotImplementedError

    def _noop_reports(self) -> Dict[str, PatternReport]:
        """Per-pattern reports for a window that netted to the empty
        update: counts unchanged, no deltas, no device/engine work."""
        return {name: PatternReport(
            name=name, count_before=self.count(name),
            count_after=self.count(name), latency_s=0.0,
        ) for name in self.names()}

    def meta(self, name: str) -> PatternMeta:
        raise NotImplementedError

    def count(self, name: str) -> int:
        raise NotImplementedError

    def names(self) -> List[str]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Host backend: NumPy engines over one shared NP storage
# ---------------------------------------------------------------------------

class HostBackend(StreamBackend):
    """All patterns share one Φ(d); Alg. 4 runs once per batch.

    One :class:`~repro_torch.core.unit_cache.PartitionUnitCache` fronts every
    per-partition unit listing of every registered pattern: Nav-join
    chain steps and seed derivations pull through it, and each batch
    invalidates exactly the partitions its Alg. 4 update dirtied
    (``UpdateCostReport.dirty_parts``) — the §IV-D `fixed` term becomes
    delta-bounded. Cached and uncached paths byte-match at every
    watermark (property-tested).
    """

    kind = "host"

    def __init__(self, graph: Graph, m: int = 4, h=None,
                 cache_max_entries: Optional[int] = None,
                 cache_max_bytes: Optional[int] = None,
                 executor: str = "tree"):
        self.executor = executor
        self.storage = build_np_storage(graph, m, h)
        self.unit_cache = PartitionUnitCache(
            self.storage, max_entries=cache_max_entries,
            max_bytes=cache_max_bytes)
        self.engines: Dict[str, DDSL] = {}
        self._meta: Dict[str, PatternMeta] = {}
        self._counts: Dict[str, int] = {}   # carried across batches

    @property
    def m(self) -> int:
        return self.storage.m

    @property
    def graph(self) -> Graph:
        return self.storage.graph

    def compile(self, pattern: Pattern, cover=None,
                stats: GraphStats | None = None,
                objective: str = "r_lower") -> CompiledPlan:
        return compile_plan(CompileContext(
            pattern=pattern,
            stats=stats if stats is not None else GraphStats.of(self.graph),
            m=self.m,
            cover=tuple(sorted(int(c) for c in cover)) if cover is not None else None,
            cover_objective=objective,
            executor=self.executor,
        ))

    def register(self, name: str, pattern: Pattern, cover=None) -> int:
        if name in self.engines:
            raise ValueError(f"pattern {name!r} already registered")
        meta = _meta_from_plan(name, self.compile(pattern, cover))
        eng = DDSL(self.graph, pattern, m=self.m, storage=self.storage,
                   plan=meta.plan)
        eng.initial()
        self.engines[name] = eng
        self._meta[name] = meta
        self._counts[name] = eng.count()
        return self._counts[name]

    def restore_pattern(self, name: str, pattern: Pattern,
                        cover: Tuple[int, ...], table) -> int:
        return self.install_plan(name, self.compile(pattern, cover), table)

    def install_plan(self, name: str, plan: CompiledPlan, table) -> int:
        if name in self.engines:
            raise ValueError(f"pattern {name!r} already registered")
        if table.cover != plan.storage_cover:
            # Snapshot from a different cover or executor mode (WCOJ
            # stores under trivial compression) — recompress to the
            # plan's storage layout.
            cols, rows = table.decompress(plan.ord)
            table = compress_table(plan.pattern, plan.storage_cover, cols, rows)
        meta = _meta_from_plan(name, plan)
        eng = DDSL(self.graph, plan.pattern, m=self.m, storage=self.storage,
                   plan=plan)
        eng.state.matches = table          # the known table replaces initial()
        self.engines[name] = eng
        self._meta[name] = meta
        self._counts[name] = eng.count()
        return self._counts[name]

    def remove_pattern(self, name: str) -> None:
        del self.engines[name]
        del self._meta[name]
        del self._counts[name]

    def meta(self, name: str) -> PatternMeta:
        return self._meta[name]

    def names(self) -> List[str]:
        return list(self.engines)

    def count(self, name: str) -> int:
        return self._counts[name]

    def materialize(self, name: str):
        return self.engines[name].state.matches

    def matches_plain(self, name: str) -> np.ndarray:
        return self.engines[name].matches_plain()

    def apply_batch(self, delta: SharedDelta, want_matches) -> Dict[str, PatternReport]:
        obs = self._obs()
        tr = obs.tracer
        self.last_cache_hits = 0
        self.last_cache_misses = 0
        self.last_invalidated_parts = 0
        if delta.update.size == 0:
            # The window netted to nothing: Φ, stats, and every match
            # set are unchanged — commit the watermark without work
            # (the unit cache stays fully warm too).
            return self._noop_reports()
        ev0 = self.unit_cache.stats.evictions
        with tr.span("storage_update") as ssp:
            storage2 = delta.ensure_storage(self.storage)   # Alg. 4 — once
            # Advance the unit-table cache to Φ(d'): exactly the
            # partitions whose stored edge set changed lose their cached
            # listings.
            dirty = (delta.storage_report.dirty_parts
                     if delta.storage_report is not None
                     else tuple(range(self.storage.m)))
            stats0 = self.unit_cache.stats.snapshot()
            self.unit_cache.advance(storage2, dirty)
            ssp.add("dirty_parts", len(dirty))
        reports: Dict[str, PatternReport] = {}
        for name, eng in self.engines.items():
            with tr.span("maintain", pattern=name) as msp:
                t0 = time.perf_counter()
                before = self._counts[name]
                want = name in want_matches
                removed = (removed_rows(eng.state.matches, delta.update.delete, eng.ord_)
                           if want else None)
                rep = eng.apply_shared(
                    storage2, delta.update,
                    stats=delta.stats, storage_report=delta.storage_report,
                    seed_fn=delta.seed_provider(eng.cover, eng.ord_,
                                                cache=self.unit_cache),
                    provider=self.unit_cache,
                )
                added = rep.patch.decompress(eng.ord_)[1] if (want and rep.patch is not None) else None
                self._counts[name] = eng.count()
                patch_groups = rep.patch.n_groups if rep.patch is not None else 0
                msp.add("patch_groups", patch_groups)
                msp.add("removed_groups", rep.removed_groups)
                reports[name] = PatternReport(
                    name=name, count_before=before, count_after=self._counts[name],
                    latency_s=time.perf_counter() - t0,
                    patch_groups=patch_groups,
                    removed_groups=rep.removed_groups,
                    added=added, removed=removed,
                )
        self.storage = storage2
        hits, misses, inval = (b - a for a, b in
                               zip(stats0, self.unit_cache.stats.snapshot()))
        self.last_cache_hits = hits
        self.last_cache_misses = misses
        self.last_invalidated_parts = inval
        probe_inc("cache_hits", hits, metrics=obs.metrics)
        probe_inc("cache_misses", misses, metrics=obs.metrics)
        probe_inc("invalidated_parts", inval, metrics=obs.metrics)
        evictions = self.unit_cache.stats.evictions - ev0
        if evictions:
            obs.metrics.counter(
                "unit_cache_evictions_total",
                "unit-cache LRU evictions under the entry/byte budget",
            ).inc(evictions)
        obs.metrics.gauge(
            "unit_cache_resident_bytes",
            "bytes held by cached unit tables (plain + compressed)",
        ).set(self.unit_cache.resident_bytes)
        obs.metrics.gauge(
            "unit_cache_entries", "live plain unit-cache entries",
        ).set(self.unit_cache.entries())
        return reports


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------

class ListingService:
    """Continuous multi-pattern subgraph listing over a dynamic graph.

    ``ingest()`` appends edge operations to the journal (validated
    against the *projected* graph — the committed graph plus everything
    pending); ``advance()`` folds pending operations into every
    registered pattern's match set in scheduler-chosen micro-batches,
    computing the decoded update delta **once per batch**; ``counts()``
    reads the live results. Sinks observe per-batch result deltas;
    ``audit_every > 0`` re-lists one pattern from scratch every N
    batches and raises on divergence.
    """

    def __init__(
        self,
        graph: Graph,
        m: int = 4,
        backend: str | StreamBackend = "host",
        scheduler: BatchScheduler | None = None,
        audit_every: int = 0,
        obs: Observability | None = None,
        plan_manager=None,
        **backend_kwargs,
    ):
        # One observability object per service — its own metrics
        # registry (two services in one process never share counters),
        # span tracer (off by default), device profiler. Pass
        # Observability.full() for span tracing, .disabled() to turn
        # every channel off.
        self.obs = obs if obs is not None else Observability()
        if isinstance(backend, str):
            if backend == "host":
                backend_obj: StreamBackend = HostBackend(graph, m=m, **backend_kwargs)
            elif backend == "sharded":
                # The device backend (the reference's ShardedBackend twin),
                # imported here because it imports this package. `m` here
                # is the host partition count; the device backend's own
                # defaults to 8 — pass m via backend_kwargs to override it.
                from ..backend import TorchBackend

                backend_obj = TorchBackend(graph, **backend_kwargs)
            else:
                raise ValueError(f"unknown backend {backend!r}")
        else:
            backend_obj = backend
        self.backend = backend_obj
        # Attach before any register() call so initial listings and
        # device-step compiles are profiled into this service's books.
        self.backend.obs = self.obs
        self.journal = UpdateJournal()
        self.scheduler = scheduler if scheduler is not None else BatchScheduler()
        if self.backend.max_batch_ops is not None:
            self.scheduler.clamp_max_ops(self.backend.max_batch_ops)
        self.audit_every = int(audit_every)
        self.metrics: List[BatchMetrics] = []
        self.audits: List[Tuple[int, str, bool]] = []   # (batch_index, pattern, ok)
        self.sinks: List[Sink] = []
        self._graph = graph                   # committed graph mirror
        self._proj_codes = set(int(c) for c in graph.codes)
        self._proj_n = graph.n
        self._committed = 0
        self._batches = 0
        self._audit_rr = 0
        #: optional drift-triggered online re-optimizer
        #: (:class:`repro_torch.stream.plan_manager.PlanManager`); consulted
        #: after every committed batch.
        self.plan_manager = plan_manager

    # -------------------------------------------------------------- patterns
    def register(self, name: str, pattern: Pattern, cover=None) -> int:
        """Register a pattern; returns its initial match count.

        Patterns join at the *committed* watermark: the initial listing
        runs over the committed graph, and pending journal operations
        apply to the new pattern on the next :meth:`advance` like to
        every other.
        """
        count = self.backend.register(name, pattern, cover)
        meta = self.backend.meta(name)
        self.scheduler.register(name, pattern, meta.ord_, meta.units)
        self.scheduler.refresh(GraphStats.of(self._graph))
        if meta.plan is not None:
            self.obs.record_plan(name, meta.plan.to_json())
        return count

    def patterns(self) -> List[str]:
        return self.backend.names()

    # ---------------------------------------------------------------- ingest
    def ingest(self, update: GraphUpdate | None = None, *,
               add: Iterable = (), delete: Iterable = ()) -> int:
        """Append one update to the journal; returns the tail watermark.

        Validated against the projected graph so any window of the
        journal nets to a well-formed Alg. 4 batch.
        """
        if update is None:
            update = GraphUpdate.make(delete=delete, add=add)
        d_codes = [int(c) for c in edge_codes(np.asarray(update.delete))]
        a_codes = [int(c) for c in edge_codes(np.asarray(update.add))]
        # Duplicates inside one update would double-journal an op and
        # flip the parity netting, desyncing projection from commit.
        if len(set(d_codes)) != len(d_codes) or len(set(a_codes)) != len(a_codes):
            raise ValueError("update contains duplicate edges")
        for c in d_codes:
            if c not in self._proj_codes:
                raise ValueError(f"delete of absent edge {tuple(decode_edges(np.array([c]))[0])}")
        for c in a_codes:
            if c in self._proj_codes:
                raise ValueError(f"insert of present edge {tuple(decode_edges(np.array([c]))[0])}")
        if len(set(d_codes) & set(a_codes)):
            raise ValueError("E_d(U) and E_a(U) must be disjoint")
        self._proj_codes.difference_update(d_codes)
        self._proj_codes.update(a_codes)
        if np.asarray(update.add).size:
            self._proj_n = max(self._proj_n, int(np.asarray(update.add).max()) + 1)
        return self.journal.append(update)

    # --------------------------------------------------------------- advance
    def _wanted(self) -> set:
        want = set()
        for s in self.sinks:
            if s.wants_matches:
                for name in self.backend.names():
                    if s.accepts(name):
                        want.add(name)
        return want

    def advance(self, watermark: int | None = None) -> List[BatchMetrics]:
        """Fold pending journal ops (up to ``watermark``) into all match
        sets, one scheduler-sized micro-batch at a time."""
        target = self.journal.tail if watermark is None else min(int(watermark), self.journal.tail)
        done: List[BatchMetrics] = []
        want = self._wanted()
        tr = self.obs.tracer
        mreg = self.obs.metrics
        while self._committed < target:
            k = self.scheduler.next_batch_size(target - self._committed)
            hi = self._committed + k
            predicted = self.scheduler.predict_seconds(k)
            self.obs.jaxprof.on_batch_start(self._batches)
            with tr.span("batch", batch_index=self._batches,
                         lo=self._committed, hi=hi) as bsp:
                t0 = time.perf_counter()
                with tr.span("shared_delta") as dsp:
                    delta = compute_shared_delta(self.journal, self._committed,
                                                 hi, metrics=mreg)
                    dsp.add("net_add", int(np.asarray(delta.update.add).shape[0]))
                    dsp.add("net_delete",
                            int(np.asarray(delta.update.delete).shape[0]))
                reports = self.backend.apply_batch(delta, want)
                latency = time.perf_counter() - t0
                self.scheduler.observe(k, latency)
                # Both backends already advanced their committed graph
                # while applying the batch — reuse it instead of a
                # second rebuild.
                self._graph = self.backend.graph
                # host backend shares the delta's stats; the sharded
                # backend never materializes Φ(d') on host, so refresh
                # from the mirror
                self.scheduler.refresh(
                    delta.stats if delta.stats is not None else GraphStats.of(self._graph))
                bm = BatchMetrics(
                    batch_index=self._batches, lo=self._committed, hi=hi,
                    n_ops=k, net_add=int(np.asarray(delta.update.add).shape[0]),
                    net_delete=int(np.asarray(delta.update.delete).shape[0]),
                    latency_s=latency, patterns=reports,
                    storage_overflow=getattr(self.backend, "last_storage_overflow", 0),
                    cand_vertices=getattr(self.backend, "last_cand_vertices", -1),
                    cand_edges=getattr(self.backend, "last_cand_edges", -1),
                    host_bytes=getattr(self.backend, "last_host_bytes", 0),
                    cache_hits=getattr(self.backend, "last_cache_hits", -1),
                    cache_misses=getattr(self.backend, "last_cache_misses", -1),
                    invalidated_parts=getattr(self.backend, "last_invalidated_parts", -1),
                    predicted_s=predicted if predicted is not None else -1.0,
                )
                if bm.cache_hits >= 0:
                    # Calibrate the scheduler's warm `fixed` term from
                    # the observed unit-cache traffic (no-op batches
                    # carry none).
                    self.scheduler.observe_cache(bm.cache_hits, bm.cache_misses)
                self._record_batch(bm, bsp)
                self.metrics.append(bm)
                done.append(bm)
                self._committed = hi
                self._batches += 1
                with tr.span("sinks") as ksp:
                    self._emit(bm, delta)
                    ksp.add("sinks", len(self.sinks))
            self.obs.jaxprof.on_batch_end(self._batches - 1)
            if self.audit_every and self._batches % self.audit_every == 0:
                self._periodic_audit()
            if self.plan_manager is not None:
                # Between batches = at the committed watermark, the only
                # point where a plan swap is collective-safe.
                self.plan_manager.on_batch(self)
        return done

    def _record_batch(self, bm: BatchMetrics, bsp) -> None:
        """Fold one committed batch into the service's instruments (and
        annotate its root span so span counters reconcile with registry
        deltas — asserted in tests)."""
        m = self.obs.metrics
        m.counter("stream_batches_total", "committed micro-batches").inc()
        m.counter("stream_ops_total", "journal ops committed").inc(bm.n_ops)
        m.gauge("stream_watermark_lag",
                "journal ops ingested but not yet committed",
                ).set(self.journal.tail - bm.hi)
        if bm.latency_s > 0:
            # Below-clock-resolution batches carry no rate signal: they
            # are excluded from the throughput gauge and the latency
            # histogram rather than rendering as infinities.
            m.histogram("stream_batch_latency_seconds",
                        "end-to-end latency per committed micro-batch",
                        ).observe(bm.latency_s)
            m.gauge("stream_throughput_ops_per_s",
                    "ops/s of the last measurable batch",
                    ).set(bm.throughput_ops_s)
        for name, rep in bm.patterns.items():
            if rep.latency_s > 0:
                m.histogram("stream_pattern_latency_seconds",
                            "per-pattern maintain latency",
                            labels=("pattern",),
                            ).labels(pattern=name).observe(rep.latency_s)
        if bm.overflow:
            m.counter("stream_overflow_total",
                      "summed device cap overflow across batches",
                      ).inc(bm.overflow)
        if bm.cand_vertices >= 0:
            m.gauge("stream_cand_vertices",
                    "candidate vertex-set size of the last delta batch",
                    ).set(bm.cand_vertices)
            m.gauge("stream_cand_edges",
                    "candidate edge-set size of the last delta batch",
                    ).set(bm.cand_edges)
        if bm.predicted_s >= 0:
            m.gauge("scheduler_predicted_seconds",
                    "§IV-D model prediction for the last batch",
                    ).set(bm.predicted_s)
        drift = self.scheduler.drift()
        if drift is not None:
            m.gauge("scheduler_drift_ewma",
                    "EWMA of observed/predicted batch latency — the "
                    "cost-model drift sensor for plan re-optimization",
                    ).set(drift)
        # Root-span counters mirror the registry deltas of this batch.
        bsp.add("n_ops", bm.n_ops)
        bsp.add("net_add", bm.net_add)
        bsp.add("net_delete", bm.net_delete)
        bsp.add("host_bytes", bm.host_bytes)
        if bm.cache_hits >= 0:
            bsp.add("cache_hits", bm.cache_hits)
            bsp.add("cache_misses", bm.cache_misses)
            bsp.add("invalidated_parts", bm.invalidated_parts)

    def _emit(self, bm: BatchMetrics, delta: SharedDelta) -> None:
        for name, rep in bm.patterns.items():
            accepting = [s for s in self.sinks if s.accepts(name)]
            if not accepting:
                continue
            ev = BatchEvent(
                batch_index=bm.batch_index, lo=bm.lo, hi=bm.hi, pattern=name,
                count_before=rep.count_before, count_after=rep.count_after,
                n_ops=bm.n_ops, net_add=bm.net_add, net_delete=bm.net_delete,
                latency_s=rep.latency_s, overflow=rep.overflow,
                added=rep.added, removed=rep.removed,
            )
            for s in accepting:
                s.emit(ev)
            # Retained metrics keep scalars only; the decompressed row
            # deltas live as long as the sinks want them, not forever.
            rep.added = None
            rep.removed = None

    # ---------------------------------------------------------------- results
    def count(self, name: str) -> int:
        return self.backend.count(name)

    def counts(self) -> Dict[str, int]:
        return {name: self.backend.count(name) for name in self.backend.names()}

    def subscribe(self, sink: Sink) -> Sink:
        self.sinks.append(sink)
        return sink

    # ----------------------------------------------------------------- state
    @property
    def committed_watermark(self) -> int:
        return self._committed

    @property
    def graph(self) -> Graph:
        """The committed graph (watermark ``committed_watermark``)."""
        return self._graph

    def projected_graph(self) -> Graph:
        """The graph at the journal tail (committed + pending)."""
        codes = np.array(sorted(self._proj_codes), np.int64)
        return Graph._from_codes(self._proj_n, codes)

    def compact(self) -> int:
        """Truncate the journal below the committed watermark."""
        return self.journal.truncate(self._committed)

    # ------------------------------------------------------------ durability
    _SNAP_MAGIC = "repro.stream.snapshot"

    def snapshot(self, path: str) -> str:
        """Persist the service at its committed watermark into ``path``.

        A snapshot is exactly *materialize() per pattern + journal
        save*: ``graph.npz`` (the committed graph), one
        ``matches_<name>.npz`` per pattern (its compressed match set —
        the sharded backend pulls it through the byte-accounted
        :meth:`~StreamBackend.materialize` contract), ``journal.jsonl``
        (including any ops still pending beyond the watermark — they
        replay after restore), and ``meta.json`` naming the watermark
        and the registered patterns. ``meta.json`` is written last and
        atomically, so its presence is the commit record: a crash
        mid-snapshot leaves no half-snapshot that :meth:`restore` would
        accept — and re-snapshotting into a used directory deletes the
        old ``meta.json`` *first*, so a crash mid-rewrite can never
        leave a stale commit record pointing at newer artifacts.

        On the ranks of a process mesh every rank materializes (a
        collective) and rank 0 alone writes (``backend.writes_files``).
        """
        write = self.backend.writes_files
        meta_path = os.path.join(path, "meta.json")
        if write:
            os.makedirs(path, exist_ok=True)
            if os.path.exists(meta_path):
                os.remove(meta_path)
            self.journal.save(os.path.join(path, "journal.jsonl"))
            np.savez(os.path.join(path, "graph.npz"),
                     codes=np.asarray(self._graph.codes, np.int64),
                     n=np.int64(self._graph.n))
        patterns = []
        for name in self.backend.names():
            meta = self.backend.meta(name)
            table = self.backend.materialize(name)
            if write:
                _save_table(os.path.join(path, f"matches_{name}.npz"), table)
            patterns.append({
                "name": name,
                "edges": sorted([int(a), int(b)] for a, b in meta.pattern.edges),
                "cover": [int(c) for c in meta.cover],
            })
        if not write:
            return path
        head = {"kind": self._SNAP_MAGIC, "version": 1,
                "watermark": int(self._committed), "patterns": patterns}
        tmp = f"{meta_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(head, f, indent=2, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, meta_path)
        return path

    @classmethod
    def restore(cls, path: str, backend: str | StreamBackend = "host",
                scheduler: BatchScheduler | None = None, audit_every: int = 0,
                **backend_kwargs) -> "ListingService":
        """Rebuild a service from a :meth:`snapshot` and resume.

        The backend is reconstructed over the snapshot graph and each
        pattern's match set is installed without a from-scratch listing
        (the device backend rebuilds its
        :class:`~repro_torch.sharded.MatchStore` via ``stack_matches``
        and cold-fills its unit-table carries with one refresh step).
        Journal ops pending beyond the snapshot watermark survive and
        fold in on the next :meth:`advance` — the restored service is
        indistinguishable from one that never stopped (parity-tested).
        The restore backend may differ from the snapshot's (e.g. host
        snapshot → sharded restore): a snapshot is backend-neutral.
        """
        with open(os.path.join(path, "meta.json")) as f:
            head = json.load(f)
        if head.get("kind") != cls._SNAP_MAGIC:
            raise ValueError(f"{path} is not a service snapshot")
        if head.get("version") != 1:
            raise ValueError(
                f"{path}: unsupported snapshot version {head.get('version')!r}")
        gz = np.load(os.path.join(path, "graph.npz"))
        graph = Graph._from_codes(int(gz["n"]), gz["codes"].astype(np.int64))
        svc = cls(graph, backend=backend, scheduler=scheduler,
                  audit_every=audit_every, **backend_kwargs)
        svc.journal = UpdateJournal.load(os.path.join(path, "journal.jsonl"))
        w = int(head["watermark"])
        if w < svc.journal.base:
            raise ValueError(
                f"snapshot watermark {w} precedes journal base {svc.journal.base}")
        svc._committed = w
        for spec in head["patterns"]:
            pat = Pattern.make([tuple(e) for e in spec["edges"]])
            table = _load_table(
                os.path.join(path, f"matches_{spec['name']}.npz"), pat)
            svc.backend.restore_pattern(
                spec["name"], pat, tuple(int(c) for c in spec["cover"]), table)
            meta = svc.backend.meta(spec["name"])
            svc.scheduler.register(spec["name"], pat, meta.ord_, meta.units)
            if meta.plan is not None:
                svc.obs.record_plan(spec["name"], meta.plan.to_json())
        svc.scheduler.refresh(GraphStats.of(graph))
        if svc.journal.tail > w:
            # pending ops re-project on top of the committed graph
            proj = graph.apply_update(svc.journal.window(w))
            svc._proj_codes = {int(c) for c in proj.codes}
            svc._proj_n = proj.n
        return svc

    # ----------------------------------------------------------------- audit
    def audit(self, names: Sequence[str] | None = None,
              raise_on_mismatch: bool = True) -> Dict[str, bool]:
        """From-scratch re-listing on the committed graph vs. live counts."""
        out = {}
        for name in (names if names is not None else self.backend.names()):
            meta = self.backend.meta(name)
            fresh = DDSL(self._graph, meta.pattern, m=4, cover=meta.cover)
            fresh.initial()
            ok = fresh.count() == self.backend.count(name)
            out[name] = ok
            if not ok and raise_on_mismatch:
                raise RuntimeError(
                    f"audit mismatch for {name!r}: incremental={self.backend.count(name)} "
                    f"from-scratch={fresh.count()} at watermark {self._committed}")
        return out

    def _periodic_audit(self) -> None:
        names = self.backend.names()
        if not names:
            return
        name = names[self._audit_rr % len(names)]
        self._audit_rr += 1
        # Record the verdict first so a divergence is visible in
        # `audits` even though it also aborts the service.
        ok = self.audit([name], raise_on_mismatch=False)[name]
        self.audits.append((self._batches - 1, name, ok))
        if not ok:
            raise RuntimeError(
                f"periodic audit mismatch for {name!r} at watermark {self._committed}")
