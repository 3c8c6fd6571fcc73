"""Drift-triggered online join-tree re-optimization.

Host copy of ``repro/stream/plan_manager.py``.

DDSL picks the optimal join tree once, from initial
:class:`~repro_torch.core.estimator.GraphStats` — on a drifting stream the
tree goes stale. :class:`PlanManager` closes the loop the scheduler's
§IV-D monitor opened: every committed batch it reads the
observed/predicted drift EWMA (``scheduler_drift_ewma``), and when it
crosses ``drift_threshold`` — or every ``recost_every`` watermarks as a
slow heartbeat — it re-runs the staged plan compiler
(:func:`repro_torch.planner.compile_plan`, via the backend's single
``compile`` entry point) from *live* stats and compares the candidate
against the incumbent **re-costed under the same live stats** (Eq. 11 is
only comparable at one stats snapshot).

A winning candidate is hot-swapped at the committed watermark — the only
collective-safe point — without any from-scratch listing::

    materialize(name)            # running table, device pulls byte-accounted
    recompress under new cover   # exact: a vertex cover touches every
                                 # edge, so VCBC regrouping loses nothing
    remove_pattern(name)
    install_plan(name, cand, table)   # host: new DDSL around the same
                                 # table; sharded: stack_matches + one
                                 # unit-carry refresh
    scheduler re-register + reset_drift()

The swap is delta-cheap (one table regroup + one carry refresh, no
re-listing) and byte-verified in tests against ``DDSL.initial()`` on the
replayed graph. Observability: ``plan_recompiles_total`` /
``plan_swaps_total`` counters, a ``plan_swap`` span, and the new plan's
dump re-recorded for the export bundle.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

from ..core.cost import CostModel
from ..core.estimator import GraphStats
from ..core.join_tree import JoinTree
from ..core.vcbc import compress_table
from ..planner.sizing import wcoj_prefix_estimates

__all__ = ["PlanManager", "SwapEvent", "recost_tree"]


def recost_tree(tree: JoinTree, cover: Sequence[int],
                ord_: Sequence[Tuple[int, int]], stats: GraphStats) -> float:
    """Eq. 11 cost of a *fixed* tree under fresh stats — what the
    incumbent plan would cost if compiled today. The DP's stored
    ``tree.cost`` froze the registration-time stats; comparing it
    directly against a live-stats candidate would conflate graph growth
    with plan quality."""
    model = CostModel(cover, ord_, stats)

    def rec(jt: JoinTree) -> float:
        if jt.is_leaf:
            return model.leaf_cost(jt.pattern)
        cl, cr = rec(jt.left), rec(jt.right)
        return model.join_cost(jt.pattern, jt.left.pattern, jt.right.pattern, cl, cr)

    return rec(tree)


@dataclasses.dataclass(frozen=True)
class SwapEvent:
    """One re-optimization decision (kept whether or not it swapped)."""

    batch_index: int
    pattern: str
    trigger: str                 # "drift" | "periodic"
    drift: Optional[float]
    incumbent_cost: float        # incumbent tree re-costed at live stats
    candidate_cost: float
    swapped: bool
    count: Optional[int] = None  # match count after the swap (unchanged!)
    elapsed_s: float = 0.0


class PlanManager:
    """Recompile-and-maybe-swap policy over a running ListingService.

    ``drift_threshold`` — fire when the scheduler's drift EWMA (observed
    / predicted latency) exceeds this; drift ≈ 1.0 means the §IV-D model
    still describes the stream, sustained excursions mean the stats the
    incumbent plan was costed on no longer do. ``recost_every`` — also
    fire unconditionally every K committed batches (0 disables the
    heartbeat). ``improvement`` — swap only when the candidate's Eq. 11
    cost is below ``improvement ×`` the incumbent's live re-cost, so
    estimator noise can't thrash plans. ``objective`` — the free-cover
    policy for candidate compiles: default ``"cost"`` (Eq. 11 runtime
    argmin over all valid covers — a drifted stream is re-planned to run
    fast), or ``"r_lower"`` to keep §IV-F's storage objective. ``verify``
    — after each swap, run the service's from-scratch audit for the
    swapped pattern (expensive; tests and paranoid deployments).
    """

    def __init__(self, drift_threshold: float = 1.5, recost_every: int = 16,
                 improvement: float = 0.95, objective: str = "cost",
                 verify: bool = False):
        self.drift_threshold = float(drift_threshold)
        self.recost_every = int(recost_every)
        self.improvement = float(improvement)
        self.objective = str(objective)
        self.verify = bool(verify)
        self.events: List[SwapEvent] = []
        self._batches_seen = 0
        self._last_recost = 0

    # ------------------------------------------------------------------ hook
    def on_batch(self, service) -> List[SwapEvent]:
        """Called by :meth:`ListingService.advance` after each committed
        batch; returns the decisions made now (also kept in ``events``)."""
        self._batches_seen += 1
        drift = service.scheduler.drift()
        if drift is not None and drift >= self.drift_threshold:
            trigger = "drift"
        elif (self.recost_every > 0
              and self._batches_seen - self._last_recost >= self.recost_every):
            trigger = "periodic"
        else:
            return []
        self._last_recost = self._batches_seen
        return self.reoptimize(service, trigger=trigger, drift=drift)

    # ---------------------------------------------------------------- recost
    def reoptimize(self, service, trigger: str = "manual",
                   drift: Optional[float] = None) -> List[SwapEvent]:
        """Recompile every registered pattern from live stats and swap
        the ones whose candidate plan beats the incumbent."""
        backend = service.backend
        stats = GraphStats.of(service.graph)
        out: List[SwapEvent] = []
        for name in list(backend.names()):
            incumbent = backend.plan(name)
            if incumbent is None:
                continue
            t0 = time.perf_counter()
            # Free-cover recompile: drift may have moved the optimal
            # cover too, not just the tree shape.
            cand = backend.compile(incumbent.pattern, cover=None, stats=stats,
                                   objective=self.objective)
            service.obs.metrics.counter(
                "plan_recompiles_total",
                "staged-compiler runs from live stats (drift/periodic/manual)",
            ).inc()
            if incumbent.executor == "wcoj":
                # The incumbent runs the generic join — its live cost is
                # the WCOJ prefix-estimate sum, the same quantity the
                # compiler's executor pass minimizes, not the Eq. 11
                # tree cost it replaced.
                inc_cost = float(sum(wcoj_prefix_estimates(
                    incumbent.pattern, incumbent.wcoj.order,
                    incumbent.ord, stats)))
            else:
                inc_cost = recost_tree(incumbent.tree, incumbent.cover,
                                       incumbent.ord, stats)
            better = (cand.plan_key() != incumbent.plan_key()
                      and cand.cost < self.improvement * inc_cost)
            ev = SwapEvent(
                batch_index=service.committed_watermark, pattern=name,
                trigger=trigger, drift=drift,
                incumbent_cost=inc_cost, candidate_cost=cand.cost,
                swapped=better,
            )
            if better:
                count = self._swap(service, name, incumbent, cand, ev)
                ev = dataclasses.replace(
                    ev, count=count, elapsed_s=time.perf_counter() - t0)
            self.events.append(ev)
            out.append(ev)
        return out

    # ------------------------------------------------------------------ swap
    def _swap(self, service, name: str, incumbent, cand, ev: SwapEvent) -> int:
        backend = service.backend
        with service.obs.tracer.span(
                "plan_swap", pattern=name, trigger=ev.trigger) as sp:
            before = backend.count(name)
            table = backend.materialize(name)
            if table.cover != cand.storage_cover:
                # VCBC compression is exact under ANY vertex cover (a
                # cover touches every edge), so regrouping the running
                # table under the new *storage* cover loses nothing — no
                # re-listing, just a host-side group-by. Executor-mode
                # swaps land here too: WCOJ stores trivially compressed
                # (storage cover = every pattern vertex), so tree↔wcoj
                # is the same exact regroup.
                cols, plain = table.decompress(incumbent.ord)
                table = compress_table(cand.pattern, cand.storage_cover,
                                       cols, plain)
            backend.remove_pattern(name)
            count = backend.install_plan(name, cand, table)
            if count != before:
                raise RuntimeError(
                    f"plan swap changed the match count for {name!r}: "
                    f"{before} -> {count} (swap must be a pure re-plan)")
            service.scheduler.unregister(name)
            service.scheduler.register(name, cand.pattern, cand.ord, cand.units)
            service.scheduler.refresh(cand.stats)
            # The drift EWMA measured the *old* plan's predictions;
            # carrying it over would instantly re-fire against the new.
            service.scheduler.reset_drift()
            service.obs.record_plan(name, cand.to_json())
            service.obs.metrics.counter(
                "plan_swaps_total",
                "join-tree plans hot-swapped at a committed watermark",
            ).inc()
            sp.add("incumbent_cost", int(ev.incumbent_cost))
            sp.add("candidate_cost", int(ev.candidate_cost))
            sp.add("count", count)
        if self.verify:
            service.audit([name])
        return count
