"""`TorchBackend` — the streaming service's device backend.

Twin of ``ShardedBackend`` (``repro/stream/service.py``): a subclass of
the port's :class:`~repro_torch.stream.service.StreamBackend`, which the
port's ``ListingService(graph, backend="sharded")`` builds; by duck typing
it plugs into the JAX package's service too
(``ListingService(graph, backend=TorchBackend(graph, ...))``). Per batch it
runs one candidate-restricted storage update
(:func:`~repro_torch.sharded.make_storage_update_step`) and one fused
maintain megastep for every registered pattern
(:func:`~repro_torch.sharded.make_maintain_mega_step`) over the ``m``
partitions of :class:`~repro_torch.mesh.LocalMesh`, stacked on one device,
or over a :class:`~repro_torch.mesh.ProcessMesh`, each rank holding its
``m / world`` partitions on its own card.
Running match sets stay on the device: a count-only batch pulls scalars,
and tables reach the host only through :meth:`TorchBackend.materialize`
(valid prefix only, byte-accounted through ``_pull``; on a process mesh
gathered first, so that every rank holds the same host table).

On a process mesh every rank builds the same backend over the same graph
and is handed the same calls: every host decision (the planner, the cap
sizing, a fallback, a resize, a retry, a materialization) reads values
that are replicated, either computed on the host from replicated inputs
or summed over the mesh, so the ranks issue their collectives in one
order. After every registration and batch the ranks compare a digest of
their counts, caps, plans and store shapes (``agree_checks`` counts the
checks); a mismatch raises.

Beside it: :func:`_default_caps`, a copy from the same module.
:class:`PatternMeta` and :class:`PatternReport` are the port's service's
(:mod:`repro_torch.stream.service`).

Objects that a service built on another package hands in (a pattern, an
update, a compressed table, graph statistics) are read through their
fields and converted once, at entry; what the backend hands back
(:class:`PatternMeta`, :class:`PatternReport`, the port's
:class:`~repro_torch.planner.CompiledPlan` and
:class:`~repro_torch.core.vcbc.CompressedTable`) has the reference's fields.

The megastep overwrites the stores and unit-table carries in place (where
JAX donates them), so every retry and abort path rebuilds them from the
committed partitions ``self.pt``. The storage update writes fresh
partitions and leaves its input as it was, so ``self.pt`` stays the
committed state until a batch commits.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import engine as je
from . import sharded
from .core.estimator import GraphStats
from .core.graph import Graph, GraphUpdate
from .core.incremental import removed_rows
from .core.pattern import Pattern
from .core.storage import build_np_storage
from .core.vcbc import CompressedTable, Ragged, compress_table
from .mesh import LocalMesh, ProcessMesh
from .obs import ProfiledStep
from .planner import CompileContext, CompiledPlan, calibrate_wcoj_caps, compile_plan
from .planner.sizing import quantize_store_caps
from .run import _require_device
from .stream.scheduler import SharedDelta, probe_inc
from .stream.service import PatternMeta, PatternReport, StreamBackend, _meta_from_plan

__all__ = ["PatternMeta", "PatternReport", "TorchBackend"]

_CAP_FIELDS = ("v_cap", "deg_cap", "e_cap", "match_cap", "group_cap", "set_cap", "pair_cap")


def _default_caps(storage, graph: Graph, m: int, use_kernels: bool) -> je.EngineCaps:
    """Size EngineCaps from the built storage with growth headroom."""
    nv = max(max((int(p.vertices.shape[0]) for p in storage.parts), default=1), graph.n // m + 1)
    ne = max((int(p.codes.shape[0]) for p in storage.parts), default=1)
    dg = max((int(np.diff(p.indptr).max(initial=0)) for p in storage.parts), default=1)

    def up(x, mult, align):
        return int(-(-max(1, int(x * mult)) // align) * align)

    v_cap = up(max(nv, graph.n / m), 1.5, 64)
    return je.EngineCaps(
        v_cap=v_cap, deg_cap=up(dg, 2.0, 8), e_cap=up(ne, 2.0, 64),
        match_cap=4096, group_cap=4096, set_cap=64, pair_cap=128,
        use_kernels=use_kernels,
    )


# ---------------------------------------------------------------------------
# Conversions at entry
# ---------------------------------------------------------------------------

def _as_graph(graph) -> Graph:
    if isinstance(graph, Graph):
        return graph
    return Graph._from_codes(int(graph.n), np.asarray(graph.codes, np.int64))


def _as_pattern(pattern) -> Pattern:
    if isinstance(pattern, Pattern):
        return pattern
    return Pattern.make(sorted(tuple(e) for e in pattern.edges), vertices=pattern.vertices)


def _as_update(update) -> GraphUpdate:
    if isinstance(update, GraphUpdate):
        return update
    return GraphUpdate(delete=np.asarray(update.delete, np.int64).reshape(-1, 2),
                       add=np.asarray(update.add, np.int64).reshape(-1, 2))


def _as_stats(stats) -> GraphStats:
    if isinstance(stats, GraphStats):
        return stats
    return GraphStats(n=int(stats.n), m=int(stats.m),
                      deg_hist=tuple(int(x) for x in stats.deg_hist))


def _as_table(table, pattern: Pattern) -> CompressedTable:
    """Any compressed table with the reference's fields as the port's, over
    the port's ``pattern``."""
    return CompressedTable(
        pattern=pattern, cover=tuple(int(c) for c in table.cover),
        skeleton_cols=tuple(int(c) for c in table.skeleton_cols),
        skeleton=np.asarray(table.skeleton, np.int64),
        comp={int(v): Ragged(offsets=np.asarray(r.offsets, np.int64),
                             values=np.asarray(r.values, np.int64))
              for v, r in table.comp.items()})


def _plan_key(plan: CompiledPlan) -> str:
    """A plan's JSON form less its passes' timings: equal on every rank
    that compiled the same plan."""
    return json.dumps({k: v for k, v in plan.to_json().items() if k != "passes"},
                      sort_keys=True, default=str)


@dataclasses.dataclass
class _TorchEntry:
    meta: PatternMeta
    prog: object
    full_skel: Tuple[int, ...]
    store: sharded.MatchStore       # device-resident running match set
    store_caps: sharded.StoreCaps
    unit_caps: sharded.StoreCaps    # StoreCaps of the unit-table carry
    carry: dict                     # per-partition unit tables
    n_unit_plans: int               # distinct unit plans behind the carry
    refresh_step: object            # cold carry refresh (also the abort path)
    list_step: object = None        # initial-listing step (rebuilds)
    host_table: object = None       # materialized table (per watermark)
    wcoj_level_caps: object = None  # calibrated per-level caps (wcoj mode)


class TorchBackend(StreamBackend):
    """The streaming backend over the port's device steps.

    One storage update advances Φ(d') on the device once per batch; every
    registered pattern is then maintained by ONE fused megastep: per
    pattern, carry refresh ∘ patch ∘ delete filter ∘ merge ∘ count over its
    device-resident :class:`~repro_torch.sharded.MatchStore` (a WCOJ
    pattern patches by a delta-seeded generic join and has no carry).

    Device cap overflow is reported per batch, never silent. A store
    overflow heals by default: nothing commits, the overflowing patterns'
    caps double, the stores are rebuilt by listing again over the committed
    partitions, the megastep is rebuilt and the batch retried
    (``store_resizes``). A candidate-cap overflow of the storage update
    falls back, once and for good, to the never-overflow candidate caps and
    retries the batch (``cap_fallbacks``). ``strict_overflow=True`` raises
    on any storage or maintain overflow before anything commits, and
    leaves the backend usable at the committed watermark.

    ``device`` defaults to the card and raises without CUDA; pass
    ``device="cpu"`` to run the plain versions of the kernels on the CPU.
    ``use_kernels`` (default: on a card, off on the CPU) is set on the
    engine caps, whether they are given or sized here. ``mesh``, a
    :class:`~repro_torch.mesh.ProcessMesh`, spreads the partitions over
    its ranks: ``m`` is then the mesh's and the device the rank's.
    """

    kind = "torch"

    #: candidate-set sizes of the last batch's storage update (delta mode)
    last_cand_vertices: int = -1
    last_cand_edges: int = -1
    #: permanent fallbacks to the never-overflow candidate caps
    cap_fallbacks: int = 0
    #: MatchStore ×2-cap rebuilds after store overflow
    store_resizes: int = 0
    #: digest comparisons between the ranks of a process mesh
    #: (registrations and batches)
    agree_checks: int = 0
    _max_store_resizes: int = 4

    def __init__(self, graph, m: int = 8, caps=None, max_add: int = 64, max_del: int = 64,
                 use_kernels: Optional[bool] = None, update_mode: str = "delta",
                 cap_sizing: str = "estimator", store_headroom: float = 4.0,
                 strict_overflow: bool = False, executor: str = "tree",
                 level_headroom: float = 1.5, device="cuda",
                 mesh: Optional[ProcessMesh] = None):
        self.device = _require_device(device)
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"a mesh on {mesh.device} for a backend on {self.device}")
            self.device, m = mesh.device, mesh.size
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        self._sharded = sharded
        self._je = je
        self.executor = executor
        self.m = int(m)
        self.mesh = LocalMesh(self.m) if mesh is None else mesh
        graph = _as_graph(graph)
        storage = build_np_storage(graph, self.m)
        if caps is None:
            self.caps = _default_caps(storage, graph, self.m, bool(use_kernels))
        else:
            self.caps = je.EngineCaps(**{f: int(getattr(caps, f)) for f in _CAP_FIELDS},
                                      use_kernels=bool(use_kernels))
        self.max_batch_ops = min(max_add, max_del)
        self._max_add, self._max_del = max_add, max_del
        if cap_sizing == "estimator":
            # §IV-D-sized candidate caps, clamped to the never-overflow
            # bound; a batch that outruns them falls back and retries
            self.ushapes = sharded.UpdateShapes.from_estimator(
                max_add, max_del, GraphStats.of(graph), self.caps, self.m)
        elif cap_sizing == "exact":
            self.ushapes = sharded.UpdateShapes(n_add=max_add, n_del=max_del)
        else:
            raise ValueError(
                f"unknown cap_sizing {cap_sizing!r} (expected 'estimator' or 'exact')")
        self.graph = graph
        if graph.n > self.m * self.caps.v_cap:
            raise ValueError(
                f"graph has {graph.n} vertices > m*v_cap={self.m * self.caps.v_cap}")
        self.update_mode = update_mode
        self.store_headroom = float(store_headroom)
        # per-level WCOJ caps are transient (overflow is found before
        # anything commits), so they hug the observed sizes tighter
        self.level_headroom = float(level_headroom)
        self.strict_overflow = bool(strict_overflow)
        #: the fused megastep (None until a pattern registers) and its
        #: per-pattern cost shares
        self.maintain_step: Optional[ProfiledStep] = None
        self._maintain_subs: Dict[str, float] = {}
        self.storage_step = ProfiledStep(
            "storage_update",
            sharded.make_storage_update_step(self.mesh, self.caps, self.ushapes,
                                             mode=update_mode),
            self._jaxprof)
        self.pt = sharded.stack_partitions(storage, self.caps, self.device,
                                           parts=self.mesh.indices())
        self.entries: Dict[str, _TorchEntry] = {}
        self._counts: Dict[str, int] = {}
        #: entries removed since the last batch, kept for carry reuse on a
        #: same-watermark plan swap (cleared whenever Φ advances)
        self._carry_stash: Dict[str, _TorchEntry] = {}
        self.last_host_bytes = 0
        self.total_host_bytes = 0

    @property
    def writes_files(self) -> bool:
        return self.mesh.rank == 0

    # ------------------------------------------------------------ plumbing
    def _pull(self, arr) -> np.ndarray:
        """Device→host transfer with byte accounting."""
        a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
        self.last_host_bytes += int(a.nbytes)
        self.total_host_bytes += int(a.nbytes)
        self._obs().metrics.counter(
            "host_transfer_bytes_total",
            "device→host bytes pulled through the sharded backend",
        ).inc(int(a.nbytes))
        return a

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Stacked ``[k, ...]`` tensors of this process's partitions as the
        ``[m, ...]`` of the whole mesh (the tensor itself on one process)."""
        if self.mesh.world == 1:
            return x
        return self.mesh.all_gather(list(x)).reshape((self.m,) + tuple(x.shape[1:]))

    def _flatten(self, tc) -> je.CompTensors:
        """Pull stacked [M, G, ...] compressed tensors to host form."""
        skel = self._pull(self._gather(tc.skeleton)).reshape(-1, tc.skeleton.shape[-1])
        valid = self._pull(self._gather(tc.valid)).reshape(-1)
        sets = {k: self._pull(self._gather(v)).reshape(-1, v.shape[-1])
                for k, v in tc.sets.items()}
        return je.CompTensors(skeleton=skel, valid=valid, sets=sets)

    def _flatten_live(self, tc) -> je.CompTensors:
        """Pull only each shard's valid prefix of stacked [M, G, ...]
        compressed tensors: the store packs live groups first, so the pull
        costs O(live table), not O(StoreCaps). A shard that is not
        prefix-packed falls back to the exact full-tensor pull. On a
        process mesh the valid masks and then the prefixes are gathered,
        so every rank decides alike and gets the same table."""
        valid = self._pull(self._gather(tc.valid))
        m = valid.shape[0]
        ks = [int(k) for k in valid.reshape(m, -1).sum(axis=1)]
        if not all(bool(valid[i, :ks[i]].all()) for i in range(m)):
            return self._flatten(tc)
        mine = [(i, ks[j]) for i, j in enumerate(self.mesh.indices())]

        def live(a):
            return self._pull(self.mesh.all_gather_ragged([a[i, :k] for i, k in mine]))

        skel = live(tc.skeleton)
        sets = {key: live(v) for key, v in tc.sets.items()}
        return je.CompTensors(skeleton=skel, valid=np.ones(skel.shape[0], bool), sets=sets)

    # ------------------------------------------------------------ the ranks
    def _digest(self) -> int:
        """A 64-bit digest of what every rank must hold alike: the mesh
        width, the engine and candidate caps, and per pattern its count,
        plan, store and carry caps, level caps and store shapes."""
        per = []
        for name in sorted(self.entries):
            e = self.entries[name]
            per.append((name, self._counts[name],
                        _plan_key(e.meta.plan) if e.meta.plan is not None else None,
                        e.store_caps, e.unit_caps, e.wcoj_level_caps,
                        tuple(e.store.skeleton.shape),
                        tuple((v, tuple(a.shape)) for v, a in sorted(e.store.sets.items()))))
        text = repr((self.m, self.caps, self.ushapes, per))
        return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little", signed=True)

    def _check_ranks_agree(self, where: str) -> None:
        """Gather every rank's :meth:`_digest` and raise unless they are
        equal (counted in ``agree_checks``; a :class:`LocalMesh` backend
        has no other rank and skips the check)."""
        if not isinstance(self.mesh, ProcessMesh):
            return
        self.agree_checks += 1
        self._obs().metrics.counter(
            "mesh_agree_checks_total", "digest comparisons between the mesh's ranks").inc()
        mine = torch.tensor([self._digest()], dtype=torch.int64, device=self.device)
        got = self.mesh.all_gather([mine] * self.mesh.local).tolist()
        if len(set(got)) != 1:
            raise RuntimeError(f"the mesh's ranks disagree {where}: digests {got}")

    # ------------------------------------------------------------ planning
    def compile(self, pattern, cover=None, stats=None,
                objective: str = "r_lower") -> CompiledPlan:
        """The staged plan compiler against this backend's machine shape
        (mesh width, engine caps, store headroom): the single entry point
        of plan construction for register, restore and plan swaps."""
        return compile_plan(CompileContext(
            pattern=_as_pattern(pattern),
            stats=_as_stats(stats) if stats is not None else GraphStats.of(self.graph),
            m=self.m, caps=self.caps,
            cover=tuple(sorted(int(c) for c in cover)) if cover is not None else None,
            cover_objective=objective,
            store_headroom=self.store_headroom,
            executor=self.executor,
        ))

    def register(self, name: str, pattern, cover=None) -> int:
        if name in self.entries:
            raise ValueError(f"pattern {name!r} already registered")
        meta = _meta_from_plan(name, self.compile(pattern, cover))
        if meta.plan.executor == "wcoj":
            return self._register_wcoj(name, meta)
        prog = meta.plan.program
        list_step = ProfiledStep(f"list:{name}",
                                 sharded.make_list_step(prog, self.mesh, self.caps),
                                 self._jaxprof)
        out, diag = list_step(self.pt)
        if int(diag["overflow"]):
            raise ValueError(
                f"initial listing overflowed caps ({int(diag['overflow'])} rows); "
                "re-register with larger EngineCaps")
        # the initial match set goes straight into a device store, counted
        # on the device; caps on the pow2 grid so patterns share shapes
        store_caps = quantize_store_caps(meta.plan.store_caps)
        init_step = ProfiledStep(f"init_store:{name}",
                                 sharded.make_init_store_step(prog, self.mesh, self.caps,
                                                              store_caps),
                                 self._jaxprof)
        store, idiag = init_step(out)
        del out
        if int(idiag["overflow"]):
            raise ValueError(
                f"initial match store overflowed caps ({int(idiag['overflow'])} "
                "entries); re-register with a larger store_headroom")
        self._make_entry(name, meta, store, store_caps, list_step=list_step)
        return self._registered(name, int(idiag["count"]))

    def _register_wcoj(self, name: str, meta: PatternMeta) -> int:
        """Register under the generic-join executor: anchored WCOJ listing
        → a store of plain rows, no unit-table carry."""
        plan = meta.plan
        level_caps, store_floor = self._calibrate_wcoj_caps(plan)
        list_step = ProfiledStep(
            f"list:{name}",
            sharded.make_wcoj_list_step(plan.pattern, plan.wcoj, self.mesh, self.caps,
                                        level_caps),
            self._jaxprof)
        out, diag = list_step(self.pt)
        if int(diag["overflow"]):
            raise ValueError(
                f"initial WCOJ listing overflowed level caps "
                f"({int(diag['overflow'])} rows); re-register with a larger "
                "store_headroom")
        # store groups are whole matches, so the calibrated bound is the
        # honest group sizing; the plan's store caps only set the floor
        store_caps = quantize_store_caps(dataclasses.replace(
            plan.store_caps, group_cap=max(plan.store_caps.group_cap, store_floor)))
        init_step = ProfiledStep(
            f"init_store:{name}",
            sharded.make_wcoj_init_store_step(plan.pattern, plan.ord, self.mesh, store_caps),
            self._jaxprof)
        store, idiag = init_step(out)
        del out
        if int(idiag["overflow"]):
            raise ValueError(
                f"initial WCOJ match store overflowed caps "
                f"({int(idiag['overflow'])} entries); re-register with a "
                "larger store_headroom")
        self._make_entry(name, meta, store, store_caps, list_step=list_step,
                         wcoj_level_caps=level_caps)
        return self._registered(name, int(idiag["count"]))

    def _registered(self, name: str, count: int) -> int:
        """Record a new pattern's count and check that the ranks agree."""
        self._counts[name] = count
        self._check_ranks_agree(f"after registering {name!r}")
        return count

    def _calibrate_wcoj_caps(self, plan: CompiledPlan):
        """Register-time calibration: the observed per-partition level sizes
        over the committed graph replace the estimator's level caps.
        Returns ``(level_caps, store_group_floor)``."""
        return calibrate_wcoj_caps(build_np_storage(self.graph, self.m), plan.wcoj,
                                   self.level_headroom, self.store_headroom)

    def _make_entry(self, name, meta, store, store_caps, list_step=None,
                    wcoj_level_caps=None) -> _TorchEntry:
        """Common tail of register / restore / install: cold-fill the
        unit-table carry (or reuse a stashed one) and fold the pattern into
        the megastep. A WCOJ entry has no carry."""
        prog = meta.plan.program
        unit_caps = meta.plan.unit_caps
        if meta.plan.executor == "wcoj":
            self._carry_stash.pop(name, None)
            if wcoj_level_caps is None:
                wcoj_level_caps, _ = self._calibrate_wcoj_caps(meta.plan)
            entry = _TorchEntry(
                meta=meta, prog=prog, full_skel=meta.plan.storage_cover,
                store=store, store_caps=store_caps, unit_caps=unit_caps, carry={},
                n_unit_plans=0, refresh_step=lambda pt: ({}, {"overflow": 0}),
                list_step=list_step, wcoj_level_caps=wcoj_level_caps)
            self.entries[name] = entry
            self._rebuild_maintain_step()
            return entry
        refresh_step = ProfiledStep(
            f"unit_refresh:{name}",
            sharded.make_unit_refresh_step(prog, list(meta.units), self.mesh, self.caps,
                                           unit_caps),
            self._jaxprof)
        n_plans = len(sharded.unit_plan_registry(prog, list(meta.units))[0])
        stash = self._carry_stash.pop(name, None)
        if stash is not None and self._carry_compatible(stash, meta, unit_caps):
            # a same-watermark swap that keeps everything the carry depends
            # on: the removed entry's carry is still exact
            carry = stash.carry
            self._obs().metrics.counter(
                "plan_swap_carry_reuses_total",
                "unit-table carries reused across cover-preserving swaps",
            ).inc()
            probe_inc("cache_hits", self.m * n_plans, metrics=self._obs().metrics)
        else:
            carry, rdiag = refresh_step(self.pt)
            if int(rdiag["overflow"]):
                raise ValueError(
                    f"unit-table carry overflowed caps ({int(rdiag['overflow'])} "
                    "entries); enlarge EngineCaps / unit_table_caps headroom")
            probe_inc("cache_misses", self.m * n_plans, metrics=self._obs().metrics)
        entry = _TorchEntry(
            meta=meta, prog=prog, full_skel=prog.nodes[prog.root].skel_cols,
            store=store, store_caps=store_caps, unit_caps=unit_caps, carry=carry,
            n_unit_plans=n_plans, refresh_step=refresh_step, list_step=list_step)
        self.entries[name] = entry
        self._rebuild_maintain_step()
        return entry

    @staticmethod
    def _carry_compatible(stash: _TorchEntry, meta: PatternMeta, unit_caps) -> bool:
        """True when a stashed entry's carry is valid for the new plan: the
        carry depends only on (cover, ord, units, unit caps), and only tree
        plans have one."""
        old = stash.meta
        return (old.plan is not None and old.plan.executor != "wcoj"
                and meta.plan.executor != "wcoj"
                and old.cover == meta.cover
                and old.ord_ == meta.ord_
                and len(old.units) == len(meta.units)
                and all(a.pattern.key() == b.pattern.key() and a.anchors == b.anchors
                        for a, b in zip(old.units, meta.units))
                and stash.unit_caps == unit_caps)

    def _rebuild_maintain_step(self) -> None:
        """(Re)build the fused megastep over the current entries, with each
        pattern's Eq. 11 cost share (``subs``) for latency attribution."""
        if not self.entries:
            self.maintain_step = None
            self._maintain_subs = {}
            return
        specs = [sharded.MaintainSpec(
            name=n, prog=e.prog, units=tuple(e.meta.units), store=e.store_caps,
            unit_caps=e.unit_caps,
            wcoj=e.meta.plan.wcoj if e.meta.plan.executor == "wcoj" else None,
            wcoj_level_caps=e.wcoj_level_caps)
            for n, e in self.entries.items()]
        costs = {n: (max(float(e.meta.plan.cost), 1e-9) if e.meta.plan is not None else 1.0)
                 for n, e in self.entries.items()}
        total = sum(costs.values())
        self._maintain_subs = {n: c / total for n, c in costs.items()}
        self.maintain_step = ProfiledStep(
            "maintain_mega", sharded.make_maintain_mega_step(specs, self.mesh, self.caps),
            self._jaxprof, subs=self._maintain_subs)

    def restore_pattern(self, name: str, pattern, cover: Tuple[int, ...], table) -> int:
        """Register a pattern whose match set is known (a snapshot table at
        the committed watermark): the store comes from
        :func:`~repro_torch.sharded.stack_matches`, the carry from one
        refresh."""
        return self.install_plan(name, self.compile(pattern, cover), table)

    def install_plan(self, name: str, plan: CompiledPlan, table) -> int:
        """Install a compiled plan with a known match set at the committed
        watermark (a table under another cover is regrouped under the
        plan's storage cover first)."""
        if name in self.entries:
            raise ValueError(f"pattern {name!r} already registered")
        table = _as_table(table, plan.pattern)
        if table.cover != plan.storage_cover:
            cols, rows = table.decompress(plan.ord)
            table = compress_table(plan.pattern, plan.storage_cover, cols, rows)
        meta = _meta_from_plan(name, plan)
        store_caps = quantize_store_caps(self._fit_store_caps(plan.store_caps, table))
        store = sharded.stack_matches(table, self.m, store_caps, self.device,
                                      parts=self.mesh.indices())
        self._make_entry(name, meta, store, store_caps)
        return self._registered(name, table.count_matches(plan.ord))

    def remove_pattern(self, name: str) -> None:
        """Forget a pattern. Its entry is stashed until the next batch, so a
        plan swap at the same watermark can reuse its carry."""
        # the stash keeps what the carry check reads, not the store
        self._carry_stash[name] = dataclasses.replace(self.entries[name], store=None,
                                                      host_table=None)
        del self.entries[name]
        del self._counts[name]
        self._rebuild_maintain_step()

    def _fit_store_caps(self, est, table):
        """Grow estimator-sized StoreCaps to hold a concrete table
        (``stack_matches`` raises on a misfit)."""
        if table.n_groups == 0:
            return est
        owner = sharded._owner_rows_np(table.skeleton.astype(np.int64), self.m)
        need_g = int(np.bincount(owner, minlength=self.m).max())
        need_s = max((int(r.counts().max(initial=0)) for r in table.comp.values()),
                     default=1)

        def up(x, align):
            return int(-(-max(1, int(x)) // align) * align)

        return sharded.StoreCaps(group_cap=max(est.group_cap, up(need_g, 64)),
                                 set_cap=max(est.set_cap, up(need_s, 8)))

    # ------------------------------------------------------------ results
    def meta(self, name: str) -> PatternMeta:
        return self.entries[name].meta

    def names(self) -> List[str]:
        return list(self.entries)

    def count(self, name: str) -> int:
        return self._counts[name]

    @staticmethod
    def _storage_cover(e: _TorchEntry) -> Tuple[int, ...]:
        return e.meta.plan.storage_cover if e.meta.plan is not None else e.meta.cover

    def materialize(self, name: str) -> CompressedTable:
        """The running match set on the host (cached until the next batch
        moves the store); only each shard's valid prefix is pulled."""
        e = self.entries[name]
        if e.host_table is None:
            obs = self._obs()
            b0 = self.last_host_bytes
            with obs.tracer.span("materialize", pattern=name) as sp:
                e.host_table = je.comp_to_host(
                    self._flatten_live(e.store.as_comp()), e.meta.pattern,
                    self._storage_cover(e), e.full_skel)
                sp.add("host_bytes", self.last_host_bytes - b0)
            probe_inc("host_materializations", metrics=obs.metrics)
        return e.host_table

    def matches_plain(self, name: str) -> np.ndarray:
        e = self.entries[name]
        return self.materialize(name).decompress(e.meta.ord_)[1]

    # ------------------------------------------------------------ batches
    def _pad(self, edges: np.ndarray, cap: int) -> torch.Tensor:
        k = edges.shape[0]
        if k > cap:
            raise ValueError(f"batch has {k} edges > static cap {cap}")
        out = np.full((cap, 2), -1, np.int32)
        out[:k] = edges
        return torch.from_numpy(out).to(self.device)

    def _storage_diag(self, sdiag) -> None:
        self.last_storage_overflow = int(sdiag["overflow"])
        self.last_cand_vertices = int(sdiag.get("cand_vertices", -1))
        self.last_cand_edges = int(sdiag.get("cand_edges", -1))

    def apply_batch(self, delta: SharedDelta, want_matches) -> Dict[str, PatternReport]:
        obs = self._obs()
        tr = obs.tracer
        upd = _as_update(delta.update)
        # per-batch diagnostics reset before any work
        self.last_storage_overflow = 0
        self.last_cand_vertices = -1
        self.last_cand_edges = -1
        self.last_host_bytes = 0
        self.last_cache_hits = 0
        self.last_cache_misses = 0
        self.last_invalidated_parts = 0
        # stashed carries belong to the committed watermark
        self._carry_stash.clear()
        if upd.size == 0:
            return self._noop_reports()
        add = self._pad(upd.add, self.ushapes.n_add)
        dele = self._pad(upd.delete, self.ushapes.n_del)
        with tr.span("storage_update") as ssp:
            pt2, sdiag = self.storage_step(self.pt, add, dele)
            self._storage_diag(sdiag)
            if int(sdiag.get("cand_overflow", 0)) and self.ushapes.cand_cap is not None:
                # the estimator-sized candidate caps were outrun; nothing
                # has committed: fall back to the never-overflow caps for
                # good and retry the same batch
                self.cap_fallbacks += 1
                obs.metrics.counter(
                    "sharded_cap_fallbacks_total",
                    "permanent fallbacks to never-overflow candidate caps",
                ).inc()
                ssp.add("cap_fallbacks", 1)
                self.ushapes = sharded.UpdateShapes(n_add=self._max_add, n_del=self._max_del)
                self.storage_step = ProfiledStep(
                    "storage_update",
                    sharded.make_storage_update_step(self.mesh, self.caps, self.ushapes,
                                                     mode=self.update_mode),
                    self._jaxprof)
                pt2, sdiag = self.storage_step(self.pt, add, dele)
                self._storage_diag(sdiag)
            ssp.add("overflow", self.last_storage_overflow)
        if self.strict_overflow and self.last_storage_overflow:
            raise RuntimeError(
                f"device storage update overflowed caps "
                f"({self.last_storage_overflow} entries) — counts would be "
                "silently wrong from here on. Enlarge EngineCaps, or pass "
                "strict_overflow=False to tolerate undercounts.")
        dirty = sdiag["part_dirty"]
        names = list(self.entries)
        reports: Dict[str, PatternReport] = {}
        if names:
            before = dict(self._counts)
            # removed rows need the pre-update tables: materialized before
            # the megastep, which overwrites the stores
            removed_by: Dict[str, Optional[np.ndarray]] = {
                name: (removed_rows(self.materialize(name), upd.delete,
                                    self.entries[name].meta.ord_)
                       if name in want_matches and upd.delete.size else None)
                for name in names}
            t0 = time.perf_counter()
            with tr.span("maintain_mega", patterns=len(names)) as msp:
                stores = {n: self.entries[n].store for n in names}
                carries = {n: self.entries[n].carry for n in names}
                for n in names:
                    self.entries[n].host_table = None   # the store is about to move
                stores2, patches, carries2, mdiag = self.maintain_step(
                    pt2, stores, carries, dirty, add, dele)
                if (not self.strict_overflow
                        and any(int(mdiag[n]["store_overflow"]) for n in names)):
                    stores2, patches, carries2, mdiag = self._resize_stores_and_retry(
                        pt2, dirty, add, dele, mdiag, carries2)
                if self.strict_overflow and any(int(mdiag[n]["overflow"]) for n in names):
                    # refuse to commit a lossy batch; the stores and carries
                    # were overwritten, so rebuild the committed state from
                    # the committed partitions before raising
                    overfull = [n for n in names if int(mdiag[n]["overflow"])]
                    self._rebuild_stores_from_partitions()
                    for e2 in self.entries.values():
                        e2.carry = e2.refresh_step(self.pt)[0]
                    raise RuntimeError(
                        f"maintain step for {overfull!r} overflowed device "
                        f"caps — the running match set would silently lose "
                        "groups. Re-register with a larger store_headroom / "
                        "EngineCaps, or pass strict_overflow=False for "
                        "best-effort auto-resize.")
                msp.add("store_groups", sum(int(mdiag[n]["store_groups"]) for n in names))
            lat = time.perf_counter() - t0
            # commit: every store, carry and count advances together
            for name in names:
                e = self.entries[name]
                e.store = stores2[name]
                e.carry = carries2[name]
                self._counts[name] = int(mdiag[name]["count"])
            for name in names:
                e = self.entries[name]
                d = mdiag[name]
                refreshed = int(d["unit_refreshes"])
                self.last_cache_hits += (self.m - refreshed) * e.n_unit_plans
                self.last_cache_misses += refreshed * e.n_unit_plans
                self.last_invalidated_parts = refreshed
                added = None
                if name in want_matches:
                    patch = je.comp_to_host(self._flatten_live(patches[name]), e.meta.pattern,
                                            self._storage_cover(e), e.full_skel)
                    added = patch.decompress(e.meta.ord_)[1]
                with tr.span("maintain", pattern=name) as psp:
                    psp.add("patch_groups", int(d["patch_groups"]))
                    psp.add("removed_groups", int(d["removed_groups"]))
                    psp.add("overflow", int(d["overflow"]))
                    psp.add("unit_refreshes", refreshed)
                reports[name] = PatternReport(
                    name=name, count_before=before[name], count_after=self._counts[name],
                    # the fused step is timed once; a pattern's latency is
                    # its Eq. 11 cost share of it
                    latency_s=lat * self._maintain_subs.get(name, 1.0 / len(names)),
                    patch_groups=int(d["patch_groups"]),
                    removed_groups=int(d["removed_groups"]),
                    overflow=int(d["overflow"]), added=added, removed=removed_by[name])
        self.pt = pt2
        self.graph = self.graph.apply_update(upd)
        probe_inc("cache_hits", self.last_cache_hits, metrics=obs.metrics)
        probe_inc("cache_misses", self.last_cache_misses, metrics=obs.metrics)
        probe_inc("invalidated_parts", self.last_invalidated_parts, metrics=obs.metrics)
        self._check_ranks_agree(f"after the batch ending at op {delta.hi}")
        return reports

    # ------------------------------------------------------------ recovery
    def _rebuild_stores_from_partitions(self) -> None:
        """Recreate every pattern's committed-watermark MatchStore by
        listing again over the committed partitions ``self.pt`` (the
        initial-listing pipeline gives the same canonical shards). Raises
        if the listing itself outruns the engine caps."""
        for name, e in self.entries.items():
            wcoj = e.meta.plan.wcoj if e.meta.plan.executor == "wcoj" else None
            if e.list_step is None:
                # a pattern installed from a table never listed; its step is
                # built on the first rebuild and kept
                e.list_step = ProfiledStep(
                    f"list:{name}",
                    (sharded.make_wcoj_list_step(e.meta.pattern, wcoj, self.mesh, self.caps,
                                                 e.wcoj_level_caps)
                     if wcoj is not None else
                     sharded.make_list_step(e.prog, self.mesh, self.caps)),
                    self._jaxprof)
            out, ldiag = e.list_step(self.pt)
            if int(ldiag["overflow"]):
                raise RuntimeError(
                    f"re-listing {name!r} while rebuilding its store "
                    f"overflowed engine caps ({int(ldiag['overflow'])} rows); "
                    "enlarge EngineCaps")
            init_step = ProfiledStep(
                f"init_store:{name}",
                (sharded.make_wcoj_init_store_step(e.meta.pattern, e.meta.ord_, self.mesh,
                                                   e.store_caps)
                 if wcoj is not None else
                 sharded.make_init_store_step(e.prog, self.mesh, self.caps, e.store_caps)),
                self._jaxprof)
            e.store = None   # free the old store before the new one is built
            store, idiag = init_step(out)
            del out
            if int(idiag["overflow"]):
                raise RuntimeError(
                    f"rebuilding {name!r}'s store overflowed its caps "
                    f"({int(idiag['overflow'])} entries)")
            e.store = store
            e.host_table = None

    def _resize_stores_and_retry(self, pt2, dirty, add, dele, mdiag, carries2):
        """Double the (quantized) caps of every overflowing pattern, rebuild
        every pre-batch store from the committed partitions, rebuild the
        megastep and retry the batch, until the store overflow clears or
        the retry budget is spent. The retry reuses the failed attempt's
        carries: they depend only on Φ(d') and the dirty flags."""
        out = None
        for _ in range(self._max_store_resizes):
            over = [n for n in self.entries if int(mdiag[n]["store_overflow"])]
            if not over:
                break
            for name in over:
                e = self.entries[name]
                self.store_resizes += 1
                self._obs().metrics.counter(
                    "sharded_store_resizes_total",
                    "MatchStore ×2-cap rebuilds after store overflow",
                ).inc()
                e.store_caps = quantize_store_caps(sharded.StoreCaps(
                    group_cap=2 * e.store_caps.group_cap, set_cap=2 * e.store_caps.set_cap))
            self._rebuild_stores_from_partitions()
            self._rebuild_maintain_step()
            stores = {n: e.store for n, e in self.entries.items()}
            out = self.maintain_step(pt2, stores, carries2, dirty, add, dele)
            mdiag = out[3]
            carries2 = out[2]
        if out is None:
            raise AssertionError("resize called without store overflow")
        return out
