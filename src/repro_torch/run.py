"""The port's main path: list patterns once, then maintain them under batches.

:class:`Pipeline` builds the graph, the NP storage, each pattern's plan and
caps, puts the stacked partitions on the device, runs stage 1 for every
pattern and answers each update batch as the streaming service's sharded
backend does: one storage update
(:func:`~repro_torch.sharded.make_storage_update_step`) and one maintain
step for every pattern (:func:`~repro_torch.sharded.make_maintain_mega_step`).
Its answer to a batch is each pattern's exact maintained match count.

Each pattern runs the executor that ``RunConfig.executor`` picks, as the
service's planner does (:func:`~repro_torch.planner.compiler.compile_plan`):
a join tree, whose stage 1 is :func:`~repro_torch.sharded.make_list_step` +
:func:`~repro_torch.sharded.make_init_store_step` and the cold fill of its
unit-table carry (:func:`~repro_torch.sharded.make_unit_refresh_step`), or
the generic join (WCOJ), whose level caps are calibrated on the host
partitions (:func:`~repro_torch.planner.sizing.calibrate_wcoj_caps`) and
whose stage 1 is :func:`~repro_torch.sharded.make_wcoj_list_step` +
:func:`~repro_torch.sharded.make_wcoj_init_store_step`, with no carry.

:func:`stages` is the driver: it runs stage 1 and then the batches, and
yields each stage's diag with its time and peak device memory.

    PYTHONPATH=src python -m repro_torch.run            # WT~ / q1_square, one H100
    PYTHONPATH=src python -m repro_torch.run --config wt_multi
    PYTHONPATH=src python -m repro_torch.run --config wt_clique      # WCOJ, K5 + K4
    PYTHONPATH=src python -m repro_torch.run --device cpu --config example
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .core.estimator import GraphStats
from .core.graph import GraphUpdate
from .core.pattern import PATTERN_LIBRARY, Pattern, R1Unit
from .core.plan import WcojPlan
from .core.storage import build_np_storage
from .data.graphs import PLANTED_M_BG, PLANTED_N, planted_graph, rmat_graph, sample_update
from .engine import EngineCaps
from .mesh import LocalMesh, ProcessMesh
from .planner.compiler import CompileContext, compile_plan
from .planner.lowering import TreeProgram
from .planner.sizing import calibrate_wcoj_caps, quantize_store_caps
from . import sharded

__all__ = ["RunConfig", "WT_Q1", "WT_MULTI", "WT_CLIQUE", "WT_MULTI_AUTO", "EXAMPLE_Q1",
           "PLANTED_K5", "PLANTED_K4", "CONFIGS", "PatternPlan", "plan_pattern", "Pipeline",
           "stages"]


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One deployment: a graph (``"rmat"``: ``rmat_graph(n_log2, n_edges,
    graph_seed)``; ``"planted"``: the planted near-clique graph of
    ``planted_graph(graph_seed)``, whose size is fixed, so ``n_log2`` and
    ``n_edges`` must state it: 2**12 vertices, 12,000 background edges), a
    pattern (and
    ``more_patterns`` maintained beside it), the executor choice
    (``"tree"``, ``"wcoj"`` or ``"auto"``), ``m`` partitions, the engine
    caps and the batch shape. The store and carry caps and the candidate
    caps of the update come from the §IV-D estimators; a WCOJ pattern's
    level caps and store groups from the calibration."""

    n_log2: int
    n_edges: int
    graph_seed: int
    pattern: str
    m: int
    v_cap: int
    deg_cap: int
    e_cap: int
    match_cap: int
    group_cap: int
    set_cap: int
    pair_cap: int
    n_add: int = 64
    n_del: int = 64
    update_seed: int = 100
    more_patterns: Tuple[str, ...] = ()
    executor: str = "tree"
    graph: str = "rmat"

    def __post_init__(self):
        if self.executor not in ("tree", "wcoj", "auto"):
            raise ValueError(f"unknown executor {self.executor!r} "
                             "(expected 'tree', 'wcoj' or 'auto')")
        if self.graph not in ("rmat", "planted"):
            raise ValueError(f"unknown graph {self.graph!r} (expected 'rmat' or 'planted')")
        if self.graph == "planted" and (1 << self.n_log2, self.n_edges) != (PLANTED_N,
                                                                             PLANTED_M_BG):
            raise ValueError(f"the planted graph has {PLANTED_N} vertices and {PLANTED_M_BG} "
                             f"background edges; got n_log2={self.n_log2}, "
                             f"n_edges={self.n_edges}")


# The "WT~" stand-in of the paper's WikiTalk graph (benchmarks/common.py,
# rmat_graph(12, 10_000, seed=1)) at m = 8, 64 + 64 edge batches. group_cap
# is doubled three times from 16_384: the CC-join packs its candidate pairs
# (before the set intersection empties some) into group_cap slots on the
# owner of the join key, and the owner of the hubs' keys overflowed 65_536.
WT_Q1 = RunConfig(n_log2=12, n_edges=10_000, graph_seed=1, pattern="q1_square", m=8,
                  v_cap=2048, deg_cap=512, e_cap=8192, match_cap=524_288,
                  group_cap=131_072, set_cap=512, pair_cap=512)

# A streaming service maintaining two patterns in one fused step a batch, as
# examples/dynamic_subgraph_service.py --backend sharded --patterns
# q2_triangle,q1_square does: WT~ and the caps of WT_Q1. q5_house does not
# fit one card at this size (its estimated store is 2,071,424 x 4,480 x 2
# compressed vertices).
WT_MULTI = dataclasses.replace(WT_Q1, more_patterns=("q2_triangle",))

# The graph and caps of examples/distributed_listing.py.
EXAMPLE_Q1 = RunConfig(n_log2=7, n_edges=320, graph_seed=0, pattern="q1_square", m=8,
                       v_cap=128, deg_cap=64, e_cap=1024, match_cap=8192,
                       group_cap=4096, set_cap=64, pair_cap=256, n_add=4, n_del=4)

# A service keeping dense patterns on the WikiTalk stand-in: q6_clique5 and
# q4_clique4 under executor="auto", which picks the generic join for both
# (its summed prefix estimates cost less than the join tree on WT~).
WT_CLIQUE = dataclasses.replace(WT_Q1, pattern="q6_clique5", more_patterns=("q4_clique4",),
                                executor="auto")

# examples/dynamic_subgraph_service.py --backend sharded --executor auto with
# the patterns of WT_MULTI: q1_square stays on its join tree and q2_triangle
# takes the generic join, so one megastep holds both kinds of slot.
WT_MULTI_AUTO = dataclasses.replace(WT_MULTI, executor="auto")

# The planted near-clique graph of benchmarks/bench_wcoj.py at m = 1, with
# the engine caps the streaming service sizes for it (stream/service.py
# _default_caps). On this graph "auto" keeps every library pattern on its
# join tree, so the generic join is asked for; a tree run of the same
# pattern sets its own match_cap and group_cap.
PLANTED_K5 = RunConfig(n_log2=12, n_edges=12_000, graph_seed=0, pattern="q6_clique5", m=1,
                       v_cap=6208, deg_cap=72, e_cap=24_768, match_cap=4096, group_cap=4096,
                       set_cap=64, pair_cap=128, executor="wcoj", graph="planted")
PLANTED_K4 = dataclasses.replace(PLANTED_K5, pattern="q4_clique4")

CONFIGS = {"wt": WT_Q1, "wt_multi": WT_MULTI, "wt_clique": WT_CLIQUE,
           "wt_multi_auto": WT_MULTI_AUTO, "example": EXAMPLE_Q1,
           "planted_k5": PLANTED_K5, "planted_k4": PLANTED_K4}


def _require_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class PatternPlan:
    """One pattern of a pipeline: its plan, executor, caps and stage-1
    steps, and the estimated cost the executor was chosen on. A WCOJ
    pattern has its plan ``wcoj``, calibrated ``level_caps`` and no carry
    (``refresh_step`` is None)."""

    name: str
    pattern: Pattern
    ord: Tuple[Tuple[int, int], ...]
    cover: Tuple[int, ...]
    prog: TreeProgram
    units: Tuple[R1Unit, ...]
    store_caps: sharded.StoreCaps
    unit_caps: sharded.StoreCaps
    list_step: Callable
    init_step: Callable
    refresh_step: Optional[Callable]
    executor: str = "tree"
    wcoj: Optional[WcojPlan] = None
    level_caps: Optional[Tuple[int, ...]] = None
    cost: float = 0.0

    def spec(self) -> sharded.MaintainSpec:
        return sharded.MaintainSpec(name=self.name, prog=self.prog, units=self.units,
                                    store=self.store_caps, unit_caps=self.unit_caps,
                                    wcoj=self.wcoj, wcoj_level_caps=self.level_caps)

    def gib(self, caps: EngineCaps, m: int) -> Dict[str, float]:
        """Device GiB of this pattern's store and carry, from their caps; for
        a WCOJ pattern also its widest level tensor, the ``[level_caps[i-1],
        deg_cap]`` candidates of one partition's level ``i``."""
        def table(groups, skel, n_sets, width):
            return groups * (4 * skel + 1 + 4 * n_sets * width)

        if self.wcoj is not None:
            k = len(self.wcoj.order)
            rows = max(self.level_caps[:-1])
            return {"unit_plans": 0,
                    "store_gib": m * table(self.store_caps.group_cap, k, 0, 0) / 2**30,
                    "carry_gib": 0.0, "widest_level": [rows, caps.deg_cap],
                    "widest_level_gib": rows * caps.deg_cap * 4 / 2**30}
        root = self.prog.nodes[self.prog.root]
        n_comp = len(set(self.pattern.vertices) - set(self.cover))
        store = table(self.store_caps.group_cap, len(root.skel_cols), n_comp,
                      self.store_caps.set_cap)
        carry = 0
        plans, _ = sharded.unit_plan_registry(self.prog, self.units)
        for up in plans.values():
            skel = sum(1 for c in up.cols if c in self.cover)
            carry += caps.match_cap * (4 * len(up.cols) + 1) + table(
                self.unit_caps.group_cap, skel, len(up.cols) - skel, self.unit_caps.set_cap)
        return {"unit_plans": len(plans), "store_gib": m * store / 2**30,
                "carry_gib": m * carry / 2**30}


def plan_pattern(name: str, stats: GraphStats, storage, caps: EngineCaps,
                 mesh: LocalMesh | ProcessMesh,
                 executor: str = "tree") -> PatternPlan:
    """Compile one library pattern for ``mesh.size`` partitions, as the
    service's registration does: :func:`~repro_torch.planner.compile_plan`
    (symmetry breaking, cover, join tree, caps, executor) and, for the
    generic join, the calibration of its level caps and store groups over
    ``storage`` (the host NP storage the partitions were padded from)."""
    plan = compile_plan(CompileContext(pattern=PATTERN_LIBRARY[name], stats=stats,
                                       m=mesh.size, caps=caps, executor=executor))
    common = dict(name=name, pattern=plan.pattern, ord=plan.ord, cover=plan.cover,
                  prog=plan.program, units=plan.units, unit_caps=plan.unit_caps,
                  cost=plan.cost)
    if plan.executor == "wcoj":
        # the service's register-time calibration: observed level sizes set
        # the level caps, the last level's the store's group floor
        level_caps, floor = calibrate_wcoj_caps(storage, plan.wcoj)
        store_caps = quantize_store_caps(dataclasses.replace(
            plan.store_caps, group_cap=max(plan.store_caps.group_cap, floor)))
        return PatternPlan(
            **common, store_caps=store_caps,
            list_step=sharded.make_wcoj_list_step(plan.pattern, plan.wcoj, mesh, caps,
                                                  level_caps),
            init_step=sharded.make_wcoj_init_store_step(plan.pattern, plan.ord, mesh,
                                                        store_caps),
            refresh_step=None, executor="wcoj", wcoj=plan.wcoj, level_caps=level_caps)
    prog = plan.program
    return PatternPlan(
        **common, store_caps=plan.store_caps,
        list_step=sharded.make_list_step(prog, mesh, caps),
        init_step=sharded.make_init_store_step(prog, mesh, caps, plan.store_caps),
        refresh_step=sharded.make_unit_refresh_step(prog, plan.units, mesh, caps,
                                                    plan.unit_caps))


class Pipeline:
    """Stage 1 and stage 2 of the configuration's patterns over one graph,
    on one device, or on this rank's share of a
    :class:`~repro_torch.mesh.ProcessMesh` of ``config.m`` partitions
    (``mesh``; every rank builds the same pipeline and runs the same
    stages; its stores, carries and partitions hold its own partitions)."""

    def __init__(self, config: RunConfig, device="cuda", use_kernels: bool = True,
                 mesh: Optional[ProcessMesh] = None):
        self.config = config
        self.device = _require_device(device)
        if mesh is not None:
            if mesh.size != config.m or mesh.device.type != self.device.type:
                raise ValueError(f"a mesh of {mesh.size} partitions on {mesh.device} does "
                                 f"not run {config.m} partitions on {self.device}")
            self.device = mesh.device
        if config.graph == "planted":
            self.graph = planted_graph(seed=config.graph_seed)
        else:
            self.graph = rmat_graph(config.n_log2, config.n_edges, seed=config.graph_seed)
        stats = GraphStats.of(self.graph)
        c = config
        self.caps = EngineCaps(v_cap=c.v_cap, deg_cap=c.deg_cap, e_cap=c.e_cap,
                               match_cap=c.match_cap, group_cap=c.group_cap,
                               set_cap=c.set_cap, pair_cap=c.pair_cap,
                               use_kernels=use_kernels)
        self.mesh = LocalMesh(c.m) if mesh is None else mesh
        storage = build_np_storage(self.graph, c.m)
        self.plans = {name: plan_pattern(name, stats, storage, self.caps, self.mesh,
                                         c.executor)
                      for name in (c.pattern, *c.more_patterns)}
        main = self.plans[c.pattern]
        # the first pattern's plan, as single-pattern callers read it
        self.pattern, self.ord, self.cover = main.pattern, main.ord, main.cover
        self.prog, self.store_caps = main.prog, main.store_caps
        self.ushapes = sharded.UpdateShapes.from_estimator(c.n_add, c.n_del, stats,
                                                           self.caps, c.m)
        self.storage_step = sharded.make_storage_update_step(self.mesh, self.caps,
                                                             self.ushapes)
        self.maintain_step = sharded.make_maintain_mega_step(
            [p.spec() for p in self.plans.values()], self.mesh, self.caps)
        self.pt = sharded.stack_partitions(storage, self.caps, self.device,
                                           parts=self.mesh.indices())
        self.stores = None
        self.carries = None
        self.batches = 0

    @property
    def store(self):
        """The first pattern's match store."""
        return None if self.stores is None else self.stores[self.config.pattern]

    def describe(self) -> Dict:
        """The plan and every cap, as plain values; per pattern its executor
        and the estimated cost it was chosen on, cover, caps (and a WCOJ
        pattern's level caps) and the GiB of its store and carry."""
        return {"graph": {"n": self.graph.n, "edges": self.graph.num_edges},
                "pattern": self.config.pattern, "cover": list(self.cover), "m": self.config.m,
                "caps": {k: v for k, v in dataclasses.asdict(self.caps).items()
                         if k != "use_kernels"},
                "store_caps": dataclasses.asdict(self.store_caps),
                "update_shapes": dataclasses.asdict(self.ushapes),
                "patterns": {name: {"executor": p.executor, "cost": p.cost,
                                    "level_caps": None if p.level_caps is None
                                    else list(p.level_caps),
                                    "cover": list(p.cover),
                                    "store_caps": dataclasses.asdict(p.store_caps),
                                    "unit_caps": dataclasses.asdict(p.unit_caps),
                                    **p.gib(self.caps, self.config.m)}
                             for name, p in self.plans.items()}}

    def list_pattern(self, name: str = None):
        """Stage 1 of one pattern (the first by default) over the current
        partitions: ``(store, diag)``."""
        p = self.plans[name or self.config.pattern]
        root, ldiag = p.list_step(self.pt)
        store, idiag = p.init_step(root)
        diag = {"count": idiag["count"], "groups": ldiag["matches_lower_bound"],
                "store_groups": idiag["store_groups"],
                "overflow": ldiag["overflow"] + idiag["overflow"]}
        return store, diag

    def initial(self) -> Dict:
        """Stage 1: list every pattern, seed its match store and fill its
        unit-table carry (whose overflow joins the pattern's). A WCOJ
        pattern has no carry, and its listing or store overflowing raises,
        as the service's registration does."""
        self.stores, self.carries, per = {}, {}, {}
        for name, p in self.plans.items():
            self.stores[name], diag = self.list_pattern(name)
            if p.refresh_step is None:
                if int(diag["overflow"]):
                    raise ValueError(
                        f"{name}: the initial WCOJ listing or store overflowed its caps "
                        f"({int(diag['overflow'])} rows)")
                self.carries[name] = {}
            else:
                self.carries[name], rdiag = p.refresh_step(self.pt)
                diag["overflow"] = diag["overflow"] + rdiag["overflow"]
            per[name] = diag
        return self._record(per, {})

    def next_update(self) -> GraphUpdate:
        """The next batch: ``n_del`` deletions + ``n_add`` insertions drawn
        from the current graph by the batch's seed."""
        c = self.config
        return sample_update(self.graph, c.n_del, c.n_add, seed=c.update_seed + self.batches)

    def apply(self, update: GraphUpdate) -> Dict:
        """Stage 2 for one batch: the storage update, then the carried
        megastep over every pattern. Returns its diag (``count`` = |M(p,
        d')|, per pattern when there are several)."""
        if self.stores is None or self.carries is None:
            raise RuntimeError("call initial() before apply()")
        add = torch.from_numpy(np.asarray(update.add, np.int32).reshape(-1, 2)).to(self.device)
        dele = torch.from_numpy(np.asarray(update.delete, np.int32).reshape(-1, 2)).to(self.device)
        self.pt, sdiag = self.storage_step(self.pt, add, dele)
        self.stores, _, self.carries, mdiag = self.maintain_step(
            self.pt, self.stores, self.carries, sdiag["part_dirty"], add, dele)
        self.graph = self.graph.apply_update(update)
        self.batches += 1
        per = {name: {k: d[k] for k in ("count", "patch_groups", "removed_groups",
                                        "overflow", "unit_refreshes")}
               for name, d in mdiag.items()}
        maintain_ovf = sum(d["overflow"] for d in per.values())
        return self._record(per, {
            "cand_vertices": sdiag["cand_vertices"], "cand_edges": sdiag["cand_edges"],
            "overflow": sdiag["overflow"] + maintain_ovf,
            "storage_overflow": sdiag["overflow"], "maintain_overflow": maintain_ovf})

    def _record(self, per: Dict[str, Dict], common: Dict) -> Dict:
        """One pattern's keys at the top level; several patterns' under
        ``patterns``, with the overflow summed."""
        if len(per) == 1:
            (diag,) = per.values()
            return {**diag, **common}
        rec = {"overflow": sum(d["overflow"] for d in per.values()), **common}
        rec["patterns"] = per
        return rec


def _ints(diag: Dict) -> Dict:
    return {k: _ints(v) if isinstance(v, dict) else int(v) for k, v in diag.items()}


def stages(pipe: Pipeline, batches: int) -> Iterator[Dict]:
    """Stage 1, then ``batches`` stage-2 batches of ``pipe``. Yields one
    record per stage: its diag as ints, ``phase`` (``"stage1"`` or
    ``"batch"``), ``batch``, the wall ``seconds`` (synchronized on the
    device) and, on a card, ``peak_gib`` (``max_memory_allocated``). The
    caller may read ``pipe.store`` between records."""
    cuda = pipe.device.type == "cuda"
    for b in range(-1, batches):
        update = pipe.next_update() if b >= 0 else None
        if cuda:
            torch.cuda.reset_peak_memory_stats(pipe.device)
        t0 = time.perf_counter()
        diag = pipe.initial() if update is None else pipe.apply(update)
        rec = _ints(diag)
        if cuda:
            torch.cuda.synchronize(pipe.device)
        rec.update(phase="stage1" if update is None else "batch",
                   seconds=time.perf_counter() - t0)
        if update is not None:
            rec["batch"] = b
        if cuda:
            rec["peak_gib"] = torch.cuda.max_memory_allocated(pipe.device) / 2**30
        yield rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="wt")
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _require_device(args.device)
    pipe = Pipeline(CONFIGS[args.config], dev, use_kernels=dev.type == "cuda")
    print(json.dumps({"phase": "plan", **pipe.describe()}), flush=True)
    for rec in stages(pipe, args.batches):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
