"""The port's main path: list a pattern once, then maintain it under batches.

:class:`Pipeline` builds the graph, the NP storage, the plan and the caps,
puts the stacked partitions on the device, runs stage 1
(:func:`~repro_torch.sharded.make_list_step` +
:func:`~repro_torch.sharded.make_init_store_step`) and then answers each
update batch with stage 2 (:func:`~repro_torch.sharded.make_storage_update_step`
+ :func:`~repro_torch.sharded.make_maintain_step`). Its answer to a batch
is the exact maintained match count.

:func:`stages` is the driver: it runs stage 1 and then the batches, and
yields each stage's diag with its time and peak device memory.

    PYTHONPATH=src python -m repro_torch.run            # WT~ / q1_square, one H100
    PYTHONPATH=src python -m repro_torch.run --device cpu --config example
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Iterator

import numpy as np
import torch

from .core.cost import CostModel
from .core.estimator import GraphStats
from .core.graph import GraphUpdate
from .core.join_tree import minimum_unit_decomposition, optimal_join_tree
from .core.pattern import PATTERN_LIBRARY, symmetry_break
from .core.storage import build_np_storage
from .data.graphs import rmat_graph, sample_update
from .engine import EngineCaps
from .mesh import LocalMesh
from .planner.compiler import choose_cover
from .planner.lowering import build_tree_program
from .planner.sizing import match_caps
from . import sharded

__all__ = ["RunConfig", "WT_Q1", "EXAMPLE_Q1", "Pipeline", "stages"]


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One deployment: an R-MAT graph, a pattern, ``m`` partitions, the
    engine caps and the batch shape. The store caps and the candidate caps
    of the update come from the §IV-D estimators."""

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


# The "WT~" stand-in of the paper's WikiTalk graph (benchmarks/common.py,
# rmat_graph(12, 10_000, seed=1)) at m = 8, 64 + 64 edge batches. group_cap
# is doubled three times from 16_384: the CC-join packs its candidate pairs
# (before the set intersection empties some) into group_cap slots on the
# owner of the join key, and the owner of the hubs' keys overflowed 65_536.
WT_Q1 = RunConfig(n_log2=12, n_edges=10_000, graph_seed=1, pattern="q1_square", m=8,
                  v_cap=2048, deg_cap=512, e_cap=8192, match_cap=524_288,
                  group_cap=131_072, set_cap=512, pair_cap=512)

# The graph and caps of examples/distributed_listing.py.
EXAMPLE_Q1 = RunConfig(n_log2=7, n_edges=320, graph_seed=0, pattern="q1_square", m=8,
                       v_cap=128, deg_cap=64, e_cap=1024, match_cap=8192,
                       group_cap=4096, set_cap=64, pair_cap=256, n_add=4, n_del=4)

CONFIGS = {"wt": WT_Q1, "example": EXAMPLE_Q1}


def _require_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


class Pipeline:
    """Stage 1 and stage 2 of one pattern over one graph, on one device."""

    def __init__(self, config: RunConfig, device="cuda", use_kernels: bool = True):
        self.config = config
        self.device = _require_device(device)
        self.graph = rmat_graph(config.n_log2, config.n_edges, seed=config.graph_seed)
        self.pattern = PATTERN_LIBRARY[config.pattern]
        self.ord = symmetry_break(self.pattern)
        stats = GraphStats.of(self.graph)
        self.cover = choose_cover(self.pattern, self.ord, stats)
        tree = optimal_join_tree(self.pattern, self.cover,
                                 CostModel(self.cover, self.ord, stats))
        self.prog = build_tree_program(tree, self.cover, self.ord)
        self.units = minimum_unit_decomposition(self.pattern, self.cover)
        c = config
        self.caps = EngineCaps(v_cap=c.v_cap, deg_cap=c.deg_cap, e_cap=c.e_cap,
                               match_cap=c.match_cap, group_cap=c.group_cap,
                               set_cap=c.set_cap, pair_cap=c.pair_cap,
                               use_kernels=use_kernels)
        self.store_caps = match_caps(self.pattern, self.cover, self.ord, stats, self.caps)
        self.ushapes = sharded.UpdateShapes.from_estimator(c.n_add, c.n_del, stats,
                                                           self.caps, c.m)
        self.mesh = LocalMesh(c.m)
        self.list_step = sharded.make_list_step(self.prog, self.mesh, self.caps)
        self.init_step = sharded.make_init_store_step(self.prog, self.mesh, self.caps,
                                                      self.store_caps)
        self.storage_step = sharded.make_storage_update_step(self.mesh, self.caps,
                                                             self.ushapes)
        self.maintain_step = sharded.make_maintain_step(self.prog, self.units, self.mesh,
                                                        self.caps, self.store_caps)
        self.pt = sharded.stack_partitions(build_np_storage(self.graph, c.m), self.caps,
                                           self.device)
        self.store = None
        self.batches = 0

    def describe(self) -> Dict:
        """The plan and every cap, as plain values."""
        return {"graph": {"n": self.graph.n, "edges": self.graph.num_edges},
                "pattern": self.config.pattern, "cover": list(self.cover), "m": self.config.m,
                "caps": {k: v for k, v in dataclasses.asdict(self.caps).items()
                         if k != "use_kernels"},
                "store_caps": dataclasses.asdict(self.store_caps),
                "update_shapes": dataclasses.asdict(self.ushapes)}

    def list_pattern(self):
        """Stage 1 over the current partitions: ``(store, diag)``."""
        root, ldiag = self.list_step(self.pt)
        store, idiag = self.init_step(root)
        diag = {"count": idiag["count"], "groups": ldiag["matches_lower_bound"],
                "store_groups": idiag["store_groups"],
                "overflow": ldiag["overflow"] + idiag["overflow"]}
        return store, diag

    def initial(self) -> Dict:
        """Stage 1: list the pattern and seed the match store."""
        self.store, diag = self.list_pattern()
        return diag

    def next_update(self) -> GraphUpdate:
        """The next batch: ``n_del`` deletions + ``n_add`` insertions drawn
        from the current graph by the batch's seed."""
        c = self.config
        return sample_update(self.graph, c.n_del, c.n_add, seed=c.update_seed + self.batches)

    def apply(self, update: GraphUpdate) -> Dict:
        """Stage 2 for one batch; returns its diag (``count`` = |M(p, d')|)."""
        if self.store is None:
            raise RuntimeError("call initial() before apply()")
        add = torch.from_numpy(np.asarray(update.add, np.int32).reshape(-1, 2)).to(self.device)
        dele = torch.from_numpy(np.asarray(update.delete, np.int32).reshape(-1, 2)).to(self.device)
        self.pt, sdiag = self.storage_step(self.pt, add, dele)
        self.store, patch, mdiag = self.maintain_step(self.pt, self.store, add, dele)
        self.graph = self.graph.apply_update(update)
        self.batches += 1
        return {"count": mdiag["count"], "cand_vertices": sdiag["cand_vertices"],
                "cand_edges": sdiag["cand_edges"], "patch_groups": mdiag["patch_groups"],
                "removed_groups": mdiag["removed_groups"],
                "overflow": sdiag["overflow"] + mdiag["overflow"],
                "storage_overflow": sdiag["overflow"], "maintain_overflow": mdiag["overflow"]}


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
        rec = {k: int(v) for k, v in diag.items()}
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
