"""Architecture registry of the port: the GNN, LM and recsys families it runs.

Copy of ``ShapeSpec``, ``ArchSpec``, ``get_arch``, ``LM_SHAPES``,
``GNN_SHAPES`` and ``RECSYS_SHAPES`` from ``repro/configs/registry.py``,
restricted to the architectures the port runs: gatedgcn, graphsage-reddit,
meshgraphnet and equiformer-v2 (GNN full-graph inference and training), the five LMs
phi4-mini-3.8b, minicpm3-4b, deepseek-v2-lite-16b, granite-moe-3b-a800m and command-r-35b
(serving on one device; the dense-GQA ones, phi4-mini-3.8b and command-r-35b, also training
on one device) and dlrm-rm2 (recsys serving and training).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

__all__ = ["ShapeSpec", "ArchSpec", "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "get_arch",
           "all_archs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | full_graph | minibatch | batched_graphs
    #            | recsys_train | recsys_serve | retrieval
    seq_len: int = 0
    global_batch: int = 0
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanouts: Tuple[int, ...] = ()
    batch_graphs: int = 0
    batch: int = 0
    n_candidates: int = 0


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                  # lm | gnn | recsys
    config: Any
    smoke: Any
    shapes: Tuple[ShapeSpec, ...]
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name}: unknown shape {name}")


_MODULES = ["phi4_mini_3_8b", "minicpm3_4b", "deepseek_v2_lite_16b", "granite_moe_3b_a800m",
            "command_r_35b", "gatedgcn", "graphsage_reddit", "meshgraphnet", "equiformer_v2",
            "dlrm_rm2"]

_REGISTRY: Dict[str, ArchSpec] = {}


def _load():
    if _REGISTRY:
        return
    for mod in _MODULES:
        spec = importlib.import_module(f"{__package__}.{mod}").SPEC
        _REGISTRY[spec.name] = spec


def get_arch(name: str) -> ArchSpec:
    _load()
    return _REGISTRY[name]


def all_archs() -> Dict[str, ArchSpec]:
    _load()
    return dict(_REGISTRY)


LM_SHAPES = (
    ShapeSpec(name="train_4k", kind="train", seq_len=4096, global_batch=256),
    ShapeSpec(name="prefill_32k", kind="prefill", seq_len=32768, global_batch=32),
    ShapeSpec(name="decode_32k", kind="decode", seq_len=32768, global_batch=128),
    # long_500k lowers serve_step (1 new token against a 512k KV cache) —
    # O(L) per token, runnable for full-attention archs; a 500k *prefill*
    # would need sub-quadratic attention and is not defined here.
    ShapeSpec(name="long_500k", kind="decode", seq_len=524288, global_batch=1),
)

# n_edges counts undirected edges; a full-graph run doubles them into
# directed ones (repro/launch/steps.py _gnn_counts).
GNN_SHAPES = (
    ShapeSpec(name="full_graph_sm", kind="full_graph", n_nodes=2708, n_edges=10556, d_feat=1433),
    ShapeSpec(name="minibatch_lg", kind="minibatch", n_nodes=232965, n_edges=114615892,
              batch_nodes=1024, fanouts=(15, 10), d_feat=602),
    ShapeSpec(name="ogb_products", kind="full_graph", n_nodes=2449029, n_edges=61859140, d_feat=100),
    ShapeSpec(name="molecule", kind="batched_graphs", n_nodes=30, n_edges=64, batch_graphs=128, d_feat=16),
)

RECSYS_SHAPES = (
    ShapeSpec(name="train_batch", kind="recsys_train", batch=65536),
    ShapeSpec(name="serve_p99", kind="recsys_serve", batch=512),
    ShapeSpec(name="serve_bulk", kind="recsys_serve", batch=262144),
    ShapeSpec(name="retrieval_cand", kind="retrieval", batch=1, n_candidates=1_000_000),
)
