"""State carried across from the JAX engine, and back.

The ``*_from_numpy`` functions take the leaves of the JAX
``PaddedPartition`` / ``CompTensors`` / ``MatchStore`` (anything with
those attributes whose values ``numpy.asarray`` accepts) and build the
port's tensors; :func:`comp_to_numpy` hands port tensors back as NumPy
arrays, in the layout ``repro.dist.jax_engine.comp_to_host`` reads.
:func:`gnn_params_from_numpy` and :func:`graph_from_numpy` carry the GNN
parameters and a ``build_graph_data`` dict across (:func:`graph_shard` a
rank's shard of it on a grid mesh, :func:`graph_unshard` the ranks' shards
whole again), :func:`dlrm_params_from_numpy`
the DLRM parameters, :func:`lm_params_from_numpy` the transformer's nested
parameter dict; :func:`lm_params_shard` / :func:`dlrm_params_shard` cut one
rank's shards of either on a grid mesh, and :func:`lm_params_unshard` /
:func:`dlrm_params_unshard` put every rank's shards (of the parameters, or
of the ZeRO-1 moments) back together whole.
:func:`adamw_state_from_numpy` carries a JAX ``AdamWState`` across, so that
a JAX run's optimizer state continues in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import CompTensors, PaddedPartition, map_tensors
from .optim import AdamWState
from .sharded import MatchStore

__all__ = ["partitions_from_numpy", "comp_from_numpy", "store_from_numpy",
           "comp_to_numpy", "to_numpy", "gnn_params_from_numpy", "dlrm_params_from_numpy",
           "lm_params_from_numpy", "lm_params_shard", "lm_params_unshard", "dlrm_params_shard",
           "dlrm_params_unshard", "graph_from_numpy",
           "graph_shard", "graph_unshard", "node_rows", "adamw_state_from_numpy"]


def _tensor(a, device) -> torch.Tensor:
    arr = np.array(a, copy=True, order="C")
    if arr.dtype != np.bool_:
        arr = arr.astype(np.int32)
    return torch.from_numpy(arr).to(device)


def _from(cls, src, device):
    fields = {}
    for name in cls.__dataclass_fields__:
        v = getattr(src, name)
        fields[name] = ({int(k): _tensor(a, device) for k, a in v.items()}
                        if isinstance(v, dict) else _tensor(v, device))
    return cls(**fields)


def partitions_from_numpy(pt, device="cuda") -> PaddedPartition:
    """Port tensors of a (stacked or single) JAX ``PaddedPartition``."""
    return _from(PaddedPartition, pt, device)


def comp_from_numpy(tc, device="cuda") -> CompTensors:
    """Port tensors of a JAX ``CompTensors``."""
    return _from(CompTensors, tc, device)


def store_from_numpy(st, device="cuda") -> MatchStore:
    """Port tensors of a JAX ``MatchStore``."""
    return _from(MatchStore, st, device)


def to_numpy(x):
    """Any port dataclass with its tensors as NumPy arrays."""
    return map_tensors(lambda a: a.detach().cpu().numpy(), x)


def comp_to_numpy(tc: CompTensors) -> CompTensors:
    """A port ``CompTensors`` with NumPy leaves (for ``comp_to_host``)."""
    return to_numpy(tc)


def _param(v, device) -> torch.Tensor:
    """A port tensor of one NumPy-convertible parameter leaf, in its own
    type. bfloat16 passes through float32, which holds every bfloat16
    value exactly."""
    arr = np.asarray(v)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(device)


def gnn_params_from_numpy(params, device="cuda"):
    """Port tensors of a flat JAX parameter dict (NumPy-convertible leaves):
    a GNN's, or DLRM's (``tables``, ``bot_w*``, ``bot_b*``, ``top_w*``,
    ``top_b*``)."""
    return {name: _param(v, device) for name, v in params.items()}


dlrm_params_from_numpy = gnn_params_from_numpy


def lm_params_from_numpy(params, device="cuda"):
    """Port tensors of a JAX transformer parameter dict: ``embed``,
    ``final_norm``, ``lm_head`` and the layer-stacked ``dense`` and ``moe``
    dicts (each where the config has such layers), leaf for leaf."""
    return {name: lm_params_from_numpy(v, device) if isinstance(v, dict) else _param(v, device)
            for name, v in params.items()}


def _cut(place, mesh, rank, device):
    """One leaf's slice for rank ``rank`` by its fixed spec, a tensor of
    its own on ``device`` (from a port tensor or anything NumPy takes)."""
    def cut(name, v):
        sl = mesh.slices(place[name].spec, place[name].shape, rank)
        if isinstance(v, torch.Tensor):
            return v[sl].to(device, copy=True)
        return _param(np.asarray(v)[sl], device)

    return cut


def lm_params_shard(params, cfg, mesh, rank: int | None = None, device="cuda"):
    """Rank ``rank``'s shards (``mesh.rank`` by default) of a whole
    transformer parameter dict, JAX's (NumPy-convertible leaves) or the
    port's tensors, cut by the fixed specs (``models.transformer.lm_placements``
    on the grid ``mesh``, a :class:`~repro_torch.mesh.GridShape`): the same
    nested dict, each leaf its slice, a tensor of its own on ``device``. The
    model layer is imported here, as in :func:`graph_from_numpy`."""
    from .models.transformer import lm_placements

    cut = _cut(lm_placements(cfg, mesh), mesh, mesh.rank if rank is None else rank, device)
    return {k: ({n: cut(f"{k}/{n}", t) for n, t in v.items()} if isinstance(v, dict)
                else cut(k, v)) for k, v in params.items()}


def dlrm_params_shard(params, cfg, mesh, rank: int | None = None, device="cuda"):
    """Rank ``rank``'s shards (``mesh.rank`` by default) of DLRM's flat
    parameter dict, JAX's (NumPy-convertible leaves, as
    :func:`dlrm_params_from_numpy` takes them) or the port's tensors, cut by
    ``models.dlrm.dlrm_placements``: its rows of the tables (all of them
    where ``"model"`` does not divide them), the MLP leaves whole; each a
    tensor of its own on ``device``."""
    from .models.dlrm import dlrm_placements

    cut = _cut(dlrm_placements(cfg, mesh), mesh, mesh.rank if rank is None else rank, device)
    return {k: cut(k, v) for k, v in params.items()}


def _unshard(place, pieces, mesh, moments: bool):
    """The whole leaves, by flat name, from ``pieces[r]``, rank ``r``'s flat
    dict of NumPy shards placed by ``place`` (parameter or, with
    ``moments``, moment specs). Ranks that hold the same slice must hold the
    same values; a difference raises."""
    out = {}
    for name, p in place.items():
        spec = p.moment_spec if moments else p.spec
        whole, seen = None, set()
        for r, piece in enumerate(pieces):
            part = np.asarray(piece[name])
            if whole is None:
                whole = np.empty(p.shape, part.dtype)
            sl = mesh.slices(spec, p.shape, r)
            key = tuple((s.start, s.stop) for s in sl)
            if key in seen:
                if not np.array_equal(whole[sl], part):
                    raise ValueError(f"{name}: rank {r} holds other values than its replicas")
            else:
                whole[sl] = part
                seen.add(key)
        out[name] = whole
    return out


def lm_params_unshard(pieces, cfg, mesh, moments: bool = False):
    """The whole leaves, by flat name, from ``pieces[r]``, rank ``r``'s flat
    dict of NumPy shards: of the parameters by their fixed specs, or with
    ``moments`` of AdamW's ZeRO-1 moments by theirs. Ranks that hold the
    same slice must hold the same values; a difference raises."""
    from .models.transformer import lm_placements

    return _unshard(lm_placements(cfg, mesh), pieces, mesh, moments)


def dlrm_params_unshard(pieces, cfg, mesh, moments: bool = False):
    """:func:`lm_params_unshard` for DLRM's flat dict: the whole leaves from
    every rank's NumPy shards of the parameters, or with ``moments`` of the
    ZeRO-1 moments (``models.dlrm.dlrm_placements``)."""
    from .models.dlrm import dlrm_placements

    return _unshard(dlrm_placements(cfg, mesh), pieces, mesh, moments)


def graph_from_numpy(raw, device="cuda"):
    """A port ``models.gnn.GraphData`` from a ``build_graph_data`` dict.
    The model layer is imported here, not with this module, so that the
    DDSL state converters do not pull it in."""
    from .models.gnn import GraphData

    return GraphData(**{k: torch.from_numpy(np.ascontiguousarray(raw[k])).to(device)
                        for k in GraphData.__dataclass_fields__})


def node_rows(a, mesh) -> np.ndarray:
    """This rank's rows (``mesh.rank``'s) of an array split on its first
    dimension over every axis of the grid ``mesh`` in rank order: a graph's
    node or edge rows, or per-node labels, as ``graph_specs`` places them
    (NumPy in, NumPy out)."""
    a = np.asarray(a)
    return a[mesh.slices((tuple(mesh.axis_names),), a.shape, mesh.rank)]


def graph_shard(raw, mesh, device="cuda"):
    """This rank's shard (``mesh.rank``'s) of a padded graph,
    a ``build_graph_data`` dict (or anything with ``GraphData``'s fields
    that ``numpy.asarray`` takes), as ``models.gnn.graph_specs`` places it
    on the grid ``mesh``: its block of node rows and of edge rows, the edge
    ids global. The node and edge counts must split over the mesh
    (``launch.steps.gnn_counts(shape, n_dev)`` pads them)."""
    from .models.gnn import GraphData, graph_specs

    specs = graph_specs(mesh.axis_names)
    out = {}
    for k in GraphData.__dataclass_fields__:
        a = np.asarray(raw[k])
        out[k] = np.ascontiguousarray(a[mesh.slices(getattr(specs, k), a.shape, mesh.rank)])
    return graph_from_numpy(out, device)


def graph_unshard(pieces):
    """The whole graph (a dict of NumPy arrays by field) from ``pieces[r]``,
    rank ``r``'s shard (a ``GraphData`` or a dict of its fields): the
    inverse of :func:`graph_shard`, each field's blocks in rank order."""
    from .models.gnn import GraphData

    def field(p, k):
        v = p[k] if isinstance(p, dict) else getattr(p, k)
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    return {k: np.concatenate([field(p, k) for p in pieces])
            for k in GraphData.__dataclass_fields__}


def adamw_state_from_numpy(state, device="cuda") -> AdamWState:
    """A port ``AdamWState`` from a JAX one (``step``, and ``mu`` / ``nu``
    dicts by parameter name, NumPy-convertible): an int32 0-d step and
    float32 moments."""
    def moments(tree):
        return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")).to(device)
                for k, v in sorted(tree.items())}

    return AdamWState(step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                                        device=device),
                      mu=moments(state.mu), nu=moments(state.nu))

