"""State carried across from the JAX engine, and back.

The ``*_from_numpy`` functions take the leaves of the JAX
``PaddedPartition`` / ``CompTensors`` / ``MatchStore`` (anything with
those attributes whose values ``numpy.asarray`` accepts) and build the
port's tensors; :func:`comp_to_numpy` hands port tensors back as NumPy
arrays, in the layout ``repro.dist.jax_engine.comp_to_host`` reads.
:func:`gnn_params_from_numpy` and :func:`graph_from_numpy` carry the GNN
parameters and a ``build_graph_data`` dict across, :func:`dlrm_params_from_numpy`
the DLRM parameters, :func:`lm_params_from_numpy` the transformer's nested
parameter dict.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import CompTensors, PaddedPartition, map_tensors
from .sharded import MatchStore

__all__ = ["partitions_from_numpy", "comp_from_numpy", "store_from_numpy",
           "comp_to_numpy", "to_numpy", "gnn_params_from_numpy", "dlrm_params_from_numpy",
           "lm_params_from_numpy", "graph_from_numpy"]


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
    ``final_norm``, ``lm_head`` and the layer-stacked ``dense`` dict."""
    return {name: lm_params_from_numpy(v, device) if isinstance(v, dict) else _param(v, device)
            for name, v in params.items()}


def graph_from_numpy(raw, device="cuda"):
    """A port ``models.gnn.GraphData`` from a ``build_graph_data`` dict.
    The model layer is imported here, not with this module, so that the
    DDSL state converters do not pull it in."""
    from .models.gnn import GraphData

    return GraphData(**{k: torch.from_numpy(np.ascontiguousarray(raw[k])).to(device)
                        for k in GraphData.__dataclass_fields__})
