"""State carried across from the JAX engine, and back.

The ``*_from_numpy`` functions take the leaves of the JAX
``PaddedPartition`` / ``CompTensors`` / ``MatchStore`` (anything with
those attributes whose values ``numpy.asarray`` accepts) and build the
port's tensors; :func:`comp_to_numpy` hands port tensors back as NumPy
arrays, in the layout ``repro.dist.jax_engine.comp_to_host`` reads.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import CompTensors, PaddedPartition, map_tensors
from .sharded import MatchStore

__all__ = ["partitions_from_numpy", "comp_from_numpy", "store_from_numpy",
           "comp_to_numpy", "to_numpy"]


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
