"""Mesh builders: twins of ``repro/launch/mesh.py``.

:func:`make_local_mesh` keeps every partition in this process
(:class:`~repro_torch.mesh.LocalMesh`); :func:`init_process_mesh` starts
the process group that ``torchrun`` or a spawner describes in the
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) and spreads the partitions over its ranks
(:class:`~repro_torch.mesh.ProcessMesh`): NCCL, one rank a card, on a
CUDA device; gloo on the CPU. For LM training, :func:`init_grid_mesh` (JAX's
``make_local_mesh(data, model)``) and :func:`make_production_mesh` start the
same group and lay a :class:`~repro_torch.mesh.GridMesh` of named axes over
it. None touches a device or a process group when this module is imported.
"""

from __future__ import annotations

import datetime
import math
import os

import torch

from ..mesh import GridMesh, LocalMesh, ProcessMesh
from ..run import _require_device

__all__ = ["make_local_mesh", "init_process_mesh", "init_grid_mesh", "make_production_mesh",
           "DEFAULT_TIMEOUT_S"]

#: seconds a collective may wait for the other ranks before the run fails
DEFAULT_TIMEOUT_S = 300.0


def make_local_mesh(m: int) -> LocalMesh:
    """``m`` partitions in this process, on one device."""
    return LocalMesh(m)


def init_process_mesh(m: int, device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
                      init_method: str = "env://") -> ProcessMesh:
    """Join the process group of this rank and return the mesh of ``m``
    partitions over it.

    The rank, world size and local rank come from ``RANK``, ``WORLD_SIZE``
    and ``LOCAL_RANK`` (``LOCAL_RANK`` defaults to ``RANK``); the group's
    rendezvous from ``init_method`` (``env://`` reads ``MASTER_ADDR`` and
    ``MASTER_PORT``). On a CUDA device the rank takes ``cuda:LOCAL_RANK``
    before the group starts, and the group runs on NCCL; on the CPU on
    gloo. ``timeout_s`` bounds every collective: a rank whose peers took
    another branch fails instead of hanging. Without CUDA, a CUDA device
    raises."""
    return ProcessMesh(m, _init_group(device, timeout_s, init_method))


def _init_group(device, timeout_s: float, init_method: str) -> torch.device:
    """Start this rank's process group from the environment (see
    :func:`init_process_mesh`); returns the rank's device."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = _require_device(device)
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
        kw["device_id"] = dev
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group for device {dev}")
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def init_grid_mesh(data: int | None = None, model: int = 1, device="cuda",
                   timeout_s: float = DEFAULT_TIMEOUT_S,
                   init_method: str = "env://") -> GridMesh:
    """Join the process group of this rank (as :func:`init_process_mesh`)
    and lay a ``(data, model)`` grid with axes ``("data", "model")`` over
    it: JAX's ``make_local_mesh(data, model)``, ``data`` by default the
    world size over ``model``."""
    world = int(os.environ["WORLD_SIZE"])
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) grid needs {data * model} ranks, the world "
                         f"has {world}")
    return GridMesh((data, model), ("data", "model"),
                    _init_group(device, timeout_s, init_method))


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         timeout_s: float = DEFAULT_TIMEOUT_S,
                         init_method: str = "env://") -> GridMesh:
    """JAX's production mesh: ``(16, 16)`` over ``("data", "model")``, or
    with ``multi_pod`` ``(2, 16, 16)`` over ``("pod", "data", "model")``.
    It raises, naming both numbers, unless the world (``WORLD_SIZE``) has
    256 / 512 ranks."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = math.prod(sizes)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != want:
        raise ValueError(f"the production mesh {sizes} needs {want} ranks, the world has "
                         f"{world}")
    return GridMesh(sizes, axes, _init_group(device, timeout_s, init_method))
