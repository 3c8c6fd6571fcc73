"""Where the LM's leaves live on a grid mesh: twins of JAX's sharding helpers.

``repro/launch/steps.py``'s ``_axis_size``, ``_fix_spec``, ``_zero1_specs``
and ``_batch_axes``, and ``repro/models/common.py``'s ``data_axes``, with
specs as plain tuples (an entry a dimension: ``None``, an axis name, or a
tuple of names) since the port has no ``PartitionSpec``. A ``mesh`` here
is anything with a ``shape`` dict and ``axis_names``
(:class:`~repro_torch.mesh.GridShape`, :class:`~repro_torch.mesh.GridMesh`).
:func:`placements` turns a tree of specs and one of shapes into each
leaf's :class:`Placement`; ``models.transformer.lm_placements`` gives the
LM's. This module imports nothing of the package, so the mesh, the model,
the converters and the launch steps all read it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["MODEL", "data_axes", "axis_size", "fix_spec", "zero1_specs", "batch_axes",
           "Placement", "placements"]

#: the tensor- and expert-parallel axis
MODEL = "model"


def data_axes(mesh_axes: Sequence[str]) -> Tuple[str, ...]:
    """The batch-parallel axes: ``('pod', 'data')`` on multi-pod meshes."""
    return tuple(a for a in mesh_axes if a in ("pod", "data"))


def axis_size(mesh, axes) -> int:
    """Ranks along ``axes``: ``None`` 1, a name its size, a tuple the
    product."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def fix_spec(spec, shape, mesh) -> tuple:
    """The spec with the axes dropped from every dimension the shape does
    not divide, padded with ``None`` to the shape's rank."""
    fixed = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            fixed.append(ax)
        elif shape[i] % axis_size(mesh, ax) == 0:
            fixed.append(ax)
        else:
            fixed.append(None)
    fixed += [None] * (len(shape) - len(fixed))
    return tuple(fixed)


def zero1_specs(specs, shapes, mesh):
    """ZeRO-1: each leaf's spec with the data axes on its first free
    dimension they divide (none where the data axes have one rank). Runs on
    the specs before :func:`fix_spec`, as JAX's does. ``specs`` and
    ``shapes`` are trees of nested dicts alike."""
    daxes = data_axes(mesh.axis_names)
    dsize = axis_size(mesh, daxes)

    def one(spec, dims):
        entries = list(spec) + [None] * (len(dims) - len(spec))
        for i, (ax, n) in enumerate(zip(entries, dims)):
            if ax is None and n % dsize == 0 and n > 0 and dsize > 1:
                entries[i] = daxes if len(daxes) > 1 else daxes[0]
                break
        return tuple(entries)

    if isinstance(specs, dict):
        return {k: zero1_specs(specs[k], shapes[k], mesh) for k in specs}
    return one(specs, tuple(shapes))


def batch_axes(batch: int, mesh):
    """The axes a batch of ``batch`` rows is split over: the data axes where
    they divide it, else ``None`` (replicated)."""
    daxes = data_axes(mesh.axis_names)
    if daxes and batch % axis_size(mesh, daxes) == 0:
        return daxes if len(daxes) > 1 else daxes[0]
    return None


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one parameter leaf lives on a grid: its whole ``shape``, the
    fixed ``spec`` of the parameter and ``moment_spec`` of its AdamW
    moments (ZeRO-1, fixed after), the dimension the parameter splits over
    ``"model"`` (``model_dim``) and the one the moments split over the data
    axes (``data_dim``), each ``None`` where there is none."""

    shape: Tuple[int, ...]
    spec: tuple
    moment_spec: tuple
    model_dim: Optional[int]
    data_dim: Optional[int]


def placements(specs, shapes, mesh) -> Dict[str, Placement]:
    """Each leaf's :class:`Placement` by flat name (``group/leaf``, sorted,
    as ``launch.steps.flat_params`` names them), from the unfixed ``specs``
    and the ``shapes`` of one tree, as ``_lm_cell`` places them: the
    parameter specs fixed, the moments' by :func:`zero1_specs` and then
    fixed."""
    moments = zero1_specs(specs, shapes, mesh)
    daxes = data_axes(mesh.axis_names)
    data_entry = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    out = {}
    for name, shape, spec, mspec in _flat(specs, shapes, moments):
        spec, mspec = fix_spec(spec, shape, mesh), fix_spec(mspec, shape, mesh)
        out[name] = Placement(tuple(shape), spec, mspec,
                              next((i for i, a in enumerate(spec) if a == MODEL), None),
                              next((i for i, a in enumerate(mspec)
                                    if a is not None and a == data_entry), None))
    return out


def _flat(specs, shapes, moments, prefix: str = ""):
    for k in sorted(shapes):
        if isinstance(shapes[k], dict):
            yield from _flat(specs[k], shapes[k], moments[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", shapes[k], specs[k], moments[k]
