"""The collectives of the device steps, over partitions on one card or
spread over processes.

The JAX steps run one NP partition per device under ``shard_map`` and
meet at ``lax.all_gather`` / ``lax.psum`` / ``lax.axis_index``. Here each
step loops over the partitions it holds and splits at every collective,
and a mesh gives the collectives over the per-partition values of such a
loop:

- :class:`LocalMesh` — all ``m`` partitions in one process, a leading
  axis on one device; its collectives are concatenations and sums.
- :class:`ProcessMesh` — ``m`` partitions over the ranks of a
  ``torch.distributed`` process group, ``m / world`` a rank (NCCL for a
  CUDA device, gloo for the CPU); each collective first reduces the
  rank's own partitions, then meets the other ranks in one call.

Both expose ``size`` (``m``), ``indices()`` (the global partition ids this
process holds, in the order of its loops), ``local``, ``rank`` and
``world``; the values of a collective are given in ``indices()`` order.

The LM training mesh is a grid of named axes (``jax.make_mesh``'s), one
rank a device:

- :class:`GridShape` — the shape and axis names alone, with the rank
  layout (row-major, last axis fastest, as ``jax.make_mesh`` lays out CPU
  devices) and the slice of an array a rank holds under a spec; no process
  group (the sharding helpers and the tests read it).
- :class:`GridMesh` — a :class:`GridShape` over the ranks of the default
  process group, with one subgroup for each line along each axis (and
  along the data axes together): ``axis(name)`` gives a view with
  :class:`ProcessMesh`'s interface on that axis (one partition a rank), so
  the exchanges of :mod:`repro_torch.dist.collectives` run on it
  unchanged, and ``all_reduce`` / ``reduce_scatter`` / ``all_gather`` /
  the tiled ``all_to_all`` run along one axis or several.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from .sharding import data_axes

__all__ = ["LocalMesh", "ProcessMesh", "GridShape", "GridMesh"]

_BACKEND_OF_DEVICE = {"cuda": "nccl", "cpu": "gloo"}


class LocalMesh:
    """``m`` partitions on one device: collectives over per-partition lists."""

    rank = 0
    world = 1

    def __init__(self, m: int):
        if m < 1:
            raise ValueError(f"a mesh needs at least one partition, got {m}")
        self.m = int(m)

    @property
    def size(self) -> int:
        return self.m

    @property
    def local(self) -> int:
        return self.m

    def indices(self) -> range:
        """The partition index of each loop iteration (``lax.axis_index``)."""
        return range(self.m)

    def all_gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """``lax.all_gather`` + flatten: the partitions' values concatenated
        along the leading axis, partition 0 first."""
        self._check(xs)
        return torch.cat(list(xs), dim=0)

    def all_gather_ragged(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """:meth:`all_gather` of values whose leading lengths differ."""
        return self.all_gather(xs)

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """``lax.psum``: the elementwise sum of the partitions' values, in
        their own dtype (int32 sums wrap as on the JAX mesh)."""
        self._check(xs)
        return torch.stack(list(xs)).sum(dim=0, dtype=xs[0].dtype)

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``lax.all_to_all(x, 0, 0, tiled=False)``: partition ``i`` sends row
        ``j`` of its ``[m, ...]`` value to partition ``j``, which receives it
        as its row ``i``."""
        self._check(xs)
        return [torch.stack([x[j] for x in xs]) for j in range(self.m)]

    def ppermute(self, xs: Sequence[torch.Tensor],
                 perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """``lax.ppermute``: partition ``d`` receives the value of ``s`` for
        every ``(s, d)`` of ``perm``; one that receives nothing gets zeros."""
        self._check(xs)
        out = [torch.zeros_like(x) for x in xs]
        for s, d in perm:
            out[d] = xs[s].clone()
        return out

    def _check(self, xs: Sequence[torch.Tensor]) -> None:
        if len(xs) != self.m:
            raise ValueError(f"collective over {len(xs)} values on a mesh of {self.m}")


class ProcessMesh:
    """``m`` partitions over the ranks of the default process group.

    Rank ``r`` holds partitions ``[r·k, (r+1)·k)`` with ``k = m / world``
    (``world = m`` is JAX's layout, one partition a device). A collective
    takes the rank's ``k`` values, reduces them locally (a concatenation
    or a sum), then meets the other ranks in one ``torch.distributed``
    call: ``all_gather_into_tensor`` or ``all_reduce`` in the values' own
    dtype (int32 sums wrap, as on the JAX mesh). The process group's
    backend must be NCCL for a CUDA device and gloo for the CPU; any other
    pairing raises. Every call is counted by kind in ``calls``, and the
    bytes it lands on this rank (an all-gather's output, an all-reduce's
    operand, an exchange's received values) in ``bytes``.
    """

    def __init__(self, m: int, device):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialised torch.distributed group "
                               "(repro_torch.launch.mesh.init_process_mesh)")
        self.device = torch.device(device)
        want = _BACKEND_OF_DEVICE.get(self.device.type)
        have = dist.get_backend()
        if want is None or have != want:
            raise ValueError(f"a {self.device.type} mesh runs on {want or 'no backend'}, "
                             f"and the process group runs on {have}")
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.m = int(m)
        if self.m < 1 or self.m % self.world:
            raise ValueError(f"{self.world} ranks cannot hold {m} partitions evenly")
        self.local = self.m // self.world
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()

    @property
    def size(self) -> int:
        return self.m

    def indices(self) -> range:
        """The global ids of this rank's partitions (``lax.axis_index``)."""
        return range(self.rank * self.local, (self.rank + 1) * self.local)

    def reset_counts(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def all_gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every partition's value concatenated along the leading axis,
        partition 0 first: the rank's own values, then the ranks in order.
        The values have one shape on every rank."""
        self._check(xs)
        return self._gather_ranks(torch.cat(list(xs), dim=0))

    def all_gather_ragged(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """:meth:`all_gather` of values whose leading lengths differ: the
        ranks' lengths are gathered first, every rank's rows padded to the
        longest, gathered, and the padding dropped."""
        self._check(xs)
        x = torch.cat(list(xs), dim=0)
        lens = self._gather_ranks(torch.tensor([x.shape[0]], dtype=torch.int64,
                                               device=x.device)).tolist()
        top = max(lens)
        pad = x.new_zeros((top - x.shape[0],) + tuple(x.shape[1:]))
        rows = self._gather_ranks(torch.cat([x, pad])).reshape((self.world, top)
                                                               + tuple(x.shape[1:]))
        return torch.cat([rows[r, :lens[r]] for r in range(self.world)], dim=0)

    def _gather_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """One value a rank, concatenated in rank order."""
        out = _gather(x, self.world, None)
        self._count("all_gather", out)
        return out

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The elementwise sum over every partition, in the values' dtype."""
        import torch.distributed as dist

        self._check(xs)
        total = torch.stack(list(xs)).sum(dim=0, dtype=xs[0].dtype).contiguous()
        dist.all_reduce(total)
        self._count("all_reduce", total)
        return total

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``lax.all_to_all(x, 0, 0, tiled=False)`` with one partition a rank
        (``all_to_all_single``)."""
        self._one_a_rank("all_to_all")
        self._check(xs)
        x = xs[0].contiguous()
        if x.shape[0] != self.m:
            raise ValueError(f"all_to_all of {x.shape[0]} rows on a mesh of {self.m}")
        out = _all_to_all(x, None)
        self._count("all_to_all", out)
        return [out]

    def ppermute(self, xs: Sequence[torch.Tensor],
                 perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """``lax.ppermute`` with one partition a rank: point-to-point sends
        and receives in one ``batch_isend_irecv``."""
        import torch.distributed as dist

        self._one_a_rank("ppermute")
        self._check(xs)
        x = xs[0].contiguous()
        out = torch.zeros_like(x)
        ops = []
        for s, d in perm:
            if s == d == self.rank:
                out = x.clone()
            elif s == self.rank:
                ops.append(dist.P2POp(dist.isend, x, d))
            elif d == self.rank:
                ops.append(dist.P2POp(dist.irecv, out, s))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self._count("ppermute", out)
        return [out]

    def _one_a_rank(self, what: str) -> None:
        if self.local != 1:
            raise ValueError(f"{what} runs with one partition a rank, not {self.local}")

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size()

    def _check(self, xs: Sequence[torch.Tensor]) -> None:
        if len(xs) != self.local:
            raise ValueError(f"collective over {len(xs)} values on a rank holding "
                             f"{self.local} partitions")


def _all_gather_into_tensor(dist):
    """``all_gather_single`` where this PyTorch has it (newer releases
    deprecate the old name), else ``all_gather_into_tensor``."""
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _reduce_scatter_tensor(dist):
    """``reduce_scatter_single`` where this PyTorch has it, else
    ``reduce_scatter_tensor``."""
    return getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _wire(x: torch.Tensor) -> torch.Tensor:
    """What crosses the transport: bool as uint8 (NCCL has no bool)."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _gather(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """The ``n`` members' ``x`` concatenated along the leading axis, in
    group rank order."""
    import torch.distributed as dist

    wire = _wire(x)
    out = torch.empty((n * wire.shape[0],) + tuple(wire.shape[1:]), dtype=wire.dtype,
                      device=wire.device)
    _all_gather_into_tensor(dist)(out, wire, group=group)
    return out.view(torch.bool) if x.dtype == torch.bool else out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Member ``i`` sends row ``j`` of ``x`` to member ``j``, which receives
    it as its row ``i`` (``all_to_all_single``)."""
    import torch.distributed as dist

    wire = _wire(x)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    return out.view(torch.bool) if x.dtype == torch.bool else out


Axes = Union[str, Tuple[str, ...]]


class GridShape:
    """A grid of ``prod(sizes)`` ranks with named axes: ``shape`` maps each
    name to its size, as ``jax.sharding.Mesh.shape`` does. Rank ``r`` sits
    at ``unravel(r)``, row-major with the last axis fastest (``(r // model,
    r % model)`` on a ``(data, model)`` grid), as ``jax.make_mesh`` lays
    out CPU devices.

    A spec is a tuple with one entry a dimension (a tuple shorter than the
    array's rank leaves the rest whole): ``None``, an axis name, or a tuple
    of axis names, which split that dimension over their product, the
    first name the slowest (``PartitionSpec``'s meaning)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str]):
        if len(sizes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"a grid needs one distinct name an axis: {sizes} {axis_names}")
        if any(int(n) < 1 for n in sizes):
            raise ValueError(f"grid axes must have at least one rank: {sizes}")
        self.sizes = tuple(int(n) for n in sizes)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.sizes))

    @property
    def world(self) -> int:
        return math.prod(self.sizes)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The batch-parallel axes (:func:`~repro_torch.sharding.data_axes`)."""
        return data_axes(self.axis_names)

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate along each axis."""
        out, r = {}, int(rank)
        for name, n in reversed(tuple(zip(self.axis_names, self.sizes))):
            out[name] = r % n
            r //= n
        return {name: out[name] for name in self.axis_names}

    def size(self, axes: Optional[Axes]) -> int:
        """Ranks along ``axes`` (1 for ``None`` or ``()``)."""
        return math.prod(self.shape[a] for a in _names(axes))

    def index(self, axes: Optional[Axes], rank: int) -> int:
        """Rank ``rank``'s position along ``axes`` together, the first name
        the slowest."""
        c = self.coords(rank)
        i = 0
        for a in _names(axes):
            i = i * self.shape[a] + c[a]
        return i

    def lines(self, axes: Axes) -> List[List[int]]:
        """The ranks of each line along ``axes`` (the ranks that differ only
        in their coordinates on ``axes``), each in ``index(axes)`` order; the
        lines in the order of their first rank."""
        names = _names(axes)
        out: Dict[Tuple, List[int]] = {}
        for r in range(self.world):
            c = self.coords(r)
            key = tuple(c[a] for a in self.axis_names if a not in names)
            out.setdefault(key, []).append(r)
        return [sorted(v, key=lambda r: self.index(names, r)) for v in out.values()]

    def slices(self, spec: Sequence, shape: Sequence[int], rank: int) -> Tuple[slice, ...]:
        """The part of an array of ``shape`` that rank ``rank`` holds under
        ``spec``: one slice a dimension. A split dimension must divide."""
        out = []
        for i, n in enumerate(shape):
            ax = spec[i] if i < len(spec) else None
            k = self.size(ax)
            if n % k:
                raise ValueError(f"dimension {i} of {tuple(shape)} does not split "
                                 f"over {ax} ({k} ranks)")
            j = self.index(ax, rank)
            out.append(slice(j * (n // k), (j + 1) * (n // k)))
        return tuple(out)


def _names(axes: Optional[Axes]) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class GridMesh(GridShape):
    """A :class:`GridShape` over the ranks of the default process group,
    one rank a device (NCCL for a CUDA device, gloo for the CPU).

    Every rank creates one ``torch.distributed`` subgroup for each line
    along each axis and, where there are several data axes, along the data
    axes together, all in the same order (``new_group`` is collective), and
    keeps its own. The collectives along ``axes`` run on that subgroup (on
    the default group where ``axes`` is every axis): ``all_reduce``,
    ``reduce_scatter`` and ``all_gather`` along a dimension, and through
    :meth:`axis` the interface of :class:`ProcessMesh`. Every call is
    counted in ``calls`` and the bytes it lands on this rank in ``bytes``,
    keyed ``"<kind>/<axes>"`` (``"all_reduce/model"``,
    ``"reduce_scatter/data"``, ``"all_to_all/model"``)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str], device):
        import torch.distributed as dist

        super().__init__(sizes, axis_names)
        if not dist.is_initialized():
            raise RuntimeError("GridMesh needs an initialised torch.distributed group "
                               "(repro_torch.launch.mesh.init_grid_mesh)")
        self.device = torch.device(device)
        want = _BACKEND_OF_DEVICE.get(self.device.type)
        have = dist.get_backend()
        if want is None or have != want:
            raise ValueError(f"a {self.device.type} mesh runs on {want or 'no backend'}, "
                             f"and the process group runs on {have}")
        self.rank = dist.get_rank()
        if dist.get_world_size() != self.world:
            raise ValueError(f"a {self.sizes} grid needs {self.world} ranks, the process "
                             f"group has {dist.get_world_size()}")
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()
        self._groups = {}
        keys = [(a,) for a in self.axis_names]
        if len(self.data_axes) > 1:
            keys.append(self.data_axes)
        for key in keys:
            for line in self.lines(key):
                group = dist.new_group(line)
                if self.rank in line:
                    self._groups[key] = group

    def group(self, axes: Axes):
        """The subgroup of this rank's line along ``axes`` (``None``, the
        default group, for every axis)."""
        names = _names(axes)
        if set(names) == set(self.axis_names):
            return None
        return self._groups[names]

    def coord(self, axes: Optional[Axes]) -> int:
        """This rank's position along ``axes``."""
        return self.index(axes, self.rank)

    def axis(self, axes: Axes) -> "AxisView":
        """The line along ``axes`` as a :class:`ProcessMesh` of one partition
        a rank."""
        return AxisView(self, _names(axes))

    def reset_counts(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def count(self, kind: str, axes, t: torch.Tensor) -> None:
        key = f"{kind}/{','.join(_names(axes))}"
        self.calls[key] += 1
        self.bytes[key] += t.numel() * t.element_size()

    def all_reduce(self, x: torch.Tensor, axes: Axes, op: str = "sum") -> torch.Tensor:
        """``x`` reduced (``"sum"`` or ``"max"``) over the line along
        ``axes``, in place; returns ``x``."""
        import torch.distributed as dist

        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(x, op=red, group=self.group(axes))
        self.count("all_reduce", axes, x)
        return x

    def reduce_scatter(self, x: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
        """The sum over the line along ``axes`` of ``x``, of which this rank
        receives its part of dimension ``dim`` (``size(axes)`` equal parts,
        in ``coord(axes)`` order)."""
        import torch.distributed as dist

        n = self.size(axes)
        src = x.movedim(dim, 0).contiguous()
        if src.shape[0] % n:
            raise ValueError(f"reduce_scatter: dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {n} ranks")
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        _reduce_scatter_tensor(dist)(out, src, group=self.group(axes))
        self.count("reduce_scatter", axes, out)
        return out.movedim(0, dim)

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
        """The parts ``x`` of the line along ``axes`` concatenated along
        dimension ``dim`` in ``coord(axes)`` order."""
        out = _gather(x.movedim(dim, 0), self.size(axes), self.group(axes))
        self.count("all_gather", axes, out)
        return out.movedim(0, dim)

    def all_to_all(self, x: torch.Tensor, axes: Axes, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``lax.all_to_all(x, axes, split_dim, concat_dim, tiled=True)``:
        ``x`` cut into ``size(axes)`` equal parts along ``split_dim``, part
        ``j`` sent to the rank at ``coord(axes) = j``; the parts received
        concatenated along ``concat_dim`` in ``coord(axes)`` order. Its
        transpose is the same call with the two dimensions swapped."""
        n = self.size(axes)
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dimension {split_dim} of {tuple(x.shape)} does not "
                             f"split over {n} ranks")
        out = _all_to_all(torch.stack(x.chunk(n, split_dim)), self.group(axes))
        self.count("all_to_all", axes, out)
        return torch.cat(out.unbind(0), concat_dim)


class AxisView:
    """The line along some axes of a :class:`GridMesh`, with the interface
    of a :class:`ProcessMesh` holding one partition a rank (``size``,
    ``rank``, ``indices()``, ``all_gather``, ``psum``, ``all_to_all``):
    :func:`repro_torch.dist.collectives.routed_exchange` and the rest run on
    it. Its calls count into the grid's counters under these axes."""

    def __init__(self, grid: GridMesh, axes: Tuple[str, ...]):
        self.grid, self.axes = grid, axes
        self.m = grid.size(axes)
        self.rank = grid.coord(axes)

    @property
    def size(self) -> int:
        return self.m

    def indices(self) -> range:
        return range(self.rank, self.rank + 1)

    def all_gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        self._check(xs)
        out = _gather(xs[0], self.m, self.grid.group(self.axes))
        self.grid.count("all_gather", self.axes, out)
        return out

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        self._check(xs)
        return self.grid.all_reduce(xs[0].clone().contiguous(), self.axes)

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        self._check(xs)
        if xs[0].shape[0] != self.m:
            raise ValueError(f"all_to_all of {xs[0].shape[0]} rows on an axis of {self.m}")
        out = _all_to_all(xs[0], self.grid.group(self.axes))
        self.grid.count("all_to_all", self.axes, out)
        return [out]

    def _check(self, xs: Sequence[torch.Tensor]) -> None:
        if len(xs) != 1:
            raise ValueError(f"collective over {len(xs)} values on an axis view (one a rank)")
