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
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple

import torch

__all__ = ["LocalMesh", "ProcessMesh"]

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
        import torch.distributed as dist

        x = x.contiguous()
        wire = x.view(torch.uint8) if x.dtype == torch.bool else x
        out = torch.empty((self.world * wire.shape[0],) + tuple(wire.shape[1:]),
                          dtype=wire.dtype, device=wire.device)
        _all_gather_into_tensor(dist)(out, wire)
        self._count("all_gather", out)
        return out.view(torch.bool) if x.dtype == torch.bool else out

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
        import torch.distributed as dist

        self._one_a_rank("all_to_all")
        self._check(xs)
        x = xs[0].contiguous()
        if x.shape[0] != self.m:
            raise ValueError(f"all_to_all of {x.shape[0]} rows on a mesh of {self.m}")
        wire = x.view(torch.uint8) if x.dtype == torch.bool else x
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire)
        self._count("all_to_all", out)
        return [out.view(torch.bool) if x.dtype == torch.bool else out]

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
