"""The collectives of the device steps, over partitions held on one card.

The JAX steps run one NP partition per device under ``shard_map`` and
meet at ``lax.all_gather`` / ``lax.psum`` / ``lax.axis_index``. On one
card the ``m`` partitions are a leading axis instead: each step loops
over them and splits at every collective, and :class:`LocalMesh` gives
the collectives over the per-partition values of such a loop.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["LocalMesh"]


class LocalMesh:
    """``m`` partitions on one device: collectives over per-partition lists."""

    def __init__(self, m: int):
        if m < 1:
            raise ValueError(f"a mesh needs at least one partition, got {m}")
        self.m = int(m)

    @property
    def size(self) -> int:
        return self.m

    def indices(self) -> range:
        """The partition index of each loop iteration (``lax.axis_index``)."""
        return range(self.m)

    def all_gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """``lax.all_gather`` + flatten: the partitions' values concatenated
        along the leading axis, partition 0 first."""
        self._check(xs)
        return torch.cat(list(xs), dim=0)

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """``lax.psum``: the elementwise sum of the partitions' values, in
        their own dtype (int32 sums wrap as on the JAX mesh)."""
        self._check(xs)
        return torch.stack(list(xs)).sum(dim=0, dtype=xs[0].dtype)

    def _check(self, xs: List[torch.Tensor]) -> None:
        if len(xs) != self.m:
            raise ValueError(f"collective over {len(xs)} values on a mesh of {self.m}")
