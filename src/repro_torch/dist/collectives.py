"""Collectives for sparse / ragged exchange: twins of
``repro/dist/collectives.py`` on a mesh of the port.

The DDSL shuffle moves *rows* (matches, routed tokens) to data-dependent
destinations, which the dense collectives do not express directly. Each
function takes one value a partition of the mesh, in ``mesh.indices()``
order (a list of one on a :class:`~repro_torch.mesh.ProcessMesh` with
one partition a rank, where the transport is ``all_to_all_single`` and
``batch_isend_irecv``; all ``m`` on a :class:`~repro_torch.mesh.LocalMesh`),
and returns one result a partition:

- :func:`bucketed_all_to_all` — each partition packs its valid rows into
  per-destination buckets of static capacity and exchanges them with one
  all-to-all. Rows beyond a bucket's capacity are dropped *and counted*
  (never silently; the count is summed over the mesh).
- :func:`routed_exchange` — bucketed all-to-all plus an inverse: the
  returned ``restore`` routes processed rows back to their origin
  partition *and original slot* (the MoE dispatch / combine pattern).
- :func:`ring_all_reduce` — a ring implementation of the sum over the
  mesh built on point-to-point hops (its summation order is JAX's, so
  its float results agree with the mesh's sum only to tolerance).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

__all__ = ["bucketed_all_to_all", "routed_exchange", "ring_all_reduce"]

_I32 = torch.int32


def _bucketize(targets: torch.Tensor, valid: torch.Tensor, n: int, cap: int):
    """Per-destination slot assignment for each local row.

    Returns ``(dest, slot, ok, dropped)``: row i goes to bucket
    ``dest[i]`` slot ``slot[i]`` when ``ok[i]``.
    """
    r = targets.shape[0]
    dest = torch.where(valid, targets.to(_I32), n)
    order = torch.argsort(dest, stable=True)
    sdest = dest[order]
    start = torch.searchsorted(sdest, torch.arange(n + 1, dtype=_I32, device=dest.device))
    slot_sorted = torch.arange(r, dtype=_I32, device=dest.device) - start[
        sdest.clamp(0, n).long()].to(_I32)
    ok_sorted = (sdest < n) & (slot_sorted < cap)
    # scatter back to the original row order
    inv = torch.argsort(order, stable=True)
    slot = slot_sorted[inv]
    ok = ok_sorted[inv]
    dropped = valid.sum(dtype=_I32) - ok.sum(dtype=_I32)
    return dest, slot, ok, dropped


def _forward_exchange(arrays, targets, valid, mesh, cap: int):
    """Shared dispatch: bucketize every partition's rows and run the wire
    exchange. Returns ``(received, rvalid, overflow, routes)``; ``routes``
    holds each partition's bucket assignment ``(dg, sg, ok)``, which the
    inverse route needs."""
    n = mesh.size
    routes, dropped = [], []
    for t, v in zip(targets, valid):
        dest, slot, ok, d = _bucketize(t, v, n, cap)
        routes.append((torch.where(ok, dest, n).long(), torch.where(ok, slot, 0).long(), ok))
        dropped.append(d)
    received = []
    for k in range(len(arrays[0])):
        bucks = []
        for a, (dg, sg, _) in zip((rows[k] for rows in arrays), routes):
            buck = torch.zeros((n + 1, cap) + tuple(a.shape[1:]), dtype=a.dtype,
                               device=a.device)
            buck[dg, sg] = a
            bucks.append(buck[:n])
        received.append([o.reshape((n * cap,) + tuple(o.shape[2:]))
                         for o in mesh.all_to_all(bucks)])
    bvals = []
    for dg, sg, ok in routes:
        bval = torch.zeros((n + 1, cap), dtype=torch.bool, device=ok.device)
        bval[dg, sg] = ok
        bvals.append(bval[:n])
    rvalid = [o.reshape(n * cap) for o in mesh.all_to_all(bvals)]
    overflow = mesh.psum(dropped)
    # received[k][p] -> per partition, the list of its received arrays
    received = [[rec[p] for rec in received] for p in range(len(routes))]
    return received, rvalid, overflow, routes


def bucketed_all_to_all(arrays: Sequence[Sequence[torch.Tensor]],
                        targets: Sequence[torch.Tensor], valid: Sequence[torch.Tensor],
                        mesh, capacity: int):
    """Exchange rows to per-row target partitions.

    ``arrays[p]``: partition ``p``'s aligned per-row arrays ``[R, ...]``;
    ``targets[p]`` / ``valid[p]``: ``[R]``. Returns ``(received, rvalid,
    overflow)``: per partition its received arrays ``[n·capacity, ...]``
    (bucket of sender ``s`` at rows ``[s·capacity, (s+1)·capacity)``) and
    their valid mask, and the dropped rows summed over the mesh.
    """
    received, rvalid, overflow, _ = _forward_exchange(arrays, targets, valid, mesh, capacity)
    return received, rvalid, overflow


def routed_exchange(arrays: Sequence[Sequence[torch.Tensor]],
                    targets: Sequence[torch.Tensor], valid: Sequence[torch.Tensor],
                    mesh, capacity: int
                    ) -> Tuple[List[List[torch.Tensor]], List[torch.Tensor], Callable,
                               torch.Tensor]:
    """Bucketed all-to-all with an inverse route (dispatch / combine).

    Returns ``(received, rvalid, restore, overflow)``. ``restore(processed)``
    takes per partition rows aligned with its received layout ``[n·capacity,
    ...]`` and returns per partition the rows it sent, processed, in their
    original ``[R, ...]`` order (dropped rows come back as zeros).
    """
    n, cap = mesh.size, capacity
    received, rvalid, overflow, routes = _forward_exchange(arrays, targets, valid, mesh, cap)

    def restore(processed: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Send processed rows back and scatter them into their slots."""
        zs = mesh.all_to_all([y.reshape((n, cap) + tuple(y.shape[1:])) for y in processed])
        out = []
        # z[d, c] is the processed version of the row this partition put
        # in bucket (d, c) on the way out
        for z, (dg, sg, ok), t in zip(zs, routes, targets):
            r = t.shape[0]
            rows = torch.where(ok, torch.arange(r, device=ok.device), r)
            back = torch.zeros((r + 1,) + tuple(z.shape[2:]), dtype=z.dtype, device=z.device)
            back[rows] = z[dg.clamp(0, n - 1), sg]
            out.append(back[:r])
        return out

    return received, rvalid, restore, overflow


def ring_all_reduce(xs: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The sum over the mesh by a ring of ``n - 1`` hops: each hop passes
    every partition's last received value to the next partition, which adds
    it (JAX's order: own value, then its predecessors nearest first)."""
    n = mesh.size
    perm = [(i, (i + 1) % n) for i in range(n)]
    acc = list(xs)
    cur = list(xs)
    for _ in range(n - 1):
        cur = mesh.ppermute(cur, perm)
        acc = [a + c for a, c in zip(acc, cur)]
    return acc
