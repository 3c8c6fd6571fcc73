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

The exchange with grad, for the MoE layers of training on a grid mesh's
``"model"`` axis (one partition a rank): :func:`route_rows` assigns each
row its bucket and slot once (the count of dropped rows summed over the
axis); :func:`send_rows` moves rows along that route and
:func:`return_rows` brings processed rows back to their slots, each a
``torch.autograd.Function`` whose backward is the other (the gradient
rows go back along the same buckets and slots; a dropped row's gradient is
zero).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch

__all__ = ["bucketed_all_to_all", "routed_exchange", "ring_all_reduce", "Route", "route_rows",
           "send_rows", "return_rows"]

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


class Route(NamedTuple):
    """Where each of ``rows`` local rows goes: bucket ``dest`` (``n`` for a
    dropped row), slot ``slot``, kept where ``ok``; ``n`` buckets of
    ``cap`` slots."""

    dest: torch.Tensor
    slot: torch.Tensor
    ok: torch.Tensor
    n: int
    cap: int


def route_rows(targets: torch.Tensor, valid: torch.Tensor, mesh,
               capacity: int) -> Tuple[Route, torch.Tensor]:
    """The route of this rank's rows to their ``targets`` over ``mesh`` (one
    partition a rank), ``capacity`` slots a destination, and the rows
    dropped past it summed over the mesh (``_bucketize`` of
    :func:`routed_exchange`)."""
    n = mesh.size
    dest, slot, ok, dropped = _bucketize(targets, valid, n, capacity)
    route = Route(torch.where(ok, dest, n).long(), torch.where(ok, slot, 0).long(), ok, n,
                  capacity)
    return route, mesh.psum([dropped])


def _send(x: torch.Tensor, route: Route, mesh) -> torch.Tensor:
    """Rows ``x [R, ...]`` into their buckets, exchanged: ``[n·cap, ...]``,
    sender ``s``'s bucket at rows ``[s·cap, (s+1)·cap)``, empty slots zero."""
    buck = x.new_zeros((route.n + 1, route.cap) + tuple(x.shape[1:]))
    buck[route.dest, route.slot] = x
    out = mesh.all_to_all([buck[:route.n]])[0]
    return out.reshape((route.n * route.cap,) + tuple(x.shape[1:]))


def _return(y: torch.Tensor, route: Route, mesh) -> torch.Tensor:
    """Received rows ``y [n·cap, ...]`` sent back and put in their slots:
    ``[R, ...]``, a dropped row zero."""
    z = mesh.all_to_all([y.reshape((route.n, route.cap) + tuple(y.shape[1:]))])[0]
    r = route.ok.shape[0]
    rows = torch.where(route.ok, torch.arange(r, device=y.device), r)
    out = y.new_zeros((r + 1,) + tuple(y.shape[1:]))
    out[rows] = z[route.dest.clamp(0, route.n - 1), route.slot]
    return out[:r]


class _SendRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, route, mesh):
        ctx.route, ctx.mesh = route, mesh
        return _send(x, route, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _return(grad.contiguous(), ctx.route, ctx.mesh), None, None


class _ReturnRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, route, mesh):
        ctx.route, ctx.mesh = route, mesh
        return _return(y, route, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _send(grad.contiguous(), ctx.route, ctx.mesh), None, None


def send_rows(x: torch.Tensor, route: Route, mesh) -> torch.Tensor:
    """``x [R, ...]`` along ``route``: ``[n·cap, ...]`` on each receiver.
    Differentiable in a floating ``x``; its backward returns the gradient
    rows to their slots (:func:`return_rows`)."""
    if x.is_floating_point() and torch.is_grad_enabled() and x.requires_grad:
        return _SendRows.apply(x, route, mesh)
    return _send(x, route, mesh)


def return_rows(y: torch.Tensor, route: Route, mesh) -> torch.Tensor:
    """The received rows ``y [n·cap, ...]`` back to their senders' slots
    ``[R, ...]``, a dropped row zero. Differentiable; its backward sends
    the gradient along ``route`` again (:func:`send_rows`)."""
    if torch.is_grad_enabled() and y.requires_grad:
        return _ReturnRows.apply(y, route, mesh)
    return _return(y, route, mesh)
