"""AdamW with float32 moments and global-norm clipping.

Copy of ``repro/optim/adamw.py`` on dicts of tensors. The leaves are
taken in sorted-key order, the order ``jax.tree.flatten`` gives a dict,
so the global norm sums them in the same order. Moments are float32
whatever the parameter's type; the update runs in float32 and is cast
back, so bf16 parameters stay bf16. Functions, not an optimizer object:
:func:`adamw_update` returns new tensors and leaves its arguments as they
were (the GNN step); :func:`adamw_update_` does the same arithmetic in
place, a block of rows at a time, for the models whose parameters,
gradients and two moments fill most of the card (DLRM's tables, the LMs).

On a grid mesh (:class:`~repro_torch.mesh.GridMesh`) the LM's and the
GNNs' moments are ZeRO-1 (``_lm_cell``'s and ``_gnn_cell``'s
``_zero1_specs``): each leaf's moments hold only this data rank's slice of
its ``data_dim``. :func:`adamw_init_zero1` makes them;
:func:`adamw_update_zero1_` reduce-scatters the gradient over the data axes
into that slice (the LM's averaged over them, a GNN's summed over every
axis), takes the norm of the whole gradient over the mesh, runs
:func:`adamw_update_` on the slices and gathers the new parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "adamw_update_", "global_norm_clip",
           "adamw_init_zero1", "adamw_update_zero1_"]

Tree = Dict[str, torch.Tensor]
# Bytes of float32 a block of rows of :func:`adamw_update_` spans at most
# (read when it is called): its float32 temporaries stay a few times this
# whatever the leaf's size.
BLOCK_BYTES = 1 << 28


@dataclasses.dataclass
class AdamWState:
    """``step``: int32 0-d tensor; ``mu``, ``nu``: float32 moments by
    parameter name."""

    step: torch.Tensor
    mu: Tree
    nu: Tree


def adamw_init(params: Tree) -> AdamWState:
    """Zero moments and step 0, on the parameters' device."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in sorted(params.items())}
    dev = next(iter(zeros.values())).device if zeros else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), mu=zeros,
                      nu={k: z.clone() for k, z in zeros.items()})


@torch.no_grad()
def global_norm_clip(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """The gradients scaled by ``min(1, max_norm / (norm + 1e-9))``, each
    in its own type, and the float32 global norm before scaling."""
    keys = sorted(grads)
    norm = torch.sqrt(sum(torch.sum(torch.square(grads[k].float())) for k in keys))
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return {k: (grads[k].float() * scale).to(grads[k].dtype) for k in keys}, norm


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: AdamWState,
                 lr: Union[float, torch.Tensor], *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 max_norm: float = 1.0) -> Tuple[Tree, AdamWState, torch.Tensor]:
    """One AdamW step on the clipped gradients: ``(params, state, gnorm)``.
    ``lr`` is a float or a 0-d tensor."""
    if sorted(params) != sorted(grads) or sorted(params) != sorted(state.mu):
        raise ValueError("adamw_update: params, grads and moments name different leaves")
    grads, gnorm = global_norm_clip(grads, max_norm)
    step = state.step + 1
    t = step.float()
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    new_p, new_mu, new_nu = {}, {}, {}
    for k in sorted(params):
        p, g32 = params[k], grads[k].float()
        mu = b1 * state.mu[k] + (1 - b1) * g32
        nu = b2 * state.nu[k] + (1 - b2) * g32 * g32
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) + weight_decay * p.float()
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_mu[k], new_nu[k] = mu, nu
    return new_p, AdamWState(step=step, mu=new_mu, nu=new_nu), gnorm



def _sum_squares(g: torch.Tensor) -> torch.Tensor:
    """``torch.sum(torch.square(g.float()))``, squaring in place where
    ``g.float()`` is a copy (a bf16 leaf): the same float32 products and
    the same reduction, one float32 copy of the leaf fewer."""
    x = g.float()
    return torch.sum(x.square_() if x.data_ptr() != g.data_ptr() else torch.square(x))


@torch.no_grad()
def adamw_update_(params: Tree, grads: Tree, state: AdamWState,
                  lr: Union[float, torch.Tensor], *, b1: float = 0.9, b2: float = 0.95,
                  eps: float = 1e-8, weight_decay: float = 0.1, max_norm: float = 1.0,
                  norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`adamw_update` in place: overwrites ``params``, ``state`` (its
    step and moments) and ``grads`` (with the clipped gradients) and
    returns the float32 global norm before clipping. A given ``norm`` (the
    float32 norm of a gradient these leaves are part of) clips in place of
    their own.

    The same float32 arithmetic in the same order, leaf by leaf in sorted-
    key order, so the results are :func:`adamw_update`'s bit for bit. The
    norm sums each leaf whole (a blocked sum would round otherwise); the
    clip and the update, which are elementwise, go a block of rows at a
    time, each block spanning at most :data:`BLOCK_BYTES` of float32, so the
    temporaries stay a few blocks whatever the leaf's size.
    """
    block_bytes = BLOCK_BYTES
    keys = sorted(params)
    if keys != sorted(grads) or keys != sorted(state.mu):
        raise ValueError("adamw_update_: params, grads and moments name different leaves")
    if norm is None:
        norm = torch.sqrt(sum(_sum_squares(grads[k]) for k in keys))
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    state.step.add_(1)
    t = state.step.float()
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    for k in keys:
        p, g, mu, nu = params[k], grads[k], state.mu[k], state.nu[k]
        if p.dim() == 0:
            blocks = [(p, g, mu, nu)]
        else:
            rows = max(1, block_bytes // max(1, 4 * (p.numel() // max(1, p.shape[0]))))
            blocks = [(p[i:i + rows], g[i:i + rows], mu[i:i + rows], nu[i:i + rows])
                      for i in range(0, p.shape[0], rows)]
        for pb, gb, mb, nb in blocks:
            gb.copy_((gb.float() * scale).to(gb.dtype))
            g32 = gb.float()
            m = b1 * mb + (1 - b1) * g32
            v = b2 * nb + (1 - b2) * g32 * g32
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * pb.float()
            pb.copy_((pb.float() - lr * delta).to(pb.dtype))
            mb.copy_(m)
            nb.copy_(v)
    return norm


def adamw_init_zero1(params: Tree, data_dims: Dict[str, Optional[int]], mesh) -> AdamWState:
    """Zero moments of this data rank's ZeRO-1 slice of each leaf (its
    ``data_dims[k]`` cut in ``size(data axes)`` parts; the whole leaf where
    that is ``None``) and step 0, on the parameters' device."""
    n = mesh.size(mesh.data_axes)
    zeros = {}
    for k, p in sorted(params.items()):
        shape = list(p.shape)
        if data_dims[k] is not None:
            shape[data_dims[k]] //= n
        zeros[k] = torch.zeros(shape, dtype=torch.float32, device=p.device)
    dev = next(iter(zeros.values())).device if zeros else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), mu=zeros,
                      nu={k: z.clone() for k, z in zeros.items()})


@torch.no_grad()
def adamw_update_zero1_(params: Tree, grads: Tree, state: AdamWState,
                        lr: Union[float, torch.Tensor], *, mesh,
                        data_dims: Dict[str, Optional[int]], model_split: Dict[str, bool],
                        grad_axes: Optional[Tuple[str, ...]] = None, **hyper) -> torch.Tensor:
    """One AdamW step of a mesh's shards, in place; returns the float32
    global norm of the averaged (or summed) gradient before clipping.

    ``params`` and ``grads`` are this rank's shards (split over ``"model"``
    where ``model_split``), ``state`` its ZeRO-1 moments
    (:func:`adamw_init_zero1`). Leaf by leaf in sorted order, the gradient
    is summed in float32 over the data axes, reduce-scattered into this
    rank's slice of ``data_dims[k]`` (all-reduced whole where that is
    ``None``), divided by their size and cast to the leaf's type: the
    average over the data ranks (the LM's batch split). With ``grad_axes``
    (the data axes among them) the gradient is instead summed over those
    axes and not divided: a GNN's, whose graph is split over every axis,
    so that each rank holds a share of the sum. The norm's sum of squares counts each
    piece of the gradient once: a rank adds its piece where its coordinate
    is 0 on every axis the piece is not split on, and one sum over the mesh
    adds them. Then :func:`adamw_update_` runs on the slices with that norm
    (its arithmetic bit for bit) and the new slices are gathered over the
    data axes. ``grads`` is consumed."""
    daxes = mesh.data_axes
    average = grad_axes is None
    grad_axes = daxes if average else tuple(grad_axes)
    rest = tuple(a for a in grad_axes if a not in daxes)
    n, r = mesh.size(daxes), mesh.coord(daxes)
    coords = mesh.coords(mesh.rank)
    views, pieces = {}, {}
    share = None
    for k in sorted(params):
        g, d, p = grads.pop(k), data_dims[k], params[k]
        acc = g.to(torch.float32, copy=True).contiguous()
        if d is None:
            acc = mesh.all_reduce(acc, grad_axes)
            views[k] = p
        else:
            acc = mesh.reduce_scatter(acc, daxes, d)
            if rest:
                acc = mesh.all_reduce(acc, rest)
            width = p.shape[d] // n
            views[k] = p.narrow(d, r * width, width)
        del g
        pieces[k] = (acc / n if average else acc).to(p.dtype)
        split = ({"model"} if model_split[k] else set()) | (set(daxes) if d is not None else set())
        if all(coords[a] == 0 for a in mesh.axis_names if a not in split):
            sq = _sum_squares(pieces[k])
            share = sq if share is None else share + sq
    total = torch.zeros(1, dtype=torch.float32, device=state.step.device)
    if share is not None:
        total += share
    norm = torch.sqrt(mesh.all_reduce(total, mesh.axis_names)[0])
    adamw_update_(views, pieces, state, lr, norm=norm, **hyper)
    for k in sorted(params):
        if data_dims[k] is not None:
            params[k].copy_(mesh.all_gather(views[k].contiguous(), daxes, data_dims[k]))
    return norm
