"""AdamW with float32 moments and global-norm clipping.

Copy of ``repro/optim/adamw.py`` on dicts of tensors. The leaves are
taken in sorted-key order, the order ``jax.tree.flatten`` gives a dict,
so the global norm sums them in the same order. Moments are float32
whatever the parameter's type; the update runs in float32 and is cast
back, so bf16 parameters stay bf16. Functions, not an optimizer object:
each returns new tensors and leaves its arguments as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm_clip"]

Tree = Dict[str, torch.Tensor]


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

