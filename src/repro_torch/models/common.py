"""Shared model substrate: RMS norm, rotary embedding, SwiGLU, the LM loss,
and the tensor-parallel operators of training on a grid mesh.

Twin of ``repro/models/common.py`` (``rms_norm``, ``rope``,
``apply_rope``, ``swiglu``, ``cross_entropy``; ``data_axes`` is in
:mod:`repro_torch.sharding`). JAX's ``shard`` (a sharding constraint) has
no twin: the port places each tensor itself. On a
:class:`~repro_torch.mesh.GridMesh` the layers are tensor parallel over
``"model"`` (Megatron's scheme), through three operators written by hand
as ``torch.autograd.Function`` classes:

- :func:`copy_to_model` (*f*): identity forward, the gradient summed over
  ``model`` backward; on the replicated input of a column-parallel product;
- :func:`reduce_from_model` (*g*): the partial results summed over
  ``model`` forward, identity backward; on the output of a row-parallel
  product. Both sums run in float32 and are rounded once to the tensor's
  type (where GSPMD sums a bf16 partial product in its own type);
- :func:`gather_from_model`: the shards of a weight (or of an output) split
  on a dimension that is not a head, gathered whole forward; backward this
  rank's slice of the gradient, which the replicated computation that reads
  the whole tensor gives every rank in full.

``torch.distributed.nn.functional.all_reduce`` is not *g*: its backward
sums again, which counts the gradient ``model`` times.
:func:`vocab_parallel_cross_entropy` is the loss over a vocabulary-split
head.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..sharding import MODEL

__all__ = ["rms_norm", "rope", "apply_rope", "swiglu", "cross_entropy",
           "copy_to_model", "reduce_from_model", "gather_from_model", "scale_grad",
           "vocab_parallel_cross_entropy"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / sqrt(mean(x²) + eps) · scale`` in float32, cast back to x's type."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(positions: torch.Tensor, dim: int,
         theta: float = 1e4) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 cos/sin tables of rotary embedding; positions ``[..., L]``
    give ``[..., L, dim / 2]``."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device),
                            exps)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved (even, odd) pairs of ``x [..., L, D]`` (the
    JAX package's layout, not the half-split one); computed in float32
    with the tables, returned in x's type."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    while cos.dim() < x1.dim():
        cos, sin = cos[None], sin[None]
    out1 = x1 * cos - x2 * sin
    out2 = x1 * sin + x2 * cos
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """``(silu(x W_g) ⊙ x W_u) W_d`` with weights in the ``[in, out]`` layout."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# Logits cells (rows x V) a block of cross_entropy converts to float32 at
# once: bounds its float32 transients at 256 MiB each whatever the batch.
_CE_CELLS = 1 << 26


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in float32: logits ``[..., V]``, labels ``[...]``
    integer. The logits are taken to float32 a block of rows at a time,
    forward and backward (:class:`_MeanNLL`): a [8,192, 200,064] bf16 head
    keeps its own 3.3 GB and never a float32 copy or gradient (6.6 GB
    each). Each row's log-sum-exp, label logit and gradient are those of
    the whole-tensor formula."""
    v = logits.shape[-1]
    return _MeanNLL.apply(logits.reshape(-1, v), labels.reshape(-1).long())


class _MeanNLL(torch.autograd.Function):
    """``mean(logsumexp(x) - x[label])`` over rows of ``x [N, V]``; the
    gradient ``g / N · (exp(x - lse) - onehot(label))``, the products in
    float32 and rounded once to x's type, as autograd of the float32
    formula gives it."""

    @staticmethod
    def forward(ctx, x, labels):
        n, v = x.shape
        step = max(1, _CE_CELLS // max(1, v))
        lse = torch.empty(n, dtype=torch.float32, device=x.device)
        ll = torch.empty_like(lse)
        for s in range(0, n, step):
            xf = x[s:s + step].float()
            lse[s:s + step] = torch.logsumexp(xf, dim=-1)
            ll[s:s + step] = xf.gather(-1, labels[s:s + step, None])[:, 0]
        ctx.save_for_backward(x, labels, lse)
        return torch.mean(lse - ll)

    @staticmethod
    def backward(ctx, grad):
        x, labels, lse = ctx.saved_tensors
        n, v = x.shape
        g = grad / n
        out = torch.empty_like(x)
        step = max(1, _CE_CELLS // max(1, v))
        for s in range(0, n, step):
            p = g * torch.exp(x[s:s + step].float() - lse[s:s + step, None])
            p.scatter_add_(-1, labels[s:s + step, None], (-g).expand(p.shape[0], 1))
            out[s:s + step] = p
        return out, None


def _sum_f32(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over ``model`` in float32, rounded once to its type."""
    y = x.to(torch.float32, copy=True).contiguous()
    return mesh.all_reduce(y, MODEL).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum_f32(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return mesh.all_gather(x.contiguous(), MODEL, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        i = ctx.mesh.coord(MODEL)
        return grad.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """*f*: ``x`` as it is; its gradient summed over ``model``."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """*g*: ``x`` summed over ``model``; its gradient as it is."""
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The ``model`` ranks' ``x`` concatenated along ``dim``; the gradient
    of this rank's slice is its slice of the whole one's."""
    return _GatherFromModel.apply(x, mesh, dim)


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x`` as it is; its gradient times ``scale``."""
    return _ScaleGrad.apply(x, scale)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_start: int,
                                 mesh) -> torch.Tensor:
    """:func:`cross_entropy` of a head split by vocabulary over ``model``:
    ``logits [..., V / model]`` are this rank's columns ``vocab_start …``.
    Each row's maximum, sum of exponentials and label logit are reduced
    over ``model`` (a max, then one sum of both), the log-sum-exp ``max +
    log Σ exp(x - max)``; no rank holds the whole logits. Float32 in blocks
    of rows as :class:`_MeanNLL`; the gradient needs no collective."""
    v = logits.shape[-1]
    return _VocabParallelNLL.apply(logits.reshape(-1, v), labels.reshape(-1).long(),
                                   vocab_start, mesh)


class _VocabParallelNLL(torch.autograd.Function):
    """``mean(lse - x[label])`` over the rows of this rank's columns ``x [N,
    V_local]`` of a vocabulary-split head; the gradient ``g / N · (exp(x -
    lse) - onehot(label))`` on the local columns, in float32 and rounded
    once to x's type."""

    @staticmethod
    def forward(ctx, x, labels, start, mesh):
        n, v = x.shape
        step = max(1, _CE_CELLS // max(1, v))
        top = x.amax(dim=-1).float().contiguous()
        mesh.all_reduce(top, MODEL, "max")
        sums = torch.empty((2, n), dtype=torch.float32, device=x.device)
        for s in range(0, n, step):
            sums[0, s:s + step] = torch.exp(x[s:s + step].float() - top[s:s + step, None]).sum(-1)
        local = labels - start
        hit = (local >= 0) & (local < v)
        local = local.clamp(0, v - 1)
        sums[1] = torch.where(hit, x.gather(-1, local[:, None])[:, 0].float(), 0.0)
        mesh.all_reduce(sums, MODEL)
        lse = top + torch.log(sums[0])
        ctx.save_for_backward(x, local, hit, lse)
        return torch.mean(lse - sums[1])

    @staticmethod
    def backward(ctx, grad):
        x, local, hit, lse = ctx.saved_tensors
        n, v = x.shape
        g = grad / n
        out = torch.empty_like(x)
        step = max(1, _CE_CELLS // max(1, v))
        for s in range(0, n, step):
            p = g * torch.exp(x[s:s + step].float() - lse[s:s + step, None])
            p.scatter_add_(-1, local[s:s + step, None], -(g * hit[s:s + step, None]))
            out[s:s + step] = p
        return out, None, None, None
