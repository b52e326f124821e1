"""Custom-gradient ops of the CLIP + VQGAN path (JAX counterpart:
maua_style_tpu/ops/grads.py; reference clip_vqgan.py:95-136):
straight-through gradient replacement, clamp-with-gradient, spherical
distance."""

from __future__ import annotations

import torch


def _sum_to_shape(g: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """Sum ``g`` over the leading axes it has beyond ``shape`` and over the
    axes that ``shape`` broadcasts (size 1)."""
    extra = g.dim() - len(shape)
    if extra > 0:
        g = g.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, (gs, s) in enumerate(zip(g.shape, shape)) if s == 1 and gs != 1)
    if axes:
        g = g.sum(dim=axes, keepdim=True)
    return g.reshape(shape)


class _ReplaceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_forward, x_backward):
        ctx.shape = x_backward.shape
        return x_forward.clone()

    @staticmethod
    def backward(ctx, g):
        return None, _sum_to_shape(g, ctx.shape)


def replace_grad(x_forward: torch.Tensor, x_backward: torch.Tensor) -> torch.Tensor:
    """Forward ``x_forward``; all of the gradient flows to ``x_backward``,
    summed to its shape: the straight-through estimator (reference
    clip_vqgan.py:95-106)."""
    return _ReplaceGrad.apply(x_forward, x_backward)


class _ClampWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.lo, ctx.hi = lo, hi
        ctx.save_for_backward(x)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        keep = (g * (x - x.clamp(ctx.lo, ctx.hi)) >= 0).to(g.dtype)
        return g * keep, None, None


def clamp_with_grad(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clamp whose backward passes the gradients that point back into the
    valid range, g·(x − clip(x)) ≥ 0 (reference clip_vqgan.py:109-123)."""
    return _ClampWithGrad.apply(x, lo, hi)


def spherical_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared great-circle distance between L2-normalised embeddings
    (reference clip_vqgan.py:133-136)."""
    xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    yn = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    return torch.square(torch.arcsin(torch.linalg.vector_norm(xn - yn, dim=-1) / 2)) * 2


__all__ = ["replace_grad", "clamp_with_grad", "spherical_dist"]
