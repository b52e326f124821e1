"""Shared flow-net building blocks (JAX counterpart:
maua_style_tpu/models/flownets/common.py), NCHW."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize_bilinear
from ...ops.warp import grid_sample


def backward_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(p) = x(p + flow(p)), flow in pixels: x (B, C, H, W), flow
    (B, 2, H, W) with (u, v).  The grid is pixel-centred, so zero flow is
    the identity under ``align_corners=False``; border padding."""
    b, _, h, w = flow.shape
    xs = (torch.arange(w, dtype=torch.float32, device=flow.device) + 0.5) * (2.0 / w) - 1.0
    ys = (torch.arange(h, dtype=torch.float32, device=flow.device) + 0.5) * (2.0 / h) - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx + flow[:, 0] * (2.0 / w), gy + flow[:, 1] * (2.0 / h)], -1)
    return grid_sample(x, grid)


def conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    """Conv2d with explicit symmetric padding ((k - 1) * dilation // 2)."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) * dilation // 2, dilation=dilation)


def deconv(cin: int, cout: int) -> nn.ConvTranspose2d:
    """The flow nets' 2x upsampler (kernel 4, stride 2, padding 1): torch's
    own ConvTranspose2d, whose weight is (in, out, k, k)."""
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def upsample_flow2x(flow: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinearly resize a (B, 2, h, w) flow to ``size`` and rescale its
    magnitude by the size ratio."""
    h, w = flow.shape[-2:]
    up = resize_bilinear(flow, size=size)
    return up * torch.tensor([size[1] / w, size[0] / h], dtype=up.dtype, device=up.device).view(1, 2, 1, 1)


def layout_modules(layout) -> nn.ModuleDict:
    """``(name, cin, cout, k)`` entries (kernel 4 = the deconvs) -> one
    ModuleDict keyed by the JAX name with "/" as "_"."""
    mods = {}
    for name, cin, cout, k in layout:
        mods[name.replace("/", "_")] = deconv(cin, cout) if k == 4 else conv(cin, cout, k)
    return nn.ModuleDict(mods)


def init_layout(module: nn.ModuleDict, layout, seed: int) -> None:
    """Seeded He-normal weights and zero biases from one CPU
    ``torch.Generator``, in layout order (the JAX threefry init cannot be
    reproduced; tests feed it in through ``convert.flow_params_from_jax``)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, cin, _cout, k in layout:
            m = module[name.replace("/", "_")]
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * math.sqrt(2.0 / (k * k * cin)))
            m.bias.zero_()


__all__ = ["backward_warp", "conv", "deconv", "leaky_relu", "upsample_flow2x", "layout_modules", "init_layout"]
