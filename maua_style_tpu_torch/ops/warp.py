"""Bilinear grid sampling for flow warping (JAX counterpart:
maua_style_tpu/ops/warp.py).

``grid_sample`` is ``F.grid_sample(mode="bilinear", padding_mode="border",
align_corners=False)``: the grid is (B, Hg, Wg, 2) with (x, y) in [-1, 1],
and "border" clamps the sample coordinate into the image, which gives the
same values as the JAX package's clamping of the four taps.  Flow warps
never need a gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x: (B, C, H, W), grid: (B, Hg, Wg, 2) -> (B, C, Hg, Wg)."""
    if grid.shape[0] != x.shape[0]:
        grid = grid.expand(x.shape[0], *grid.shape[1:])
    out = F.grid_sample(x.float(), grid.float(), mode="bilinear", padding_mode="border", align_corners=False)
    return out.to(x.dtype)


def identity_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(1, h, w, 2) meshgrid of ``linspace(-1, 1)`` in x and y (reference
    load.py:191-214; the JAX package's ``flow_to_grid`` neutral grid)."""
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)[None]


def flow_to_grid(flow_normalised: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Sampling grid from flow already normalised by (W, H): the identity
    grid plus the flow."""
    return identity_grid(h, w, flow_normalised.device) + flow_normalised


__all__ = ["grid_sample", "identity_grid", "flow_to_grid"]
