"""SPyNet (Ranjan & Black 2017; JAX counterpart:
maua_style_tpu/models/flownets/spynet.py).

Coarse-to-fine residual pyramid of 6 levels: each level's module G_k, five
7x7 convs (8 -> 32 -> 64 -> 32 -> 16 -> 2), refines the upsampled flow from
[img1, warp(img2, flow), flow].  Inputs are ImageNet-normalised RGB in
[0, 1], with H and W multiples of 32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize_bilinear
from .common import backward_warp, init_layout, layout_modules, upsample_flow2x

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)

N_LEVELS = 6


def layout() -> list[tuple[str, int, int, int]]:
    out = []
    for level in range(N_LEVELS):
        for i, (cin, cout) in enumerate([(8, 32), (32, 64), (64, 32), (32, 16), (16, 2)], 1):
            out.append((f"level{level}/conv{i}", cin, cout, 7))
    return out


class SPyNet(nn.Module):
    name = "spynet"

    def __init__(self, seed: int = 0):
        super().__init__()
        self.convs = layout_modules(layout())
        init_layout(self.convs, layout(), seed)

    def _g_module(self, level: int, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = F.relu(self.convs[f"level{level}_conv{i}"](x))
        return self.convs[f"level{level}_conv5"](x)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) RGB in [0, 1] x2 -> (B, 2, H, W) flow in pixels."""
        mean = torch.tensor(_MEAN, device=im1.device).view(1, 3, 1, 1)
        std = torch.tensor(_STD, device=im1.device).view(1, 3, 1, 1)
        pyr1, pyr2 = [(im1 - mean) / std], [(im2 - mean) / std]
        for _ in range(N_LEVELS - 1):
            h, w = pyr1[-1].shape[2] // 2, pyr1[-1].shape[3] // 2
            pyr1.append(resize_bilinear(pyr1[-1], size=(h, w)))
            pyr2.append(resize_bilinear(pyr2[-1], size=(h, w)))

        b = im1.shape[0]
        flow = im1.new_zeros((b, 2, *pyr1[-1].shape[2:]))
        for level in range(N_LEVELS):
            i1 = pyr1[N_LEVELS - 1 - level]
            i2 = pyr2[N_LEVELS - 1 - level]
            if level > 0:
                flow = upsample_flow2x(flow, size=tuple(i1.shape[2:]))
            inp = torch.cat([i1, backward_warp(i2, flow), flow], 1)
            flow = flow + self._g_module(level, inp)
        return flow


__all__ = ["SPyNet", "N_LEVELS", "layout"]
