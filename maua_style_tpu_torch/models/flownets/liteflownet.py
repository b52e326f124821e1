"""LiteFlowNet (Hui et al. 2018; JAX counterpart:
maua_style_tpu/models/flownets/liteflownet.py).

- NetC: a 6-level feature encoder, two leaky-ReLU 3x3 convs a level, the
  first of stride 2 (channels 32, 32, 64, 96, 128, 192);
- NetE: levels 6..2 each run three units on the level's flow:
  - M (matching): the cost volume of f1 against f2 warped by the flow
    (``ops.correlation``, the CUDA kernel K2 on the GPU, d = 3: 49
    channels), three convs to a residual flow;
  - S (sub-pixel): three convs over [f1, warped f2, flow] to a residual;
  - R (regularisation): three convs to 9 per-pixel weights, softmax over
    them, and the weighted blend of the flow's 3x3 neighbourhood
    (edge-replicated);
- the flow is upsampled x2 in size and magnitude between levels, and is
  20 * resize(flow_2, input size) / 4 at the end.

Inputs are RGB in [0, 1] with H and W multiples of 64 (the flow module
resizes to that).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.correlation import correlation
from ...ops.resize import resize_bilinear
from .common import backward_warp, init_layout, layout_modules, leaky_relu

ENC_CH = [3, 32, 32, 64, 96, 128, 192]
LEVELS = [2, 3, 4, 5, 6]  # decoded from coarse 6 to fine 2
FLOW_SCALE = {6: 0.625, 5: 1.25, 4: 2.5, 3: 5.0, 2: 10.0}
MAX_DISP = 3


def layout() -> list[tuple[str, int, int, int]]:
    out = []
    for lvl in range(1, 7):
        cin, cout = ENC_CH[lvl - 1], ENC_CH[lvl]
        out += [(f"enc{lvl}/conv1", cin, cout, 3), (f"enc{lvl}/conv2", cout, cout, 3)]
    for lvl in LEVELS:
        c = ENC_CH[lvl]
        out += [
            (f"m{lvl}/conv1", 49, 96, 3),
            (f"m{lvl}/conv2", 96, 64, 3),
            (f"m{lvl}/flow", 64, 2, 3),
            (f"s{lvl}/conv1", 2 * c + 2, 96, 3),
            (f"s{lvl}/conv2", 96, 64, 3),
            (f"s{lvl}/flow", 64, 2, 3),
            (f"r{lvl}/conv1", c + 2, 64, 3),
            (f"r{lvl}/conv2", 64, 32, 3),
            (f"r{lvl}/weights", 32, 9, 3),
        ]
    return out


class LiteFlowNet(nn.Module):
    name = "liteflownet"

    def __init__(self, seed: int = 0):
        super().__init__()
        self.convs = layout_modules(layout())
        for lvl in range(1, 7):
            self.convs[f"enc{lvl}_conv1"].stride = (2, 2)
        init_layout(self.convs, layout(), seed)

    def _encode(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = [x]
        for lvl in range(1, 7):
            x = leaky_relu(self.convs[f"enc{lvl}_conv1"](x))
            x = leaky_relu(self.convs[f"enc{lvl}_conv2"](x))
            feats.append(x)
        return feats  # index = level

    def _regularize(self, lvl: int, f1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        c = self.convs
        x = leaky_relu(c[f"r{lvl}_conv1"](torch.cat([f1, flow], 1)))
        x = leaky_relu(c[f"r{lvl}_conv2"](x))
        w = torch.softmax(c[f"r{lvl}_weights"](x), dim=1)  # (B, 9, H, W)
        fp = F.pad(flow, (1, 1, 1, 1), mode="replicate")
        h, wd = flow.shape[2:]
        out = 0.0
        for k in range(9):
            dy, dx = divmod(k, 3)
            out = out + w[:, k : k + 1] * fp[:, :, dy : dy + h, dx : dx + wd]
        return out

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) RGB in [0, 1] x2 -> (B, 2, H, W) flow in pixels."""
        f1s, f2s = self._encode(im1), self._encode(im2)
        c = self.convs
        flow = im1.new_zeros((im1.shape[0], 2, *f1s[6].shape[2:]))
        for lvl in reversed(LEVELS):
            f1, f2 = f1s[lvl], f2s[lvl]
            if flow.shape[2] != f1.shape[2]:
                flow = resize_bilinear(flow, size=tuple(f1.shape[2:])) * 2.0
            # M: matching unit
            warped = backward_warp(f2, flow * FLOW_SCALE[lvl])
            m = leaky_relu(correlation(f1, warped, MAX_DISP))
            m = leaky_relu(c[f"m{lvl}_conv1"](m))
            m = leaky_relu(c[f"m{lvl}_conv2"](m))
            flow = flow + c[f"m{lvl}_flow"](m)
            # S: sub-pixel unit
            warped = backward_warp(f2, flow * FLOW_SCALE[lvl])
            s = leaky_relu(c[f"s{lvl}_conv1"](torch.cat([f1, warped, flow], 1)))
            s = leaky_relu(c[f"s{lvl}_conv2"](s))
            flow = flow + c[f"s{lvl}_flow"](s)
            # R: regularisation unit
            flow = self._regularize(lvl, f1, flow)
        return 20.0 * resize_bilinear(flow, size=tuple(im1.shape[2:])) / 4.0


__all__ = ["LiteFlowNet", "layout", "MAX_DISP"]
