"""PWC-Net (Sun et al. 2018; JAX counterpart:
maua_style_tpu/models/flownets/pwc.py).

- 6-level feature pyramid, 3 leaky-ReLU convs per level (channels 16, 32,
  64, 96, 128, 196);
- decoders at levels 6..2: the cost volume of f1 against the warped f2
  (``ops.correlation``, the CUDA kernel K2 on the GPU, d = 4: 81 channels),
  DenseNet-style convs (128, 128, 96, 64, 32) each concatenated in front of
  its input, a flow head, and deconv up-flow / up-feat; warp scales
  0.625, 1.25, 2.5, 5.0;
- a dilated context network refines the level-2 flow;
- the flow is 20 * resize(flow_2, input size).

Inputs are RGB in [0, 1] with H and W multiples of 64 (the flow module
resizes to that).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.correlation import correlation
from ...ops.resize import resize_bilinear
from .common import backward_warp, init_layout, layout_modules, leaky_relu

PYR_CHANNELS = [3, 16, 32, 64, 96, 128, 196]
DENSE = [128, 128, 96, 64, 32]
WARP_SCALE = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
CTX_DILATIONS = [1, 2, 4, 8, 16, 1, 1]
MAX_DISP = 4


def _decoder_in_channels(level: int) -> int:
    if level == 6:
        return 81
    return 81 + PYR_CHANNELS[level] + 2 + 2  # corr + features + up_flow + up_feat


def layout() -> list[tuple[str, int, int, int]]:
    out = []
    for lvl in range(1, 7):
        cin, cout = PYR_CHANNELS[lvl - 1], PYR_CHANNELS[lvl]
        out += [(f"ext{lvl}/conv1", cin, cout, 3), (f"ext{lvl}/conv2", cout, cout, 3), (f"ext{lvl}/conv3", cout, cout, 3)]
    for lvl in range(6, 1, -1):
        c = _decoder_in_channels(lvl)
        for i, dc in enumerate(DENSE, 1):
            out.append((f"dec{lvl}/conv{i}", c, dc, 3))
            c += dc
        out.append((f"dec{lvl}/flow", c, 2, 3))
        if lvl > 2:
            out.append((f"dec{lvl}/upflow", 2, 2, 4))
            out.append((f"dec{lvl}/upfeat", c, 2, 4))
    c = _decoder_in_channels(2) + sum(DENSE)
    for i, co in enumerate([128, 128, 128, 96, 64, 32, 2], 1):
        out.append((f"ctx/conv{i}", c, co, 3))
        c = co
    return out


class PWCNet(nn.Module):
    name = "pwc"

    def __init__(self, seed: int = 0):
        super().__init__()
        self.convs = layout_modules(layout())
        for i, d in enumerate(CTX_DILATIONS, 1):
            m = self.convs[f"ctx_conv{i}"]
            m.dilation, m.padding = (d, d), (d, d)
        for lvl in range(1, 7):
            self.convs[f"ext{lvl}_conv1"].stride = (2, 2)
        init_layout(self.convs, layout(), seed)

    def _pyramid(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for lvl in range(1, 7):
            for i in range(1, 4):
                x = leaky_relu(self.convs[f"ext{lvl}_conv{i}"](x))
            feats.append(x)
        return feats  # levels 1..6

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) RGB in [0, 1] x2 -> (B, 2, H, W) flow in pixels."""
        f1s, f2s = self._pyramid(im1), self._pyramid(im2)
        c = self.convs
        flow = dense = None
        for lvl in range(6, 1, -1):
            f1, f2 = f1s[lvl - 1], f2s[lvl - 1]
            if lvl == 6:
                x = leaky_relu(correlation(f1, f2, MAX_DISP))
            else:
                up_flow = c[f"dec{lvl + 1}_upflow"](flow)
                up_feat = c[f"dec{lvl + 1}_upfeat"](dense)
                warped = backward_warp(f2, up_flow * WARP_SCALE[lvl])
                corr = leaky_relu(correlation(f1, warped, MAX_DISP))
                x = torch.cat([corr, f1, up_flow, up_feat], 1)
            for i in range(1, len(DENSE) + 1):
                x = torch.cat([leaky_relu(c[f"dec{lvl}_conv{i}"](x)), x], 1)  # DenseNet-style growth
            dense = x
            flow = c[f"dec{lvl}_flow"](x)

        ctx = dense
        for i in range(1, len(CTX_DILATIONS) + 1):
            ctx = c[f"ctx_conv{i}"](ctx)
            if i < len(CTX_DILATIONS):
                ctx = leaky_relu(ctx)
        return 20.0 * resize_bilinear(flow + ctx, size=tuple(im1.shape[2:]))


__all__ = ["PWCNet", "layout", "MAX_DISP"]
