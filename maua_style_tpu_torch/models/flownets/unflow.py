"""UnFlow (Meister et al. 2018; JAX counterpart:
maua_style_tpu/models/flownets/unflow.py), whose network is FlowNetC.

- a shared feature tower of three leaky-ReLU convs (7x7, 5x5, 5x5, all
  stride 2) on each image;
- the cost volume of the two 1/8-resolution towers, d = 20 sampled every
  2 px (``ops.correlation``, the CUDA kernel K2 on the GPU: 441
  channels), and a 1x1 redirect of the first tower: 473 channels;
- the contracting convs conv3_1 … conv6_1 and the expanding decoder: at
  each level a flow head, a deconv of the features and an up-flow deconv
  (kernel 4, stride 2), concatenated with the skip connection;
- the flow is 20 * resize(flow_2, input size) / 4.

Inputs are RGB in [0, 1] with H and W multiples of 64 (the flow module
resizes to that).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.correlation import correlation
from ...ops.resize import resize_bilinear
from .common import init_layout, layout_modules, leaky_relu

MAX_DISP, STRIDE = 20, 2
_STRIDE_2 = ("feat/conv1", "feat/conv2", "feat/conv3", "conv4", "conv5", "conv6")


def layout() -> list[tuple[str, int, int, int]]:
    return [
        # shared feature tower (applied to both images)
        ("feat/conv1", 3, 64, 7),
        ("feat/conv2", 64, 128, 5),
        ("feat/conv3", 128, 256, 5),
        ("redir", 256, 32, 1),
        # contracting part after the correlation: 441 + 32 channels
        ("conv3_1", 473, 256, 3),
        ("conv4", 256, 512, 3),
        ("conv4_1", 512, 512, 3),
        ("conv5", 512, 512, 3),
        ("conv5_1", 512, 512, 3),
        ("conv6", 512, 1024, 3),
        ("conv6_1", 1024, 1024, 3),
        # expanding part
        ("flow6", 1024, 2, 3),
        ("deconv5", 1024, 512, 4),
        ("upflow6", 2, 2, 4),
        ("flow5", 512 + 512 + 2, 2, 3),
        ("deconv4", 512 + 512 + 2, 256, 4),
        ("upflow5", 2, 2, 4),
        ("flow4", 512 + 256 + 2, 2, 3),
        ("deconv3", 512 + 256 + 2, 128, 4),
        ("upflow4", 2, 2, 4),
        ("flow3", 256 + 128 + 2, 2, 3),
        ("deconv2", 256 + 128 + 2, 64, 4),
        ("upflow3", 2, 2, 4),
        ("flow2", 128 + 64 + 2, 2, 3),
    ]


class UnFlow(nn.Module):
    name = "unflow"

    def __init__(self, seed: int = 0):
        super().__init__()
        self.convs = layout_modules(layout())
        for name in _STRIDE_2:
            self.convs[name.replace("/", "_")].stride = (2, 2)
        init_layout(self.convs, layout(), seed)

    def _tower(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        c1 = leaky_relu(self.convs["feat_conv1"](x))
        c2 = leaky_relu(self.convs["feat_conv2"](c1))
        c3 = leaky_relu(self.convs["feat_conv3"](c2))
        return c1, c2, c3

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) RGB in [0, 1] x2 -> (B, 2, H, W) flow in pixels."""
        c = self.convs
        _, c2a, c3a = self._tower(im1)
        _, _, c3b = self._tower(im2)

        corr = leaky_relu(correlation(c3a, c3b, MAX_DISP, STRIDE))
        x = torch.cat([corr, leaky_relu(c["redir"](c3a))], 1)

        c3_1 = leaky_relu(c["conv3_1"](x))
        c4 = leaky_relu(c["conv4_1"](leaky_relu(c["conv4"](c3_1))))
        c5 = leaky_relu(c["conv5_1"](leaky_relu(c["conv5"](c4))))
        c6 = leaky_relu(c["conv6_1"](leaky_relu(c["conv6"](c5))))

        x, flow = c6, c["flow6"](c6)
        for lvl, skip in ((5, c5), (4, c4), (3, c3_1), (2, c2a)):
            x = torch.cat([skip, leaky_relu(c[f"deconv{lvl}"](x)), c[f"upflow{lvl + 1}"](flow)], 1)
            flow = c[f"flow{lvl}"](x)
        return 20.0 * resize_bilinear(flow, size=tuple(im1.shape[2:])) / 4.0


__all__ = ["UnFlow", "layout", "MAX_DISP", "STRIDE"]
