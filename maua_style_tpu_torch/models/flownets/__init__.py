"""Optical-flow estimators (JAX counterpart: maua_style_tpu/models/flownets):
SPyNet and PWC-Net as ``nn.Module``s, NCHW, inference only, RGB in [0, 1].
LiteFlowNet and UnFlow are ROADMAP Slice D."""

from .common import backward_warp
from .pwc import PWCNet
from .spynet import SPyNet

__all__ = ["backward_warp", "SPyNet", "PWCNet"]
