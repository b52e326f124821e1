"""Optical-flow estimators (JAX counterpart: maua_style_tpu/models/flownets):
SPyNet, PWC-Net, UnFlow (FlowNetC) and LiteFlowNet as ``nn.Module``s, NCHW,
inference only, RGB in [0, 1]."""

from .common import backward_warp
from .liteflownet import LiteFlowNet
from .pwc import PWCNet
from .spynet import SPyNet
from .unflow import UnFlow

__all__ = ["backward_warp", "SPyNet", "PWCNet", "UnFlow", "LiteFlowNet"]
