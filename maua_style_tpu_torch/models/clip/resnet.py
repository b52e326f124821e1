"""CLIP's ModifiedResNet backbones, RN50 / RN101 / RN50x4 (JAX counterpart:
maua_style_tpu/models/clip/resnet.py; openai/CLIP model.py).

A 3-conv stem (stride-2 first conv, then an average pool), Bottleneck
stages whose stride is an average pool after conv2 (and before the
shortcut's 1x1 conv), and an attention-pooling head: one multi-head query
from the mean token over the mean token and the grid, with a learned
positional embedding that fixes the input to ``image_resolution``.  The
submodules carry OpenAI's checkpoint keys (``visual.layer1.0.conv1``,
``visual.layer2.0.downsample.0``, ``visual.attnpool.q_proj``, ...).
Inference only: BatchNorm applies its running statistics (eps 1e-5) in
every mode, never batch statistics.  The text tower is the ViT CLIP's
(``model.CLIP``), sized by ``TEXT_CFGS``.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .model import CLIP, CLIPConfig, _normal, init_text_tower


@dataclass(frozen=True)
class ResNetConfig:
    layers: tuple[int, int, int, int]
    width: int = 64
    embed_dim: int = 1024
    image_resolution: int = 224
    heads: int = 32


RESNET_CONFIGS = {
    "RN50": ResNetConfig(layers=(3, 4, 6, 3), width=64, embed_dim=1024, image_resolution=224, heads=32),
    "RN101": ResNetConfig(layers=(3, 4, 23, 3), width=64, embed_dim=512, image_resolution=224, heads=32),
    "RN50x4": ResNetConfig(layers=(4, 6, 10, 6), width=80, embed_dim=640, image_resolution=288, heads=40),
}

TEXT_CFGS = {  # (text_width, text_heads, text_layers)
    "RN50": (512, 8, 12),
    "RN101": (512, 8, 12),
    "RN50x4": (640, 10, 12),
}


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm from running statistics only (``weight``, ``bias``,
    ``running_mean``, ``running_var``; eps 1e-5), in train mode too."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, 1e-5)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), FrozenBatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), FrozenBatchNorm2d(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1), FrozenBatchNorm2d(planes * 4)
        self.stride = stride
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            # OpenAI's keys: downsample.0 is the conv, downsample.1 the BN
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)), ("0", _conv(inplanes, planes * 4, 1)),
                ("1", FrozenBatchNorm2d(planes * 4)),
            ]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)  # VALID: floors an odd side
        out = self.bn3(self.conv3(out))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idn)


class AttentionPool2d(nn.Module):
    """(B, C, H, W) -> (B, embed_dim): the mean token first, the positional
    embedding added to every token, the query from the first token only
    (scaled by hd^-1/2), softmax(q kᵀ) v per head, then ``c_proj``."""

    def __init__(self, spacial: int, width: int, heads: int, embed_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial * spacial + 1, width))
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(width, width) for _ in range(3))
        self.c_proj = nn.Linear(width, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        tokens = x.reshape(b, c, h * w).transpose(1, 2)  # (B, H·W, C), row-major over the grid
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1) + self.positional_embedding
        hd = c // self.heads

        def split(a):
            return a.reshape(b, -1, self.heads, hd).transpose(1, 2)  # (B, heads, T, hd)

        q = split(self.q_proj(tokens[:, :1])) * (1.0 / np.sqrt(hd))
        k, v = split(self.k_proj(tokens)), split(self.v_proj(tokens))
        out = torch.softmax(q @ k.transpose(-2, -1), dim=-1) @ v  # (B, heads, 1, hd)
        return self.c_proj(out.transpose(1, 2).reshape(b, c))


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        w = cfg.width
        self.conv1, self.bn1 = _conv(3, w // 2, 3, stride=2), FrozenBatchNorm2d(w // 2)
        self.conv2, self.bn2 = _conv(w // 2, w // 2, 3), FrozenBatchNorm2d(w // 2)
        self.conv3, self.bn3 = _conv(w // 2, w, 3), FrozenBatchNorm2d(w)
        inplanes = w
        for stage, n in enumerate(cfg.layers):
            planes = w * 2 ** stage
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(inplanes, planes, 2 if stage > 0 and bi == 0 else 1))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.attnpool = AttentionPool2d(cfg.image_resolution // 32, inplanes, cfg.heads, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)):
            x = F.relu(bn(conv(x)))
        x = F.avg_pool2d(x, 2)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.attnpool(x)


def backbone_name(rn_cfg: ResNetConfig) -> str:
    """The name of a known config, else ``RN(layers)`` (the JAX converter's)."""
    return next((name for name, c in RESNET_CONFIGS.items() if c == rn_cfg), f"RN{rn_cfg.layers}")


class CLIPResNet(CLIP):
    """CLIP with a ModifiedResNet image tower; ``encode_image``,
    ``encode_text`` and ``input_resolution`` as ``CLIP``'s."""

    def __init__(self, rn_cfg: ResNetConfig, cfg: CLIPConfig):
        super().__init__(cfg, visual=ModifiedResNet(rn_cfg))
        self.rn_cfg = rn_cfg
        self.backbone = backbone_name(rn_cfg)

    @classmethod
    def from_backbone(cls, backbone: str) -> "CLIPResNet":
        """Uninitialised, at ``RESNET_CONFIGS[backbone]`` and ``TEXT_CFGS[backbone]``."""
        rn = RESNET_CONFIGS[backbone]
        tw, th, tl = TEXT_CFGS[backbone]
        cfg = CLIPConfig(image_resolution=rn.image_resolution, embed_dim=rn.embed_dim,
                         text_width=tw, text_heads=th, text_layers=tl)
        return cls(rn, cfg)


@torch.no_grad()
def init_clip_resnet(backbone: str, seed: int = 0) -> CLIPResNet:
    """A ``CLIPResNet`` with seeded random weights at the JAX package's
    scales: convolutions normal sqrt(2 / fan_in), BatchNorms the identity,
    the attention pool's embedding and projections normal width^-1/2 with
    zero biases; then the text tower's (``init_text_tower``).  Drawn on the
    CPU from a ``torch.Generator``; not JAX's threefry draws."""
    gen = torch.Generator().manual_seed(seed)
    normal, model = _normal(gen), CLIPResNet.from_backbone(backbone)
    for m in model.visual.modules():
        if isinstance(m, nn.Conv2d):
            normal(m.weight, np.sqrt(2.0 / m.weight[0].numel()))
    pool = model.visual.attnpool
    s = pool.q_proj.in_features ** -0.5
    normal(pool.positional_embedding, s)
    for lin in (pool.q_proj, pool.k_proj, pool.v_proj, pool.c_proj):
        normal(lin.weight, s)
        lin.bias.zero_()
    init_text_tower(model, gen)
    return model


__all__ = ["ResNetConfig", "RESNET_CONFIGS", "TEXT_CFGS", "CLIPResNet", "ModifiedResNet", "backbone_name",
           "init_clip_resnet"]
