"""CLIP (Radford et al. 2021), the ViT variant (JAX counterpart:
maua_style_tpu/models/clip/model.py; reference clip_vqgan.py:420, 443-449).

A visual ViT and a causally masked text transformer, pre-norm blocks with
QuickGELU, as ``nn.Module``s whose parameter names are OpenAI's checkpoint
keys (``visual.conv1.weight``, ``transformer.resblocks.0.attn.in_proj_weight``,
``text_projection``, ...), so an OpenAI state dict loads with
``load_state_dict`` (``convert.py``).  Attention is the fused-qkv product,
a softmax and a second product, in float32.

The ResNet backbones (RN50, RN101, RN50x4) are ``resnet.CLIPResNet``: this
module's text tower beside a ModifiedResNet visual tower.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclass(frozen=True)
class CLIPConfig:
    image_resolution: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    embed_dim: int = 512
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12


VIT_B32 = CLIPConfig()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, eps 1e-5 (``weight``, ``bias``)."""

    def __init__(self, width: int):
        super().__init__(width, eps=1e-5)


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection
    (``in_proj_weight`` (3D, D), ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (a.reshape(b, t, self.heads, hd).transpose(1, 2) for a in qkv.chunk(3, dim=-1))  # (B, H, T, hd)
        logits = (q * (1.0 / np.sqrt(hd))) @ k.transpose(-2, -1)
        if mask is not None:
            logits = logits + mask
        out = torch.softmax(logits, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = Attention(width, heads)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads) for _ in range(layers))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, mask)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w, p = cfg.vision_width, cfg.patch_size
        grid = cfg.image_resolution // p
        self.patch_size = p
        self.conv1 = nn.Conv2d(3, w, kernel_size=p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, w))
        self.ln_pre = LayerNorm(w)
        self.transformer = Transformer(w, cfg.vision_layers, cfg.vision_heads)
        self.ln_post = LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        patches = self.conv1(x)  # (B, W, g, g)
        b, w = patches.shape[:2]
        tokens = patches.reshape(b, w, -1).transpose(1, 2)  # (B, g·g, W), row-major over the grid
        cls = self.class_embedding.expand(b, 1, w)
        tokens = torch.cat([cls, tokens], dim=1) + self.positional_embedding
        tokens = self.transformer(self.ln_pre(tokens))
        return self.ln_post(tokens[:, 0]) @ self.proj


class CLIP(nn.Module):
    """``encode_image``: (B, 3, R, R), normalised with CLIP_MEAN/STD by the
    caller -> (B, embed_dim); ``encode_text``: (B, context_length) token
    ids -> (B, embed_dim).  ``visual`` replaces the ViT image tower (the
    ResNet backbones pass theirs); the text tower is sized by ``cfg``."""

    def __init__(self, cfg: CLIPConfig = VIT_B32, visual: nn.Module | None = None):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTransformer(cfg) if visual is None else visual
        tw = cfg.text_width
        self.token_embedding = nn.Embedding(cfg.vocab_size, tw)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, tw))
        self.transformer = Transformer(tw, cfg.text_layers, cfg.text_heads)
        self.ln_final = LayerNorm(tw)
        self.text_projection = nn.Parameter(torch.empty(tw, cfg.embed_dim))
        n = cfg.context_length
        self.register_buffer("attn_mask", torch.full((n, n), float("-inf")).triu(1), persistent=False)

    @property
    def input_resolution(self) -> int:
        return self.cfg.image_resolution

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        return self.visual(x)

    def encode_text(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.text_projection.device)
        x = self.token_embedding(tokens) + self.positional_embedding
        x = self.ln_final(self.transformer(x, self.attn_mask))
        eot = tokens.argmax(dim=-1)  # the EOT token has the highest id
        return x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection


def _normal(gen: torch.Generator):
    def normal(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    return normal


def _init_blocks(tower: Transformer, width: int, gen: torch.Generator) -> None:
    """The blocks' weights normal width^-0.5, zero biases."""
    normal = _normal(gen)
    for blk in tower.resblocks:
        for weight, bias in ((blk.attn.in_proj_weight, blk.attn.in_proj_bias),
                             (blk.attn.out_proj.weight, blk.attn.out_proj.bias),
                             (blk.mlp.c_fc.weight, blk.mlp.c_fc.bias),
                             (blk.mlp.c_proj.weight, blk.mlp.c_proj.bias)):
            normal(weight, width ** -0.5)
            bias.zero_()


@torch.no_grad()
def init_text_tower(model: CLIP, gen: torch.Generator) -> None:
    """Seeded random text-tower weights at the JAX package's scales: token
    embedding 0.02, positional embedding 0.01, projection and blocks
    width^-0.5 (zero biases, unit LayerNorms)."""
    normal, tw = _normal(gen), model.cfg.text_width
    normal(model.token_embedding.weight, 0.02)
    normal(model.positional_embedding, 0.01)
    normal(model.text_projection, tw ** -0.5)
    _init_blocks(model.transformer, tw, gen)


@torch.no_grad()
def init_clip(cfg: CLIPConfig = VIT_B32, seed: int = 0) -> CLIP:
    """A CLIP with seeded random weights at the JAX package's scales
    (normal: patch conv and class embedding 0.02, positional embedding
    0.01, projection and the blocks' weights width^-0.5; then the text
    tower's, ``init_text_tower``).  Drawn on the CPU from a
    ``torch.Generator``, so every device gets the same weights; it does not
    reproduce JAX's threefry draws (``convert.clip_params_from_jax``
    carries those across)."""
    gen = torch.Generator().manual_seed(seed)
    normal, model = _normal(gen), CLIP(cfg)
    v = model.visual
    normal(v.conv1.weight, 0.02)
    normal(v.class_embedding, 0.02)
    normal(v.positional_embedding, 0.01)
    normal(v.proj, cfg.vision_width ** -0.5)
    _init_blocks(v.transformer, cfg.vision_width, gen)
    init_text_tower(model, gen)
    return model


__all__ = ["CLIP", "CLIPConfig", "VIT_B32", "CLIP_MEAN", "CLIP_STD", "init_clip", "init_text_tower", "quick_gelu"]
