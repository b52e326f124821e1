"""VQGAN first-stage model of taming-transformers (JAX counterpart:
maua_style_tpu/models/vqgan.py; reference clip_vqgan.py:48, 204-219), NCHW.

encoder -> quant_conv -> codebook; post_quant_conv -> decoder, with
taming's module names (``encoder.down.0.block.0.conv1.weight``,
``quantize.embedding.weight``, ...), so a taming checkpoint loads after
its ``first_stage_model.`` prefix and the loss's keys are dropped:

- ResNet blocks: GroupNorm (32 groups, or gcd(32, C) at narrow test
  widths; eps 1e-6) + swish + 3x3 convs, a 1x1 ``nin_shortcut`` on a
  channel change;
- single-head self-attention where the config's resolution counter (not
  the input's size) is in ``attn_resolutions``;
- downsample: pad (0, 1, 0, 1), stride-2 3x3 conv; upsample: nearest x2 +
  3x3 conv; mid: ResBlock, Attn, ResBlock.

Inference only: the engine optimises the latent z, never the weights.
"""

from __future__ import annotations

import functools
import glob
import math
import os
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grads import replace_grad
from .clip.convert import load_clip_npz
from .registry import allow_random_weights


@dataclass(frozen=True)
class VQGANConfig:
    embed_dim: int = 256
    n_embed: int = 1024
    ch: int = 128
    ch_mult: tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: tuple[int, ...] = (16,)
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    z_channels: int = 256

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (self.num_resolutions - 1)


IMAGENET_F16_1024 = VQGANConfig(n_embed=1024)
IMAGENET_F16_16384 = VQGANConfig(n_embed=16384)
PRESETS = {
    "imagenet_1024": IMAGENET_F16_1024,
    "imagenet_16384": IMAGENET_F16_16384,
    "coco": VQGANConfig(n_embed=8192),
    "faceshq": IMAGENET_F16_1024,
    "wikiart_1024": IMAGENET_F16_1024,
    "wikiart_16384": IMAGENET_F16_16384,
    "sflckr": IMAGENET_F16_1024,
}


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def Normalize(c: int) -> nn.GroupNorm:
    """taming's GroupNorm(32, eps 1e-6); gcd groups where C % 32 ≠ 0."""
    return nn.GroupNorm(32 if c % 32 == 0 else math.gcd(32, c), c, eps=1e-6)


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class Hooks(NamedTuple):
    """How a layer acts on a list of row bands of one image: ``conv(m, xs)``
    runs the convolution ``m`` and ``norm(m, xs)`` the GroupNorm ``m`` over
    the list.  ``EACH``, the default, is each module's own call on each
    tensor (one band: the whole image); ``parallel/spatial.banded_decode``
    passes hooks that read halo rows and reduce the statistics over the
    bands."""

    conv: Callable
    norm: Callable


def _each(m: nn.Module, xs: list) -> list:
    return [m(x) for x in xs]


EACH = Hooks(_each, _each)


def _on_bands(forward):
    """A layer's ``forward(self, xs, hooks)`` over a list of row bands,
    also called with one tensor (and then returning one)."""

    @functools.wraps(forward)
    def call(self, x, hooks: Hooks | None = None):
        if isinstance(x, (list, tuple)):
            return forward(self, list(x), hooks or EACH)
        return forward(self, [x], hooks or EACH)[0]

    return call


def _attend(qs: list, ks: list, vs: list) -> list:
    """Single-head attention of (B, n_i, C) token bands: each band's queries
    over every band's keys and values, gathered to its device; the softmax
    is over all positions."""
    out = []
    for q in qs:
        k = torch.cat([t.to(q.device) for t in ks], dim=1)
        v = torch.cat([t.to(q.device) for t in vs], dim=1)
        out.append(torch.softmax((q @ k.transpose(1, 2)) * (q.shape[2] ** -0.5), dim=-1) @ v)
    return out


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = Normalize(cin)
        self.conv1 = _conv(cin, cout, 3)
        self.norm2 = Normalize(cout)
        self.conv2 = _conv(cout, cout, 3)
        self.nin_shortcut = _conv(cin, cout, 1) if cin != cout else None

    @_on_bands
    def forward(self, xs: list, hooks: Hooks) -> list:
        h = hooks.conv(self.conv1, [swish(y) for y in hooks.norm(self.norm1, xs)])
        h = hooks.conv(self.conv2, [swish(y) for y in hooks.norm(self.norm2, h)])
        if self.nin_shortcut is not None:
            xs = hooks.conv(self.nin_shortcut, xs)
        return [x + y for x, y in zip(xs, h)]


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = Normalize(c)
        self.q, self.k, self.v, self.proj_out = (_conv(c, c, 1) for _ in range(4))

    @_on_bands
    def forward(self, xs: list, hooks: Hooks) -> list:
        hn = hooks.norm(self.norm, xs)

        def tokens(m):  # (B, h_i·W, C)
            return [y.flatten(2).transpose(1, 2) for y in hooks.conv(m, hn)]

        out = _attend(tokens(self.q), tokens(self.k), tokens(self.v))
        out = [o.transpose(1, 2).reshape(x.shape) for o, x in zip(out, xs)]
        return [x + y for x, y in zip(xs, hooks.conv(self.proj_out, out))]


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = _conv(c, c, 3)

    @_on_bands
    def forward(self, xs: list, hooks: Hooks) -> list:
        return hooks.conv(self.conv, [F.interpolate(x, scale_factor=2.0, mode="nearest") for x in xs])


class _Level(nn.Module):
    """One resolution: ``block`` and ``attn`` lists, and ``downsample`` or
    ``upsample`` except at the last."""

    def __init__(self, cin: int, cout: int, n_blocks: int, attn: bool):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()
        for _ in range(n_blocks):
            self.block.append(ResnetBlock(cin, cout))
            if attn:
                self.attn.append(AttnBlock(cout))
            cin = cout

    @_on_bands
    def forward(self, h: list, hooks: Hooks) -> list:
        for i, blk in enumerate(self.block):
            h = blk(h, hooks)
            if len(self.attn):
                h = self.attn[i](h, hooks)
        return h


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c)
        self.block_2 = ResnetBlock(c, c)

    @_on_bands
    def forward(self, h: list, hooks: Hooks) -> list:
        return self.block_2(self.attn_1(self.block_1(h, hooks), hooks), hooks)


class Encoder(nn.Module):
    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        ch = cfg.ch
        self.conv_in = _conv(cfg.in_channels, ch, 3)
        self.down = nn.ModuleList()
        res, cin = cfg.resolution, ch
        for lvl in range(cfg.num_resolutions):
            cout = ch * cfg.ch_mult[lvl]
            level = _Level(cin, cout, cfg.num_res_blocks, res in cfg.attn_resolutions)
            if lvl != cfg.num_resolutions - 1:
                level.downsample = Downsample(cout)
                res //= 2
            self.down.append(level)
            cin = cout
        self.mid = _Mid(cin)
        self.norm_out = Normalize(cin)
        self.conv_out = _conv(cin, cfg.z_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        ch = cfg.ch
        block_in = ch * cfg.ch_mult[-1]
        self.conv_in = _conv(cfg.z_channels, block_in, 3)
        self.mid = _Mid(block_in)
        res = cfg.resolution // cfg.downsample_factor
        up: list[nn.Module] = [None] * cfg.num_resolutions
        cin = block_in
        for lvl in reversed(range(cfg.num_resolutions)):
            cout = ch * cfg.ch_mult[lvl]
            level = _Level(cin, cout, cfg.num_res_blocks + 1, res in cfg.attn_resolutions)
            if lvl != 0:
                level.upsample = Upsample(cout)
                res *= 2
            up[lvl] = level
            cin = cout
        self.up = nn.ModuleList(up)
        self.norm_out = Normalize(cin)
        self.conv_out = _conv(cin, cfg.out_ch, 3)

    @_on_bands
    def forward(self, zs: list, hooks: Hooks) -> list:
        h = self.mid(hooks.conv(self.conv_in, zs), hooks)
        for level in reversed(self.up):
            h = level(h, hooks)
            if hasattr(level, "upsample"):
                h = level.upsample(h, hooks)
        return hooks.conv(self.conv_out, [swish(y) for y in hooks.norm(self.norm_out, h)])


class Quantize(nn.Module):
    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, embed_dim)


class VQGAN(nn.Module):
    """``encode``: (B, 3, H, W) in [-1, 1] -> pre-quant latents (B, D, h, w);
    ``quantize``: nearest codes, straight-through; ``decode``: quantised
    latents -> (B, 3, H, W) in [-1, 1]."""

    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = _conv(cfg.z_channels, cfg.embed_dim, 1)
        self.post_quant_conv = _conv(cfg.embed_dim, cfg.z_channels, 1)
        self.quantize = Quantize(cfg.n_embed, cfg.embed_dim)

    @property
    def codebook(self) -> torch.Tensor:
        return self.quantize.embedding.weight

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x))

    @_on_bands
    def decode(self, zs: list, hooks: Hooks) -> list:
        """(B, D, h, w) quantised latents -> (B, 3, H, W); a list of row
        bands of them, with ``hooks`` that join the bands
        (``parallel/spatial.banded_decode``), -> the image's bands."""
        return self.decoder(hooks.conv(self.post_quant_conv, zs), hooks)

    def code_indices(self, z: torch.Tensor) -> torch.Tensor:
        """(B, D, h, w) -> (B, h, w) nearest codes by |z|² + |c|² − 2 z·c,
        the JAX package's formula (vqgan.py:171-176)."""
        cb = self.codebook
        zl = z.permute(0, 2, 3, 1)
        d = (zl ** 2).sum(-1, keepdim=True) + (cb ** 2).sum(1) - 2 * (zl @ cb.T)
        return d.argmin(-1)

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """(B, h, w) code indices -> (B, D, h, w) code vectors."""
        return self.codebook[indices].permute(0, 3, 1, 2)

    def quantize_st(self, z: torch.Tensor) -> torch.Tensor:
        """Nearest codes forward, the gradient straight through to ``z``
        (reference clip_vqgan.py:126-130)."""
        return replace_grad(self.lookup(self.code_indices(z)), z)


# ---------------------------------------------------------------------------
# weights


def _f32(v) -> torch.Tensor:
    """A CPU float32 tensor from a tensor or an array."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(v, np.float32).copy())


def init_vqgan(cfg: VQGANConfig, seed: int = 0) -> VQGAN:
    """A VQGAN with seeded random weights at the JAX package's scales:
    conv weights normal · sqrt(2 / fan_in), zero biases, unit GroupNorms,
    the codebook uniform in ±1/n_embed.  Drawn on the CPU from a
    ``torch.Generator`` (every device gets the same weights); it does not
    reproduce JAX's threefry draws (``vqgan_params_from_jax`` carries
    those across)."""
    gen = torch.Generator().manual_seed(seed)
    model = VQGAN(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                cout, cin, kh, kw = m.weight.shape
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * np.sqrt(2.0 / (kh * kw * cin)))
                m.bias.zero_()
        cb = model.codebook
        cb.copy_((torch.rand(cb.shape, generator=gen) * 2 - 1) / cfg.n_embed)
    return model


def vqgan_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The JAX package's parameter tree -> taming-keyed state dict: conv
    ``w`` HWIO -> ``weight`` OIHW, norm ``g`` -> ``weight``, ``b`` ->
    ``bias``, ``codebook`` -> ``quantize.embedding.weight``."""
    sd: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}.{i}", v)
        else:
            head, leaf = prefix.rsplit(".", 1) if "." in prefix else ("", prefix)
            t = _f32(node)
            if leaf == "codebook":
                sd["quantize.embedding.weight"] = t
            elif leaf == "w":
                sd[head + ".weight"] = t.permute(3, 2, 0, 1).contiguous()
            else:
                sd[head + (".weight" if leaf == "g" else ".bias")] = t

    walk("", tree)
    return sd


_OWN_PREFIXES = ("encoder.", "decoder.", "quant_conv.", "post_quant_conv.", "quantize.embedding.")


def convert_vqgan_state_dict(sd) -> dict[str, torch.Tensor]:
    """A taming VQModel state dict (a ``first_stage_model.`` prefix
    stripped, the loss's and other modules' keys dropped) -> the port's."""
    out = {}
    for k, v in sd.items():
        k = k[len("first_stage_model."):] if k.startswith("first_stage_model.") else k
        if k.startswith(_OWN_PREFIXES):
            out[k] = _f32(v)
    return out


def vqgan_from_state_dict(sd: dict, cfg: VQGANConfig) -> VQGAN:
    model = VQGAN(cfg)
    model.load_state_dict(sd, strict=True)
    return model


def _torch_ckpt(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.get("state_dict", sd)


def load_vqgan(model_dir: str, seed: int = 0, allow_random: bool | None = None) -> VQGAN:
    """A preset name or a checkpoint directory -> a ``VQGAN`` on the CPU
    (reference clip_vqgan.py:160-219, without the downloads).

    A preset reads ``modelzoo/vqgan_<preset>.npz`` (the JAX package's tree)
    or ``modelzoo/<preset>.ckpt`` (taming); without either it is an error
    unless ``allow_random`` / ``MAUA_ALLOW_RANDOM_WEIGHTS`` asks for seeded
    random weights."""
    if model_dir in PRESETS:
        cfg = PRESETS[model_dir]
        candidates = (f"modelzoo/vqgan_{model_dir}.npz", f"modelzoo/{model_dir}.ckpt")
        for cand in candidates:
            if os.path.exists(cand):
                if cand.endswith(".npz"):
                    return vqgan_from_state_dict(vqgan_params_from_jax(load_clip_npz(cand)), cfg)
                return vqgan_from_state_dict(convert_vqgan_state_dict(_torch_ckpt(cand)), cfg)
        if not allow_random_weights(allow_random):
            raise FileNotFoundError(
                f"No VQGAN checkpoint for preset '{model_dir}' (searched {list(candidates)}).\n"
                f"Place the taming-transformers .ckpt at modelzoo/{model_dir}.ckpt (it is\n"
                f"converted on load), or pass --allow_random_weights to run with\n"
                f"deterministic random weights (outputs will be noise; for tests/smoke only)."
            )
        print(f"Warning: no VQGAN checkpoint for '{model_dir}'; using deterministic random init.")
        return init_vqgan(cfg, seed)
    ckpts = sorted(glob.glob(model_dir + "/*.ckpt"), reverse=True)
    if not ckpts:
        raise FileNotFoundError(f"no .ckpt in {model_dir}")
    cfg = IMAGENET_F16_16384 if any("16384" in c for c in ckpts) else IMAGENET_F16_1024
    return vqgan_from_state_dict(convert_vqgan_state_dict(_torch_ckpt(ckpts[0])), cfg)


__all__ = [
    "VQGAN",
    "VQGANConfig",
    "PRESETS",
    "Hooks",
    "EACH",
    "init_vqgan",
    "vqgan_params_from_jax",
    "convert_vqgan_state_dict",
    "vqgan_from_state_dict",
    "load_vqgan",
]
