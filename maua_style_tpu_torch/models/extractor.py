"""Spec-driven convolutional feature extraction (JAX counterpart:
maua_style_tpu/models/extractor.py).

A model is a flat tuple of layer specs (conv / relu / pool / drop / softmax)
with the reference's canonical layer names (models.py:140-243).  The
``Extractor`` module runs the spec in NCHW and returns the activations
requested by name, stopping at the deepest one.  Its state dict is keyed
``{conv_name}.weight`` (OIHW) / ``{conv_name}.bias``.

Pools keep the JAX package's semantics: floor-mode pools drop the ragged
edge (for the non-overlapping VGG pools this is the JAX crop to a multiple
of k); ceil-mode pools drop a trailing window that would start past the
input; avg pools divide by the in-bounds count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable

import torch
import torch.nn.functional as F
from torch import nn

from .. import trace


@dataclass(frozen=True)
class Layer:
    kind: str  # "conv" | "relu" | "maxpool" | "avgpool" | "drop" | "softmax"
    name: str
    out_ch: int = 0
    kernel: tuple[int, int] = (0, 0)
    stride: tuple[int, int] = (1, 1)
    pad: tuple[int, int] = (0, 0)
    ceil_mode: bool = False


@dataclass(frozen=True)
class ExtractorSpec:
    arch: str
    layers: tuple[Layer, ...]
    in_ch: int = 3

    @property
    def conv_layers(self) -> tuple[Layer, ...]:
        return tuple(l for l in self.layers if l.kind == "conv")

    def layer_names(self) -> tuple[str, ...]:
        return tuple(l.name for l in self.layers)


def truncate_spec(spec: ExtractorSpec, wanted: Iterable[str]) -> ExtractorSpec:
    """Spec cut off after the deepest wanted layer (the reference stops
    building the net once all loss layers are inserted, models.py:382)."""
    wanted = set(wanted)
    if not wanted:  # pixel-space losses only: no feature net needed
        return ExtractorSpec(spec.arch, (), spec.in_ch)
    names = [l.name for l in spec.layers]
    missing = wanted - set(names)
    if missing:
        raise ValueError(f"unknown layers for {spec.arch}: {sorted(missing)}; available: {names}")
    last = max(i for i, n in enumerate(names) if n in wanted)
    return ExtractorSpec(spec.arch, spec.layers[: last + 1], spec.in_ch)


def init_params(spec: ExtractorSpec, seed: int = 0) -> dict[str, torch.Tensor]:
    """Deterministic He-normal state dict from a seeded ``torch.Generator``
    (the fallback when no checkpoint is available).  It does not reproduce
    the JAX package's threefry weights; tests hand both packages the same
    weights through ``models.convert.params_from_jax``."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    in_ch = spec.in_ch
    for layer in spec.conv_layers:
        kh, kw = layer.kernel
        std = math.sqrt(2.0 / (kh * kw * in_ch))
        sd[f"{layer.name}.weight"] = torch.randn((layer.out_ch, in_ch, kh, kw), generator=gen) * std
        sd[f"{layer.name}.bias"] = torch.zeros(layer.out_ch)
        in_ch = layer.out_ch
    return sd


def pool_out_len(length: int, kernel: int, stride: int, ceil_mode: bool) -> int:
    if ceil_mode:
        out = -(-(length - kernel) // stride) + 1
        # torch drops a trailing window that would start beyond the input
        if (out - 1) * stride >= length:
            out -= 1
        return max(out, 1)
    return (length - kernel) // stride + 1


def pool_layer(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    """A pool layer of ``x`` with the JAX package's edge semantics (the
    module docstring)."""
    k, s = layer.kernel, layer.stride
    is_max = layer.kind == "maxpool"
    if not layer.ceil_mode:
        return F.max_pool2d(x, k, s) if is_max else F.avg_pool2d(x, k, s)
    h, w = x.shape[2], x.shape[3]
    oh = pool_out_len(h, k[0], s[0], True)
    ow = pool_out_len(w, k[1], s[1], True)
    pad = (0, max((ow - 1) * s[1] + k[1] - w, 0), 0, max((oh - 1) * s[0] + k[0] - h, 0))
    if is_max:
        return F.max_pool2d(F.pad(x, pad, value=float("-inf")), k, s)
    summed = F.avg_pool2d(F.pad(x, pad), k, s, divisor_override=1)
    ones = torch.ones((1, 1, h, w), dtype=x.dtype, device=x.device)
    count = F.avg_pool2d(F.pad(ones, pad), k, s, divisor_override=1)
    return summed / count


class Extractor(nn.Module):
    """The feature net of a spec; weights are frozen (the optimisation
    differentiates with respect to the input image only)."""

    def __init__(self, spec: ExtractorSpec, state_dict: dict[str, torch.Tensor] | None = None):
        super().__init__()
        self.spec = spec
        in_ch = spec.in_ch
        for layer in spec.conv_layers:
            self.add_module(layer.name, nn.Conv2d(in_ch, layer.out_ch, layer.kernel, layer.stride, layer.pad))
            in_ch = layer.out_ch
        if state_dict is not None:
            own = {l.name for l in spec.conv_layers}
            self.load_state_dict({k: v for k, v in state_dict.items() if k.split(".")[0] in own})
        self.requires_grad_(False)

    def forward(self, x, wanted: Iterable[str] = (), conv=None, pool=None) -> dict:
        """x: (B, C, H, W), or a list of row bands of one image
        (``parallel/spatial.py``).  Returns {name: activation} for
        ``wanted``, a list of band activations each for bands.  ``conv(layer,
        xs)`` runs a convolution layer over the list ``xs`` and ``pool(layer,
        xs)`` a pool layer (bands: with their halo rows,
        ``spatial.banded_forward``); by default this module's own
        convolution, and ``pool_layer``, of each."""
        with trace.span("net.forward"):
            return self._features(x, wanted, conv, pool)

    def _features(self, x, wanted, conv, pool) -> dict:
        banded = isinstance(x, (list, tuple))
        xs = list(x) if banded else [x]
        if conv is None:
            def conv(layer, xs):
                return [self.get_submodule(layer.name)(x) for x in xs]
        if pool is None:
            def pool(layer, xs):
                return [pool_layer(x, layer) for x in xs]
        remaining = set(wanted)
        acts: dict = {}
        for layer in self.spec.layers:
            if layer.kind == "conv":
                xs = conv(layer, xs)
            elif layer.kind == "relu":
                xs = [torch.relu(x) for x in xs]
            elif layer.kind in ("maxpool", "avgpool"):
                xs = pool(layer, xs)
            elif layer.kind == "drop":
                pass  # inference-mode dropout is identity
            elif layer.kind == "softmax":
                xs = [torch.softmax(x, dim=1) for x in xs]
            else:  # pragma: no cover
                raise ValueError(f"unknown layer kind {layer.kind}")
            if layer.name in remaining:
                acts[layer.name] = xs if banded else xs[0]
                remaining.discard(layer.name)
                if not remaining:
                    break
        if remaining:
            raise ValueError(f"layers not found in {self.spec.arch}: {sorted(remaining)}")
        return acts

__all__ = ["Layer", "ExtractorSpec", "Extractor", "init_params", "truncate_spec", "pool_layer", "pool_out_len"]
