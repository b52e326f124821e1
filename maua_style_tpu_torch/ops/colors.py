"""Luminance-only style transfer helper (JAX counterpart:
maua_style_tpu/ops/colors.py; reference: load.py:234-240).

Keeps the content image's chroma (Cb/Cr) and takes luminance (Y) from the
stylised image, on PIL images at save time.
"""

from __future__ import annotations

from PIL import Image


def original_colors(content: Image.Image, generated: Image.Image) -> Image.Image:
    content_channels = list(content.resize(generated.size).convert("YCbCr").split())
    generated_channels = list(generated.convert("YCbCr").split())
    content_channels[0] = generated_channels[0]
    return Image.merge("YCbCr", content_channels).convert("RGB")


__all__ = ["original_colors"]
