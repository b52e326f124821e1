"""CLIP cutout augmentation (JAX counterpart: maua_style_tpu/ops/cutouts.py;
reference clip_vqgan.py:53-92, 139-157), NCHW.

The reference crops ``cutn`` random squares with sizes ~ U(0,1)^cut_pow
scaled between cut_size and min(H, W), and resamples each to cut_size with
a lanczos-2 anti-alias prefilter (reflect padding) followed by bicubic
interpolation (align_corners=True).  As in the JAX package, the sizes are
stratified: slot i takes the ((i + phase) / cutn)-quantile of that size law,
with the phase one of ``phases`` drawn per call.  Both filters are linear
maps along each axis, so each slot's resample is one (cut_size, s) matrix
A = bicubic(cut_size, s) @ lanczos_blur(s), applied as A @ crop @ Aᵀ.

Randomness (the phase and the (cutn, 2) crop offsets) comes from a
``CutoutDraws`` object, drawn on the host from a CPU ``torch.Generator``:
the crop offsets are Python integers, so cropping a device tensor needs no
device-to-host read.

``method="bilinear"`` is the JAX package's earlier path (off the engine's
default): iid sizes u^cut_pow, and each slot sampled from the image by one
half-pixel bilinear grid with border padding.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .grads import clamp_with_grad
from .warp import grid_sample


class CutoutDraws:
    """The cutouts' random numbers, from one CPU ``torch.Generator``."""

    def __init__(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def cutouts(self, cutn: int, phases: int) -> tuple[int, np.ndarray]:
        """A phase in [0, phases) and (cutn, 2) float32 offsets in [0, 1)."""
        phase = int(torch.randint(0, phases, (), generator=self.generator))
        return phase, torch.rand((cutn, 2), generator=self.generator).numpy()

    def bilinear(self, cutn: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Three (cutn,) float32 uniforms in [0, 1): sizes, x and y offsets."""
        u = torch.rand((3, cutn), generator=self.generator).numpy()
        return u[0], u[1], u[2]


def lanczos_prefilter_matrix(src: int, dst: int) -> np.ndarray:
    """(src, src) matrix of the reference's anti-alias prefilter
    (clip_vqgan.py:53-85): lanczos-2 kernel sampled at multiples of dst/src,
    normalised, applied under reflect padding.  Identity when not
    downscaling (the reference skips the filter then)."""
    if dst >= src:
        return np.eye(src)
    ratio = dst / src
    n = math.ceil(2.0 / ratio + 1)
    taps = np.arange(n, dtype=np.float64) * ratio
    x = np.concatenate([-taps[1:][::-1], taps])[1:-1]
    k = np.where((x > -2.0) & (x < 2.0), np.sinc(x) * np.sinc(x / 2.0), 0.0)
    k = k / k.sum()
    pad = (len(k) - 1) // 2
    # torch "reflect" padding: index -j -> j, src-1+j -> src-1-j
    jpos = np.arange(-pad, src + pad)
    jpos = np.abs(jpos)
    jpos = np.where(jpos >= src, 2 * (src - 1) - jpos, jpos)
    mat = np.zeros((src, src))
    for i in range(src):
        for t, kt in enumerate(k):
            mat[i, jpos[i + t]] += kt
    return mat


def bicubic_matrix(dst: int, src: int) -> np.ndarray:
    """(dst, src) matrix of torch bicubic interpolation with
    align_corners=True (cubic convolution a = -0.75, clamped borders)."""
    a = -0.75

    def cubic(x: float) -> float:
        x = abs(x)
        if x <= 1.0:
            return (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0
        if x < 2.0:
            return a * (x ** 3 - 5.0 * x ** 2 + 8.0 * x - 4.0)
        return 0.0

    mat = np.zeros((dst, src))
    for i in range(dst):
        pos = i * (src - 1) / (dst - 1) if dst > 1 else 0.0
        base = math.floor(pos)
        for t in range(-1, 3):
            j = min(max(base + t, 0), src - 1)
            mat[i, j] += cubic(pos - (base + t))
    return mat


@functools.lru_cache(maxsize=None)
def resample_matrix(src: int, dst: int) -> np.ndarray:
    """Fused (dst, src) linear map: the reference's resample, bicubic after
    the lanczos prefilter, per axis."""
    return (bicubic_matrix(dst, src) @ lanczos_prefilter_matrix(src, dst)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resample_tensor(src: int, dst: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resample_matrix(src, dst)).to(device)


def stratified_sizes(
    h: int, w: int, cut_size: int, cutn: int, cut_pow: float, phase: float = 0.5
) -> tuple[int, ...]:
    """Per-slot crop sizes: the ((i+phase)/cutn)-quantiles of the reference's
    size law  int(u^cut_pow * (max - min) + min)."""
    max_size = min(h, w)
    min_size = min(h, w, cut_size)
    return tuple(
        int(((i + phase) / cutn) ** cut_pow * (max_size - min_size) + min_size) for i in range(cutn)
    )


def make_cutouts(
    x: torch.Tensor,
    cut_size: int,
    cutn: int,
    draws: CutoutDraws,
    cut_pow: float = 1.0,
    phases: int = 4,
    method: str = "lanczos",
) -> torch.Tensor:
    """x: (1, C, H, W) in [0, 1] -> (cutn, C, cut_size, cut_size).

    One ``draws.cutouts`` call gives the phase, which fixes every slot's
    size, and the offsets; slot i's crop starts at floor(u · (H − s + 1)),
    computed in float32 as the JAX package does."""
    if method == "bilinear":
        return _make_cutouts_bilinear(x, cut_size, cutn, draws, cut_pow)
    _, _, h, w = x.shape
    p, offs = draws.cutouts(cutn, phases)
    sizes = stratified_sizes(h, w, cut_size, cutn, cut_pow, phase=(p + 0.5) / phases)
    offs = np.asarray(offs, np.float32)
    outs = []
    for i, s in enumerate(sizes):
        oy = int(np.floor(offs[i, 0] * np.float32(h - s + 1)))
        ox = int(np.floor(offs[i, 1] * np.float32(w - s + 1)))
        mat = _resample_tensor(s, cut_size, x.device)
        outs.append(mat @ x[0, :, oy : oy + s, ox : ox + s] @ mat.T)
    return clamp_with_grad(torch.stack(outs), 0.0, 1.0)


def _make_cutouts_bilinear(x, cut_size, cutn, draws, cut_pow):
    """iid sizes floor(u^cut_pow · (max − min) + min) and offsets
    floor(u · (side − size + 1)), in float32 as the JAX package's; output
    pixel i of a slot samples the image at offset + (i + 0.5) · size /
    cut_size − 0.5, bilinear, border padding (JAX cutouts.py:155-187)."""
    _, _, h, w = x.shape
    max_size, min_size = min(h, w), min(h, w, cut_size)
    u_size, u_ox, u_oy = (np.asarray(u, np.float32) for u in draws.bilinear(cutn))
    sizes = np.floor(u_size ** np.float32(cut_pow) * np.float32(max_size - min_size) + np.float32(min_size))
    offx = np.floor(u_ox * (np.float32(w) - sizes + np.float32(1)))
    offy = np.floor(u_oy * (np.float32(h) - sizes + np.float32(1)))

    def axis(off, side):  # (cutn, cut_size) grid coordinates in [-1, 1]
        ii = (torch.arange(cut_size, dtype=torch.float32, device=x.device) + 0.5) / cut_size
        size, off = (torch.from_numpy(a).to(x.device)[:, None] for a in (sizes, off))
        return (off + ii * size - 0.5 + 0.5) * 2.0 / side - 1.0

    gx, gy = axis(offx, w), axis(offy, h)
    grid = torch.stack(torch.broadcast_tensors(gx[:, None, :], gy[:, :, None]), dim=-1)  # (cutn, cs, cs, (x, y))
    return clamp_with_grad(grid_sample(x.expand(cutn, -1, -1, -1), grid), 0.0, 1.0)


__all__ = [
    "CutoutDraws",
    "make_cutouts",
    "resample_matrix",
    "lanczos_prefilter_matrix",
    "bicubic_matrix",
    "stratified_sizes",
]
