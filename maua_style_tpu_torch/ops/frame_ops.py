"""Per-frame image ops of the vid_img frame path, on the engine's device
(JAX counterpart: maua_style_tpu/ops/frame_ops.py).

Only a uint8 frame goes to the device and a uint8 image comes back per
frame; everything between stays a tensor:

- ``preprocess_u8``: (H, W, 3) uint8 RGB -> (1, 3, h, w) float32 Caffe-BGR,
  mean-subtracted, resized (reference load.py:21-32 + style.py:38-41).
- ``deprocess_to_u8``: (1, 3, H, W) -> (H, W, 3) uint8 RGB (load.py:47-52).
- ``style_hist_stats``: host numpy, once per scale: the style side of the
  PCA colour transfer (mu_s, Qs).
- ``match_histogram_device``: the target side per frame (utils.py:127-137):
  the frame's 3x3 channel covariance and its ``eigh``.  On CUDA the 3x3
  ``eigh`` synchronises with the host once per frame.
- ``warp_map_from_flow``: (H, W, 2) pixel flow -> (1, h, w, 2) grid for
  ``grid_sample`` (load.py:191-214).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.image import CAFFE_MEAN
from .gaussian import gaussian_blur
from .resize import resize_bilinear
from .warp import identity_grid


def _mean(device) -> torch.Tensor:
    return torch.from_numpy(CAFFE_MEAN).to(device).view(1, 3, 1, 1)


def preprocess_u8(u8_hwc: torch.Tensor, size: tuple[int, int] | None = None, scale_factor: float | None = None) -> torch.Tensor:
    """Mean subtraction commutes with bilinear resampling (the weights sum
    to 1), so resize-then-subtract equals the host's subtract-then-resize."""
    x = u8_hwc.permute(2, 0, 1).contiguous().float()[None]  # NCHW, not a channels-last view
    if size is not None or scale_factor is not None:
        x = resize_bilinear(x, size=size, scale_factor=scale_factor)
    return x.flip(1) - _mean(x.device)


def deprocess_to_u8(x: torch.Tensor) -> torch.Tensor:
    rgb = (x[:1].float() + _mean(x.device)).flip(1)[0].permute(1, 2, 0)
    rgb = torch.clamp(rgb / 255.0, 0.0, 1.0)
    return (rgb * 255.0 + 0.5).to(torch.uint8).contiguous()


def style_hist_stats(source, eps: float = 1e-2, mode="avg", rng: np.random.Generator | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(mu_s (3,), Qs (3, 3)): the style's channel mean and the symmetric
    square root of its channel covariance, with the reference's jitter guard
    (utils.py:123-124).  Unseeded unless ``rng`` is given, as in the JAX
    package."""
    src = np.asarray(source, np.float32)
    rng = rng or np.random.default_rng()
    frames = src.mean(axis=0, keepdims=True) if mode == "avg" else src[rng.integers(0, src.shape[0])][None]
    frames = frames + 1e-3 * rng.standard_normal(frames.shape).astype(np.float32)
    c = frames.shape[-1]
    mu = frames.reshape(-1, c).mean(axis=0)
    h = (frames.reshape(-1, c) - mu).T
    cov = h @ h.T / h.shape[1] + eps * np.eye(c, dtype=np.float32)
    eva, eve = np.linalg.eigh(cov)
    qs = (eve * np.sqrt(np.maximum(eva, 0.0))) @ eve.T
    return mu.astype(np.float32), qs.astype(np.float32)


def match_histogram_device(x: torch.Tensor, mu_s, qs, eps: float = 1e-2) -> torch.Tensor:
    """Recolour (B, 3, H, W) ``x`` so its channel covariance matches the
    style's: t' = Qs Qt^-1 (t - mu_t) + mu_s, Qt^-1 from the 3x3 eigh of
    x's covariance (the eps ridge keeps its eigenvalues positive)."""
    b, c, h, w = x.shape
    flat = x.float().permute(0, 2, 3, 1).reshape(-1, c)
    mu_t = flat.mean(0)
    centred = flat - mu_t
    cov = centred.T @ centred / flat.shape[0] + eps * torch.eye(c, device=x.device)
    eva, eve = torch.linalg.eigh(cov)
    qt_inv = (eve / torch.sqrt(torch.clamp(eva, min=eps * 1e-3))) @ eve.T
    qs = torch.as_tensor(qs, dtype=torch.float32, device=x.device)
    mu_s = torch.as_tensor(mu_s, dtype=torch.float32, device=x.device)
    out = centred @ (qs @ qt_inv).T + mu_s
    return out.reshape(b, h, w, c).permute(0, 3, 1, 2).to(x.dtype).contiguous()


def warp_map_from_flow(flow: torch.Tensor, out_hw: tuple[int, int], smooth_sigma: float = 5.0) -> torch.Tensor:
    """(H, W, 2) raw pixel flow -> (1, h, w, 2) grid: normalise by (W, H),
    gaussian-smooth (sigma 5, spatial axes only), add the identity grid,
    resize bilinearly to ``out_hw``."""
    h, w = flow.shape[:2]
    f = flow.float() / torch.tensor([w, h], dtype=torch.float32, device=flow.device)
    f = gaussian_blur(f, [smooth_sigma, smooth_sigma, 0])
    wm = identity_grid(h, w, flow.device) + f[None]
    if tuple(out_hw) != (h, w):
        wm = resize_bilinear(wm.permute(0, 3, 1, 2), size=tuple(out_hw)).permute(0, 2, 3, 1)
    return wm.contiguous()


__all__ = ["preprocess_u8", "deprocess_to_u8", "style_hist_stats", "match_histogram_device", "warp_map_from_flow"]
