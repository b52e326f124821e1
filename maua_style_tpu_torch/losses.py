"""Style-transfer losses as plain tensor functions (JAX counterpart:
maua_style_tpu/losses.py; reference: loss.py).

Targets are captured up front by running the extractor on the content and
style inputs; ``evaluate_losses`` maps (pastiche, activations, targets) to
the total loss and the per-loss values, ordered as ``cfg.loss_names()``.
Activations are NCHW; the values equal the JAX package's NHWC ones.

- content / temporal: per-frame MSE to the captured target, averaged over
  frames, scaled by ``strength`` (loss.py:32-64).
- style: per-frame Gram / nelement, MSE to the blended target, averaged
  over frames (loss.py:141-157).  Grams go through ``ops.gram.batch_gram``
  (the CUDA kernel for CUDA tensors) and stay float32 for bf16 activations.
- dynamic style (img_vid, ``video_style_factor`` > 0): the whole-window
  Gram of a T-frame window (``ops.gram.video_gram``) / its nelement, MSE
  to the window target, times ``video_style_factor`` (loss.py:84-91,
  160-170).
- tv: anisotropic L1 total variation (loss.py:224-233).
- ``evaluate_frame_losses``: vid_img's stacked first pass, a batch of
  independent frames, each frame's values its own ``evaluate_losses``.
- gradient normalisation (default on, ``--no_grad_norm`` disables): each
  term's backward gradient is L2-normalised then scaled by strength**2
  (``ScaleGradients``, loss.py:10-20), as an autograd.Function.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from .ops.gram import batch_gram, video_gram


class _ScaleGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, strength: float):
        ctx.strength = strength
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / (torch.linalg.vector_norm(g) + 1e-8) * (ctx.strength * ctx.strength), None


def scale_gradients(x: torch.Tensor, strength: float) -> torch.Tensor:
    """Identity forward; backward L2-normalises the gradient and scales it
    by strength**2."""
    return _ScaleGradients.apply(x, strength)


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # accumulate in f32 even for bf16 activations
    return torch.mean(torch.square(a.float() - b.float()))


def _term(value: torch.Tensor, strength: float, frames: int, normalize: bool) -> torch.Tensor:
    if normalize:
        value = scale_gradients(value, strength)
    return value * strength / frames


@dataclass(frozen=True)
class LossConfig:
    """Static configuration of the loss bundle (mirrors the reference flags)."""

    content_layers: tuple[str, ...] = ("relu4_2",)
    style_layers: tuple[str, ...] = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")
    content_weight: float = 5.0
    style_weight: float = 100.0
    tv_weight: float = 1e-3
    temporal_weight: float = 50.0
    use_covariance: bool = False
    normalize_gradients: bool = True
    video_style_factor: float = 0.0

    @property
    def all_layers(self) -> tuple[str, ...]:
        return tuple(dict.fromkeys((*self.content_layers, *self.style_layers)))

    def loss_names(self) -> tuple[str, ...]:
        """content, style, tv, temporal — the reference's order (models.py:453)."""
        names = [f"content:{l}" for l in self.content_layers]
        names += [f"style:{l}" for l in self.style_layers]
        if self.tv_weight > 0:
            names.append("tv")
        if self.temporal_weight > 0:
            names.append("temporal")
        return tuple(names)


# ---------------------------------------------------------------------------
# target capture

ExtractFn = Callable[[torch.Tensor, Sequence[str]], dict]


@torch.no_grad()
def capture_content_targets(extract_fn: ExtractFn, content: torch.Tensor, cfg: LossConfig) -> dict[str, torch.Tensor]:
    """Content activations (reference optim.py:22-33)."""
    acts = extract_fn(content, cfg.content_layers)
    return {l: acts[l].float() for l in cfg.content_layers}


@torch.no_grad()
def capture_style_targets(
    extract_fn: ExtractFn,
    styles: Sequence[torch.Tensor],
    blend_weights: Sequence[float],
    cfg: LossConfig,
) -> dict[str, torch.Tensor]:
    """Blended static Gram targets (reference optim.py:50-66, loss.py:141-151):
    each style contributes blend_weight * mean_frames(gram / nelement)."""
    targets: dict[str, torch.Tensor] = {}
    for style, bw in zip(styles, blend_weights):
        acts = extract_fn(style, cfg.style_layers)
        for l in cfg.style_layers:
            a = acts[l]
            gram = batch_gram(a, cfg.use_covariance) / math.prod(a.shape[1:])
            contrib = bw * gram.mean(dim=0)
            targets[l] = targets[l] + contrib if l in targets else contrib
    return targets


@torch.no_grad()
def capture_style_video_targets(
    extract_fn: ExtractFn,
    style_videos: Sequence[torch.Tensor],
    blend_weights: Sequence[float],
    cfg: LossConfig,
    gram_frame_window: int,
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Static and dynamic targets averaged over every ``gram_frame_window``
    window of each (T, 3, H, W) style video (reference optim.py:69-90).
    Image styles (one frame) add no dynamic target: their window is not
    gfw frames long (reference loss.py:165-166)."""
    static: dict[str, torch.Tensor] = {}
    dynamic: dict[str, torch.Tensor] = {}
    gfw = gram_frame_window
    for video, bw in zip(style_videos, blend_weights):
        n_windows = max(video.shape[0] - gfw + 1, 1)
        w_eff = bw / n_windows
        for start in range(n_windows):
            acts = extract_fn(video[start : start + gfw], cfg.style_layers)
            for l in cfg.style_layers:
                a = acts[l]
                gram = batch_gram(a, cfg.use_covariance) / math.prod(a.shape[1:])
                contrib = w_eff * gram.mean(dim=0)
                static[l] = static[l] + contrib if l in static else contrib
                if cfg.video_style_factor > 0 and a.shape[0] == gfw > 1:
                    vg = w_eff * (video_gram(a, cfg.use_covariance) / a.numel())
                    dynamic[l] = dynamic[l] + vg if l in dynamic else vg
    return static, dynamic


def capture_temporal_targets(warp_image: torch.Tensor, warp_weights: torch.Tensor | None) -> dict[str, Any]:
    """Pixel-space temporal target (reference optim.py:35-47)."""
    t = {"target": warp_image.detach()}
    if warp_weights is not None:
        t["weights"] = warp_weights.detach()
    return t


# ---------------------------------------------------------------------------
# loss evaluation


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic L1 TV on NCHW (reference loss.py:229-233)."""
    dh = x[:, :, 1:, :] - x[:, :, :-1, :]
    dw = x[:, :, :, 1:] - x[:, :, :, :-1]
    return torch.sum(torch.abs(dh)) + torch.sum(torch.abs(dw))


def evaluate_losses(
    pastiche: torch.Tensor,
    acts: dict[str, torch.Tensor],
    targets: dict[str, Any],
    cfg: LossConfig,
    strength_scale: dict[str, float] | None = None,
    grams: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Total loss + per-loss values (ordering = cfg.loss_names()).

    ``strength_scale`` optionally rescales per-loss strengths
    (--normalize_weights, reference optim.py:176-178).  ``grams``: the
    style layers' normalised Grams of ``acts``, where the caller has them.
    """
    b = pastiche.shape[0]
    scale = strength_scale or {}
    zero = pastiche.new_zeros((), dtype=torch.float32)
    values = []

    content_targets = targets.get("content", {})
    for l in cfg.content_layers:
        strength = cfg.content_weight * scale.get(f"content:{l}", 1.0)
        v = zero
        if l in content_targets:
            tgt = content_targets[l]
            a = acts[l]
            for i in range(b):
                v = v + _term(_mse(a[i : i + 1], tgt), strength, b, cfg.normalize_gradients)
        values.append(v)

    style_targets = targets.get("style", {})
    video_targets = targets.get("style_video", {})
    for l in cfg.style_layers:
        strength = cfg.style_weight * scale.get(f"style:{l}", 1.0)
        v = zero
        a = acts[l]
        if l in style_targets:
            g = grams[l] if grams is not None else _norm_gram(a, cfg)  # (B, C, C)
            tgt = style_targets[l]
            for i in range(b):
                v = v + _term(_mse(g[i], tgt), strength, b, cfg.normalize_gradients)
        # the dynamic term, where the target is a window of b frames
        # (image styles are skipped, loss.py:165-166)
        if cfg.video_style_factor > 0 and l in video_targets and video_targets[l].shape[0] == b * a.shape[1]:
            vg = video_gram(a, cfg.use_covariance) / a.numel()
            v = v + cfg.video_style_factor * _term(_mse(vg, video_targets[l]), strength, b, cfg.normalize_gradients)
        values.append(v)

    if cfg.tv_weight > 0:
        values.append(cfg.tv_weight * tv_loss(pastiche))

    if cfg.temporal_weight > 0:
        strength = cfg.temporal_weight * scale.get("temporal", 1.0)
        v = zero
        temporal = targets.get("temporal")
        if temporal is not None:
            tgt = temporal["target"]
            w = temporal.get("weights")
            inp = pastiche * w if w is not None else pastiche
            for i in range(b):
                v = v + _term(_mse(inp[i : i + 1], tgt), strength, b, cfg.normalize_gradients)
        values.append(v)

    per = torch.stack(values)
    return per.sum(), per


def _norm_gram(a: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    return batch_gram(a, cfg.use_covariance) / math.prod(a.shape[1:])


def evaluate_frame_losses(
    pastiche: torch.Tensor,
    acts: dict[str, torch.Tensor],
    targets: dict[str, Any],
    cfg: LossConfig,
    strength_scale: dict[str, float] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Independent frames stacked on the batch axis, each with its own
    content (and temporal) target and one shared style target: frame i's
    values are ``evaluate_losses`` of frame i alone (its terms' gradients
    normalised on their own), and each style layer's Grams are one
    ``batch_gram`` over the stack.  Returns (sum over frames, (B, n_losses))."""
    grams = {l: _norm_gram(acts[l], cfg) for l in cfg.style_layers if l in targets.get("style", {})}
    totals, pers = [], []
    for i in range(pastiche.shape[0]):
        one = dict(targets)
        one["content"] = {l: t[i : i + 1] for l, t in targets.get("content", {}).items()}
        if targets.get("temporal") is not None:
            one["temporal"] = {k: t[i : i + 1] for k, t in targets["temporal"].items()}
        total, per = evaluate_losses(pastiche[i : i + 1], {l: a[i : i + 1] for l, a in acts.items()}, one, cfg,
                                     strength_scale, {l: g[i : i + 1] for l, g in grams.items()})
        totals.append(total)
        pers.append(per)
    return torch.stack(totals).sum(), torch.stack(pers)


__all__ = [
    "LossConfig",
    "scale_gradients",
    "tv_loss",
    "capture_content_targets",
    "capture_style_targets",
    "capture_style_video_targets",
    "capture_temporal_targets",
    "evaluate_losses",
    "evaluate_frame_losses",
]
