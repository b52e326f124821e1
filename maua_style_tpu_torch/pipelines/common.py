"""Shared pipeline helpers: engine construction, per-scale model swapping
(JAX counterpart: maua_style_tpu/pipelines/common.py)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import trace
from ..config import set_model_args
from ..engine import StyleEngine
from ..losses import LossConfig
from ..models import load_params, select_model
from ..ops.resize import resize_bilinear_np
from ..parallel import pastiche_sharding_for


def loss_config_from_args(args) -> LossConfig:
    return LossConfig(
        content_layers=tuple(str(args.content_layers).split(",")) if args.content_weight > 0 else (),
        style_layers=tuple(str(args.style_layers).split(",")),
        content_weight=float(args.content_weight),
        style_weight=float(args.style_weight),
        tv_weight=float(args.tv_weight),
        temporal_weight=float(args.temporal_weight),
        use_covariance=bool(args.use_covariance),
        normalize_gradients=bool(getattr(args, "normalize_gradients", True)),
        video_style_factor=float(args.video_style_factor) if "_vid" in args.transfer_type else 0.0,
    )


def build_engine(args, current_size: int | None = None) -> StyleEngine:
    """A StyleEngine for the current scale, after the scaling-table model
    swap (reference optim.py:93-108 + models.load_model), on the mesh of
    ``--gpu`` / ``--mesh`` (``parallel.pastiche_sharding_for``; None on one
    device)."""
    with trace.span("engine.build"):
        if current_size is not None:
            set_model_args(args, current_size)
        spec = select_model(str(args.model_file).lower(), args.pooling)
        with trace.span("weights.load"):
            params = load_params(spec, str(args.model_file), strict=not args.disable_check,
                                 allow_random=getattr(args, "allow_random_weights", None) or None)
        bf16 = str(getattr(args, "compute_dtype", "float32")) in ("bfloat16", "bf16")
        sharding = pastiche_sharding_for(args)
        return StyleEngine(
            spec,
            params,
            loss_config_from_args(args),
            optimizer=args.optimizer,
            learning_rate=float(args.learning_rate),
            lbfgs_history=int(args.lbfgs_num_correction),
            lbfgs_method=getattr(args, "lbfgs_method", "compact"),
            precision=getattr(args, "precision", "highest"),
            normalize_weights=bool(args.normalize_weights),
            compute_dtype=torch.bfloat16 if bf16 else torch.float32,
            device=args.device,
            mesh=sharding.mesh if sharding is not None else None,
        )


def scale_styles(style_images: list[np.ndarray], content_shape, style_scale: float) -> list:
    """Rescale styles so each style's area ≈ content area * style_scale²
    (reference style.py:44-50)."""
    content_area = content_shape[1] * content_shape[2]
    out = []
    for img in style_images:
        factor = math.sqrt(content_area / (img.shape[1] * img.shape[2])) * style_scale
        out.append(resize_bilinear_np(np.asarray(img), scale_factor=factor))
    return out


__all__ = ["loss_config_from_args", "build_engine", "scale_styles"]
