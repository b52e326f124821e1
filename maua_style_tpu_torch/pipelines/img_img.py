"""Multi-resolution image->image style transfer (JAX counterpart:
maua_style_tpu/pipelines/img_img.py; reference: style.py:22-73).

Per scale: resume from {output}_{size}.png if present, rescale content and
styles, init the pastiche (random*0.001 / content / file), histogram-match,
optimise, save.  Each scale may swap model/optimizer via the scaling table.
``--fuse_scales`` runs the remaining pyramid on one engine with each
scale's tail kept on the device (``_fused_pyramid``), or falls back to the
per-scale loop where the request needs it.
"""

from __future__ import annotations

import copy
import os

import numpy as np

from .. import io as mio
from .. import trace
from ..config import set_model_args
from ..ops.frame_ops import style_hist_stats
from ..ops.histogram import match_histogram
from ..ops.resize import resize_bilinear_np
from .common import build_engine, scale_styles


def img_img(args) -> np.ndarray | None:
    style_images_big = mio.process_style_images(args)
    content_image_big = mio.preprocess(args.content)
    with trace.span("pipeline.match_histogram"):
        content_image_big = match_histogram(content_image_big, style_images_big, mode=args.match_histograms)
    content_size = content_image_big.shape[1:3]

    if args.init not in ("content", "random"):
        pastiche = mio.preprocess(args.init)
    else:
        pastiche = None

    if getattr(args, "fuse_scales", False):
        fused = _fused_pyramid(args, content_image_big, style_images_big, content_size, pastiche)
        if fused is not None:
            return fused

    for current_size, num_iters in zip(args.image_sizes, args.num_iters):
        with trace.span("pipeline.scale", size=int(current_size)):
            print(f"\nCurrent size {current_size}px")
            if os.path.exists(f"{args.output}_{current_size}.png"):
                pastiche = mio.preprocess(f"{args.output}_{current_size}.png")
                continue

            with trace.span("pipeline.resize"):
                content_image = resize_bilinear_np(content_image_big, scale_factor=current_size / max(*content_size))
                style_images = scale_styles(style_images_big, content_image.shape, args.style_scale)
            pastiche = _init(args, pastiche, content_image_big, style_images_big, content_image.shape[1:3])

            engine = build_engine(args, current_size)

            def save_snapshot(arr, iteration):
                mio.save_tensor_to_file(arr, args, iteration=iteration, size=current_size)

            output_image = engine.optimize(
                content_image,
                style_images,
                pastiche,
                num_iters,
                transfer_type="img_img",
                blend_weights=args.style_blend_weights,
                save_iter=args.save_iter,
                save_callback=save_snapshot if args.save_iter > 0 else None,
                run_checkpoint=(f"{args.output}_{current_size}_runstate" if getattr(args, "checkpoint_every", 0)
                                else None),
                checkpoint_every=getattr(args, "checkpoint_every", 0),
                profile_dir=getattr(args, "profile_dir", None),
                print_iter=args.print_iter if args.verbose else 0,
            )

            with trace.span("pipeline.match_histogram"):
                pastiche = match_histogram(output_image, style_images_big, mode=args.match_histograms)
            mio.save_tensor_to_file(pastiche, args, size=current_size)

    return pastiche


def _init(args, pastiche, content_image_big, style_images_big, hw) -> np.ndarray:
    """A scale's init: at the first scale the random draw, the content or
    ``--init``'s image, else the previous scale's result; resized to
    ``hw`` and histogram-matched."""
    h, w = hw
    with trace.span("pipeline.resize"):
        if args.init == "random" and pastiche is None:
            pastiche = np.random.randn(1, h, w, 3).astype(np.float32) * 0.001
        elif args.init == "content" and pastiche is None:
            pastiche = resize_bilinear_np(content_image_big, size=(h, w))
        else:
            pastiche = resize_bilinear_np(np.asarray(pastiche), size=(h, w))
    with trace.span("pipeline.match_histogram"):
        return match_histogram(pastiche, style_images_big, mode=args.match_histograms)


def _fused_pyramid(args, content_image_big, style_images_big, content_size, pastiche) -> np.ndarray | None:
    """--fuse_scales (JAX pipelines/img_img.py:81-157): the remaining pyramid
    through one engine's ``optimize_pyramid``, every scale's artifact
    written after the last scale.  Returns None where the request needs
    the per-scale loop (per-iteration snapshots, run-state checkpoints, a
    profile, multi-style histogram matching, a scale's artifact behind a
    missing one, settings the scaling table swaps between scales), after
    printing why."""

    def fallback(reason: str):
        print(f"Warning: --fuse_scales unavailable ({reason}); using the per-scale loop.")
        return None

    if args.save_iter > 0:
        return fallback("--save_iter writes per-iteration snapshots")
    if getattr(args, "checkpoint_every", 0):
        return fallback("--checkpoint_every needs per-chunk run-state saves")
    if getattr(args, "profile_dir", None):
        return fallback("--profile_dir traces one chunk at a time")
    if args.match_histograms and len(style_images_big) != 1:
        return fallback("multi-style histogram matching is host-only")

    # resume: consume the leading scales that have artifacts, as the loop's
    # per-scale `continue`; an artifact behind a missing one is the loop's
    # to resume from (JAX recomputes and overwrites it)
    todo = list(zip(args.image_sizes, args.num_iters))
    while todo and os.path.exists(f"{args.output}_{todo[0][0]}.png"):
        pastiche = mio.preprocess(f"{args.output}_{todo[0][0]}.png")
        todo.pop(0)
    if not todo:
        return pastiche
    if any(os.path.exists(f"{args.output}_{size}.png") for size, _ in todo):
        return fallback("a later scale's artifact exists behind a missing one")

    # the scaling table may swap the model or the optimiser per scale, which
    # one engine cannot span: compare every setting but the devices
    views = []
    for size, _ in todo:
        view = copy.copy(args)
        view.__dict__ = dict(args.__dict__)
        set_model_args(view, size)
        views.append({k: v for k, v in view.__dict__.items() if k != "devices"})
    if not all(_same_settings(views[0], v) for v in views[1:]):
        return fallback("the scaling table swaps settings across these scales")

    schedule, contents_per_scale, styles_per_scale = [], [], []
    with trace.span("pipeline.resize"):
        for size, num_iters in todo:
            content_image = resize_bilinear_np(content_image_big, scale_factor=size / max(*content_size))
            contents_per_scale.append(content_image)
            schedule.append((content_image.shape[1:3], num_iters))
            styles_per_scale.append(scale_styles(style_images_big, content_image.shape, args.style_scale))

    pastiche = _init(args, pastiche, content_image_big, style_images_big, schedule[0][0])
    hist_stats = style_hist_stats(style_images_big[0], mode="avg") if args.match_histograms else None

    engine = build_engine(args, todo[0][0])
    print(f"\nFused pyramid: {len(todo)} scale(s) {[size for size, _ in todo]} in one program")
    outs = engine.optimize_pyramid(contents_per_scale, styles_per_scale, pastiche, schedule,
                                   blend_weights=args.style_blend_weights, hist_stats=hist_stats)
    for (size, _), out in zip(todo, outs):
        mio.save_tensor_to_file(out, args, size=size)
    return outs[-1]


def _same_settings(a: dict, b: dict) -> bool:
    """Whether two per-scale views of the settings are equal; a value whose
    ``==`` does not give one bool (an array from a scaling-table JSON)
    counts as different."""
    if a.keys() != b.keys():
        return False
    for k in a:
        try:
            same = a[k] == b[k]
            if not isinstance(same, (bool, np.bool_)) or not same:
                return False
        except (ValueError, TypeError):  # a list of arrays: its == asks an array for one bool
            return False
    return True


__all__ = ["img_img"]
