"""Multi-resolution image->image style transfer (JAX counterpart:
maua_style_tpu/pipelines/img_img.py; reference: style.py:22-73).

Per scale: resume from {output}_{size}.png if present, rescale content and
styles, init the pastiche (random*0.001 / content / file), histogram-match,
optimise, save.  Each scale may swap model/optimizer via the scaling table.
"""

from __future__ import annotations

import os

import numpy as np

from .. import io as mio
from ..ops.histogram import match_histogram
from ..ops.resize import resize_bilinear_np
from .common import build_engine, scale_styles


def img_img(args) -> np.ndarray | None:
    style_images_big = mio.process_style_images(args)
    content_image_big = match_histogram(mio.preprocess(args.content), style_images_big, mode=args.match_histograms)
    content_size = content_image_big.shape[1:3]

    if args.init not in ("content", "random"):
        pastiche = mio.preprocess(args.init)
    else:
        pastiche = None

    if getattr(args, "fuse_scales", False):
        # the fused pyramid only cuts TPU executable loads; nothing to cut here
        print("Warning: --fuse_scales is not ported (it saves TPU executable loads only); using the per-scale loop.")

    for current_size, num_iters in zip(args.image_sizes, args.num_iters):
        print(f"\nCurrent size {current_size}px")
        if os.path.exists(f"{args.output}_{current_size}.png"):
            pastiche = mio.preprocess(f"{args.output}_{current_size}.png")
            continue

        content_scale = current_size / max(*content_size)
        content_image = resize_bilinear_np(content_image_big, scale_factor=content_scale)
        style_images = scale_styles(style_images_big, content_image.shape, args.style_scale)

        h, w = content_image.shape[1:3]
        if args.init == "random" and pastiche is None:
            pastiche = np.random.randn(1, h, w, 3).astype(np.float32) * 0.001
        elif args.init == "content" and pastiche is None:
            pastiche = resize_bilinear_np(content_image_big, size=(h, w))
        else:
            pastiche = resize_bilinear_np(np.asarray(pastiche), size=(h, w))
        pastiche = match_histogram(pastiche, style_images_big, mode=args.match_histograms)

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
            run_checkpoint=f"{args.output}_{current_size}_runstate" if getattr(args, "checkpoint_every", 0) else None,
            checkpoint_every=getattr(args, "checkpoint_every", 0),
            profile_dir=getattr(args, "profile_dir", None),
            print_iter=args.print_iter if args.verbose else 0,
        )

        pastiche = match_histogram(output_image, style_images_big, mode=args.match_histograms)
        mio.save_tensor_to_file(pastiche, args, size=current_size)

    return pastiche


__all__ = ["img_img"]
