"""Video as style ("dynamic textures"): stylise a content image with the
motion statistics of style videos (JAX counterpart:
maua_style_tpu/pipelines/img_vid.py; reference: style.py:76-142).

A T-frame pastiche is optimised in circular Gram frame windows, sized per
scale by the --gram_frame_window schedule (``StyleEngine.optimize`` with
``transfer_type="img_vid"``).  Between scales the video is rotated by 7
frames and blended over time with a gaussian, to hide the window seams, as
the reference does.  The host steps and their np.random draws are the JAX
package's, so a seeded run starts from the same pastiche.  Unlike the JAX
pipeline, this one also honours --save_iter, --checkpoint_every,
--print_iter and --profile_dir, as img_img does.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.ndimage as ndi

from .. import io as mio
from ..ops.histogram import match_histogram
from ..ops.resize import resize_bilinear_np
from .common import build_engine, scale_styles


def _resume_path(base: str) -> str | None:
    for ext in (".mp4", ".npy"):
        if os.path.exists(base + ext):
            return base + ext
    return None


def img_vid(args) -> np.ndarray:
    style_videos_big = mio.process_style_videos(args)
    content_image_big = match_histogram(mio.preprocess(args.content), style_videos_big, mode=args.match_histograms)

    video_length = max(v.shape[0] for v in style_videos_big) if args.num_frames == -1 else args.num_frames
    delta_ts = str(args.gram_frame_window).split(",")

    h, w = content_size = content_image_big.shape[1:3]
    if args.init == "random":
        pastiche = np.random.randn(video_length, h, w, 3).astype(np.float32) * 255
        pastiche = ndi.gaussian_filter(pastiche, [video_length, h / 32, w / 32, 0], mode="wrap")
    elif args.init == "content":
        pastiche = np.repeat(content_image_big, video_length, axis=0).astype(np.float32)
        pastiche += np.random.randn(video_length, h, w, 3).astype(np.float32) * 255
        pastiche = ndi.gaussian_filter(pastiche, [video_length, 4, 4, 0], mode="wrap")
    else:
        pastiche = mio.preprocess_video(args.init, args.fps)
        pastiche = np.tile(pastiche, (int(np.ceil(video_length / pastiche.shape[0])), 1, 1, 1))[:video_length]
    pastiche = match_histogram(pastiche, style_videos_big, mode=args.match_histograms)

    for i, (current_size, num_iters) in enumerate(zip(args.image_sizes, args.num_iters)):
        resume = _resume_path(f"{args.output}_{current_size}")
        if resume is not None:
            pastiche = mio.preprocess_video(resume, args.fps)
            continue
        print(f"\nCurrent size {current_size}px")
        gram_frame_window = int(delta_ts[min(i, len(delta_ts) - 1)])

        content_image = resize_bilinear_np(content_image_big, scale_factor=current_size / max(*content_size))
        style_videos = scale_styles(style_videos_big, content_image.shape, args.style_scale)
        pastiche = resize_bilinear_np(pastiche, size=content_image.shape[1:3])

        engine = build_engine(args, current_size)

        def save_snapshot(arr, iteration, current_size=current_size):
            mio.save_tensor_to_file(arr, args, iteration=iteration, size=current_size)

        pastiche = engine.optimize(
            content_image,
            style_videos,
            pastiche,
            num_iters,
            transfer_type="img_vid",
            blend_weights=args.style_blend_weights,
            gram_frame_window=gram_frame_window,
            avg_frame_window=args.avg_frame_window,
            save_iter=args.save_iter,
            save_callback=save_snapshot if args.save_iter > 0 else None,
            run_checkpoint=f"{args.output}_{current_size}_runstate" if getattr(args, "checkpoint_every", 0) else None,
            checkpoint_every=getattr(args, "checkpoint_every", 0),
            profile_dir=getattr(args, "profile_dir", None),
            print_iter=args.print_iter if args.verbose else 0,
        )

        # rotate 7 frames between scales so that the window seams move (style.py:134-135)
        pastiche = np.concatenate([pastiche[7:], pastiche[:7]])
        style_videos_big = [np.concatenate([v[7:], v[:7]]) for v in style_videos_big]

        if args.temporal_blend > 0:
            pastiche = ndi.gaussian_filter(pastiche, [args.temporal_blend, 0, 0, 0], mode="wrap")
        pastiche = match_histogram(pastiche, style_videos_big, mode=args.match_histograms)
        mio.save_tensor_to_file(pastiche, args, filename=f"{args.output}_{current_size}")

    mio.save_tensor_to_file(match_histogram(pastiche, style_videos_big, mode=args.match_histograms), args)
    return pastiche


__all__ = ["img_vid"]
