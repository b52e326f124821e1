"""CLIP-guided video styling (JAX counterpart:
maua_style_tpu/pipelines/clip_video_style.py; reference: clip_video_style.py):
the vid_img multi-pass, flow-warped frame loop (``pipelines/frame_loop.py``,
host path) with the CLIP + VQGAN engine as the inner optimiser.
``optimize_cached`` reuses the style and text targets across frames; they
are embedded again once a scale through ``update_styles`` (reference
clip_video_style.py:57-58).

The loop works in Caffe-BGR space (histogram matching, the artifact
files) and converts to RGB in [0, 1] at the engine's boundary.  The
reference feeds BGR-mean-subtracted tensors straight into the VQGAN
encoder (clip_video_style.py:168-181), which clamps them into a degenerate
range; the conversion is the JAX package's deliberate fix, kept here.  As
in the reference, the flow's reliability mask is not passed to the
optimiser (clip_video_style.py:164->173 computes it, then drops it).

Runs on CUDA device 0 unless ``--gpu c`` asks for the CPU.

Usage: python -m maua_style_tpu_torch.pipelines.clip_video_style --content video.mp4 \\
    --style s.png --style_text "a watercolor painting" --allow_random_weights [--gpu c]
"""

from __future__ import annotations

import numpy as np

from .. import io as mio
from ..config import single_device
from ..io.image import CAFFE_MEAN
from ..models.conv_plans import apply_precision
from .clip_vqgan import ONE_DEVICE, get_engine
from .flow_prepass import start_flow_prepass, work_dir
from .frame_loop import run_video_style_passes


def _bgr_to_rgb01(x: np.ndarray) -> np.ndarray:
    return np.clip((x + CAFFE_MEAN)[..., ::-1] / 255.0, 0.0, 1.0)


def _rgb01_to_bgr(x: np.ndarray) -> np.ndarray:
    return x[..., ::-1] * 255.0 - CAFFE_MEAN


def clip_video_style(args) -> None:
    single_device(args, "clip_video_style", ONE_DEVICE)
    # TF32 flags are process-wide: off before the pre-pass thread runs its
    # convolutions, as the engine keeps them
    apply_precision("highest")
    frames, flow_ready = start_flow_prepass(args)
    style_images_big = mio.process_style_images(args)
    engine = get_engine(args.vqgan_dir, args.clip_backbone, device=args.device)

    def on_scale(current_size, style_images):
        engine.target_embeds = engine.update_styles(
            [_bgr_to_rgb01(s) for s in style_images], args.content_text, args.style_text
        )
        return engine

    def optimize_frame(eng, content_frame, pastiche, temporal_target, temporal_weights, num_iters):
        out01 = eng.optimize_cached(
            init=_bgr_to_rgb01(pastiche),
            content=_bgr_to_rgb01(content_frame),
            styles=None,
            mask=None,
            content_text=args.content_text,
            style_text=args.style_text,
            content_weight=args.content_weight,
            style_weight=args.style_weight,
            text_weight=getattr(args, "text_weight", 1.0),
            iterations=num_iters,
        )
        return _rgb01_to_bgr(out01)

    run_video_style_passes(
        args, work_dir(args), frames, style_images_big,
        on_scale=on_scale, optimize_frame=optimize_frame, use_temporal_targets=False,
        flow_ready=flow_ready,
    )


def main(argv=None):
    from .. import config

    args = config.get_args(argv)
    if args.seed >= 0:
        np.random.seed(args.seed)
    clip_video_style(args)


if __name__ == "__main__":
    main()
