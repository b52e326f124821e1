"""Video stylisation with flow-warped temporal coherence, the Ruder et al.
multi-pass loop (JAX counterpart: maua_style_tpu/pipelines/vid_img.py;
reference: style.py:145-311).

Per scale: the flow pre-pass's artifacts feed per-frame warped temporal
targets; ``--passes_per_scale`` passes alternate the frame direction; every
frame resumes from its PNG artifact ({output_dir}/{work}/{size}/{pass}_{frame}.png,
the reference's schema).  The flow pre-pass runs in a background thread
while pass 1 optimises; the (scale, pass, frame) scheduling is
pipelines/frame_loop.py.
"""

from __future__ import annotations

from .. import io as mio
from ..engine.optimize import apply_precision
from .common import build_engine
from .flow_prepass import start_flow_prepass, work_dir
from .frame_loop import run_video_style_passes


def vid_img(args) -> None:
    # TF32 flags are process-wide: set them before the pre-pass thread runs
    # its convolutions, not when the first engine is built
    apply_precision(getattr(args, "precision", "highest"))
    frames, flow_ready = start_flow_prepass(args)
    style_images_big = mio.process_style_images(args)

    def on_scale(current_size, style_images):
        return build_engine(args, current_size), style_images

    def optimize_frame(ctx, content_frame, pastiche, temporal_target, temporal_weights, num_iters):
        engine, style_images = ctx
        # temporal_target is (prev_frame, warp_map); the engine warps it on the device
        return engine.optimize(
            content_frame,
            style_images,
            pastiche,
            num_iters,
            transfer_type="vid_img",
            blend_weights=args.style_blend_weights,
            temporal_warp=temporal_target,
            temporal_weights=temporal_weights,
        )

    run_video_style_passes(
        args, work_dir(args), frames, style_images_big,
        on_scale=on_scale, optimize_frame=optimize_frame, use_temporal_targets=True,
        frame_engine=lambda ctx: ctx[0],
        flow_ready=flow_ready,
    )


__all__ = ["vid_img"]
