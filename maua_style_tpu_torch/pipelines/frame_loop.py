"""The multi-pass video frame scheduler (JAX counterpart:
maua_style_tpu/pipelines/frame_loop.py; reference: style.py:145-311).

Handles the per-scale skip when the next scale is complete, the per-pass
skip, loop rotation, alternating frame direction, per-frame artifact
resume, the pastiche init (random / prev_warp / content / the previous
pass's or scale's artifacts), flow-warped temporal targets and blending,
saving and muxing.  The per-scale set-up and the inner optimisation are
injected.

Two inner paths:

- **device chain** (vid_img): each frame is one ``StyleEngine.optimize_frame``
  call; the pastiche stays a tensor on the device from frame to frame, only
  uint8 images cross to the host, and PNGs are written by a background
  thread.  First-pass frames with a chain-free init go through
  ``optimize_frames``, one stacked step per chunk of frames; chained frames
  through ``optimize_frame_chain``.  The chunks are ``--frame_batch`` long,
  or else sized by the capacity model (``tuning.max_sizes``) for the
  scale, optimizer, dtype and device memory, as in the JAX package; the
  chained chunks only group the log lines.
- **host path** (``--original_colors``): per-frame host orchestration.
"""

from __future__ import annotations

import glob
import os
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

from .. import io as mio
from ..io.flo import flow_warp_map, read_flo, reliable_flow_weighting
from ..ops.histogram import match_histogram
from ..ops.resize import resize_bilinear_np, scale_shape
from ..utils import name
from .vid_img_mux import mux_video, warp


class _AsyncSaver:
    """Copies the device's u8 images to the host and writes the PNGs off
    the critical path."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=2)
        self._futures = []

    def submit(self, display_u8, out_path: str) -> None:
        def write():
            Image.fromarray(display_u8.cpu().numpy()).save(out_path)

        self._futures.append(self._pool.submit(write))

    def drain(self) -> None:
        for f in self._futures:
            f.result()  # surface write errors
        self._futures.clear()

    def close(self) -> None:
        self.drain()
        self._pool.shutdown()


def _capacity_kwargs(args) -> dict:
    """The engine configuration the capacity estimator needs, from the run
    args (JAX frame_loop.py:312-320), and the memory of the run's device."""
    from ..tuning.max_sizes import hbm_bytes

    return dict(
        lbfgs_history=int(getattr(args, "lbfgs_num_correction", 100) or 100),
        lbfgs_method=getattr(args, "lbfgs_method", "compact") or "compact",
        compute_dtype=getattr(args, "compute_dtype", "float32") or "float32",
        hbm=hbm_bytes(getattr(args, "device", None)),
    )


def _auto_frame_batch(out_hw: tuple[int, int], requested: int, args=None) -> int:
    """Frames per stacked step: the requested ``--frame_batch``, or the
    capacity model's answer for this scale, optimizer, dtype and device
    (``tuning.max_sizes.frames_per_program``), rounded down to a power of
    two (JAX frame_loop.py:323-339)."""
    if requested and requested > 0:
        b = requested
    else:
        from ..tuning.max_sizes import frames_per_program

        b = frames_per_program(
            getattr(args, "model_file", "vgg19") or "vgg19",
            getattr(args, "optimizer", "lbfgs") or "lbfgs",
            out_hw,
            **_capacity_kwargs(args),
        )
    return 1 << (b.bit_length() - 1)


def _auto_chain_k(out_hw: tuple[int, int], args) -> int:
    """Chained chunk length: the requested ``--frame_batch``, or the
    capacity model's stacked-inputs answer
    (``tuning.max_sizes.chain_frames_per_program``; JAX frame_loop.py:342-356)."""
    requested = getattr(args, "frame_batch", 0)
    if requested and requested > 0:
        return int(requested)
    from ..tuning.max_sizes import chain_frames_per_program

    return chain_frames_per_program(
        getattr(args, "model_file", "vgg19") or "vgg19",
        getattr(args, "optimizer", "lbfgs") or "lbfgs",
        out_hw,
        **_capacity_kwargs(args),
    )


def run_video_style_passes(
    args,
    output_dir: str,
    frames: list[str],
    style_images_big: list[np.ndarray],
    *,
    on_scale,
    optimize_frame,
    use_temporal_targets: bool,
    frame_engine=None,
    flow_ready=None,
) -> None:
    """Drive the (scale, pass, frame) loop.

    on_scale(current_size, style_images) -> scale context for optimize_frame.
    optimize_frame(ctx, content_frame, pastiche, temporal_target,
    temporal_weights, num_iters) -> stylised frame (host path).
    ``use_temporal_targets``: feed the flow-warped previous frame as a
    weighted temporal target.  ``frame_engine(ctx)``: the StyleEngine of the
    device chain, or None for the host path.  ``flow_ready``: the join
    handle of the overlapped flow pre-pass, called before the first pass
    that reads flow artifacts.
    """
    from .common import scale_styles

    content_size = mio.preprocess(frames[0]).shape[1:3]
    saver = _AsyncSaver()

    try:
        prev_size = args.image_sizes[0]
        for size_n, (current_size, num_iters) in enumerate(zip(args.image_sizes, args.num_iters)):
            next_size = args.image_sizes[min(len(args.image_sizes) - 1, size_n + 1)]
            if len(glob.glob(f"{output_dir}/{next_size}/*.png")) == len(frames):
                print(f"Skipping size: {current_size}, already done.")
                prev_size = current_size
                continue

            print(f"\nCurrent size {current_size}px")
            os.makedirs(f"{output_dir}/{current_size}", exist_ok=True)
            content_scale = current_size / max(*content_size)

            style_images = scale_styles(
                style_images_big,
                (1, int(content_scale * content_size[0]), int(content_scale * content_size[1])),
                args.style_scale,
            )
            # the engine is built when a frame first needs optimising, so
            # a fully resumed scale reads only the file system
            scale_state: dict = {}

            def get_ctx():
                if "ctx" not in scale_state:
                    scale_state["ctx"] = on_scale(current_size, style_images)
                return scale_state["ctx"]

            def get_engine():
                if "engine" not in scale_state:
                    scale_state["engine"] = frame_engine(get_ctx()) if frame_engine is not None else None
                return scale_state["engine"]

            device_chain = frame_engine is not None and not args.original_colors
            out_hw = scale_shape(content_size, content_scale)

            def get_hist_stats():
                if "hist" not in scale_state:
                    if device_chain and args.match_histograms:
                        from ..ops.frame_ops import style_hist_stats

                        scale_state["hist"] = style_hist_stats(style_images_big[0], mode=args.match_histograms)
                    else:
                        scale_state["hist"] = None
                return scale_state["hist"]

            for pass_n in range(args.passes_per_scale):
                # a pass reads flow when it warps (a prev_warp first pass) or
                # feeds warped temporal targets (every later pass)
                first_pass = size_n == 0 and pass_n == 0
                consumes_flow = (args.init == "prev_warp") if first_pass else use_temporal_targets
                if flow_ready is not None and consumes_flow:
                    flow_ready()
                pastiche = None  # the chain: a host array (host path) or a tensor (device chain)
                if args.loop:
                    start_idx = random.randrange(0, len(frames) - 1)
                    frames = frames[start_idx:] + frames[:start_idx]

                if len(glob.glob(f"{output_dir}/{current_size}/{pass_n + 2}_*.png")) == len(frames):
                    print(f"Skipping pass: {pass_n + 1}, already done.")
                    frames = list(reversed(frames))
                    continue

                # the first pass with a chain-free init: frames are
                # independent (reference style.py:219-231)
                if device_chain and first_pass and args.init != "prev_warp" and getattr(args, "frame_batch", 0) != 1:
                    _device_first_pass_batched(
                        args, get_engine(), style_images, get_hist_stats(), out_hw,
                        content_scale, output_dir, current_size, pass_n, frames,
                        num_iters, saver,
                    )
                    frames = list(reversed(frames))
                    saver.drain()
                    continue

                pairs = list(zip(
                    frames + frames[: 11 if args.loop else 1],
                    frames[1:] + frames[: 10 if args.loop else 1],
                ))
                chain_k = _auto_chain_k(out_hw, args)
                n = -1
                while n + 1 < len(pairs):
                    n += 1
                    prev_frame, this_frame = pairs[n]
                    out_path = f"{output_dir}/{current_size}/{pass_n + 1}_{name(this_frame)}.png"
                    if os.path.isfile(out_path) and not n >= len(frames):
                        pastiche = None  # resume skip: reseed the chain from artifacts
                        continue
                    flow_direction = "forward" if pass_n % 2 == 0 else "backward"
                    flo_file = f"{output_dir}/flow/{flow_direction}_{name(prev_frame)}_{name(this_frame)}.flo"
                    first = size_n == 0 and pass_n == 0

                    if device_chain:
                        # chain consecutive frames into one engine call (wrap
                        # frames, j >= len(frames), only with --loop, read
                        # artifacts of the current pass and stay per frame)
                        idxs = [n]
                        if chain_k > 1:
                            while (
                                len(idxs) < chain_k
                                and idxs[-1] + 1 < min(len(pairs), len(frames))
                                and not os.path.isfile(
                                    f"{output_dir}/{current_size}/{pass_n + 1}_{name(pairs[idxs[-1] + 1][1])}.png"
                                )
                            ):
                                idxs.append(idxs[-1] + 1)
                        if len(idxs) > 1:
                            names = ", ".join(name(pairs[j][1]) for j in idxs)
                            print(f"Optimizing... size: {current_size}, pass: {pass_n + 1}, frames: {names}")
                            pastiche = _device_chain_chunk(
                                args, get_engine(), style_images, get_hist_stats(), out_hw,
                                content_scale, output_dir, current_size, prev_size, pass_n,
                                idxs, pairs, flow_direction, first, use_temporal_targets,
                                num_iters, pastiche, saver,
                            )
                            n = idxs[-1]
                            continue
                        print(f"Optimizing... size: {current_size}, pass: {pass_n + 1}, frame: {name(this_frame)}")
                        pastiche = _device_frame(
                            args, get_engine(), style_images, get_hist_stats(), out_hw, content_scale,
                            output_dir, current_size, prev_size, pass_n, n, len(frames),
                            prev_frame, this_frame, flo_file, flow_direction, first,
                            use_temporal_targets, num_iters, pastiche, saver, out_path,
                        )
                        continue
                    print(f"Optimizing... size: {current_size}, pass: {pass_n + 1}, frame: {name(this_frame)}")
                    pastiche = _host_frame(
                        args, get_ctx(), optimize_frame, style_images_big, content_scale, output_dir,
                        current_size, prev_size, pass_n, n, len(frames), prev_frame, this_frame, flo_file,
                        flow_direction, first, use_temporal_targets, num_iters, pastiche, out_path,
                    )

                frames = list(reversed(frames))
                saver.drain()  # artifacts must exist before resume checks and the mux

            saver.drain()
            mux_video(output_dir, current_size, args)
            prev_size = current_size
        if flow_ready is not None:
            flow_ready()  # the flow artifacts are complete when the run returns
    finally:
        saver.close()


def _src_size_pass(args, pass_n, n, n_frames, current_size, prev_size) -> tuple[int, int]:
    """Scale and pass of the artifacts a later pass blends from: the
    previous scale's last pass on pass 0, the previous pass otherwise (the
    current pass for --loop wrap frames)."""
    if pass_n == 0:
        return (prev_size, args.passes_per_scale) if n <= n_frames else (current_size, pass_n + 1)
    return current_size, (pass_n if n <= n_frames else pass_n + 1)


def _host_frame(
    args, ctx, optimize_frame, style_images_big, content_scale, output_dir, current_size, prev_size,
    pass_n, n, n_frames, prev_frame, this_frame, flo_file, flow_direction, first,
    use_temporal_targets, num_iters, pastiche, out_path,
):
    """One frame through host arrays (reference style.py:192-297); returns
    the host pastiche that chains to the next frame."""
    content_frames = [
        resize_bilinear_np(mio.preprocess(prev_frame), scale_factor=content_scale),
        resize_bilinear_np(mio.preprocess(this_frame), scale_factor=content_scale),
    ]
    content_frames = [match_histogram(f, style_images_big[0], mode=args.match_histograms) for f in content_frames]

    temporal_target = None
    temporal_weights = None
    if first:
        if args.init == "random":
            pastiche = np.random.randn(*content_frames[1].shape).astype(np.float32) * 0.001
        elif args.init == "prev_warp":
            if pastiche is None:
                pastiche = content_frames[0]
            pastiche = warp(pastiche, flow_warp_map(flo_file, pastiche.shape[1:3]), args.device)
        else:
            pastiche = content_frames[1].copy()
    else:
        src_size, src_pass = _src_size_pass(args, pass_n, n, n_frames, current_size, prev_size)
        if pastiche is None:
            ifile = f"{output_dir}/{src_size}/{src_pass}_{name(prev_frame)}.png"
            pastiche = resize_bilinear_np(mio.preprocess(ifile), size=content_frames[0].shape[1:3])
        bfile = f"{output_dir}/{src_size}/{src_pass}_{name(this_frame)}.png"
        blend_image = resize_bilinear_np(mio.preprocess(bfile), size=content_frames[0].shape[1:3])

        if use_temporal_targets:
            # (prev frame, warp map): the engine warps on the device
            temporal_target = (pastiche, flow_warp_map(flo_file, pastiche.shape[1:3]))
            weight_file = f"{output_dir}/flow/{flow_direction}_{name(prev_frame)}_{name(this_frame)}.png"
            temporal_weights = resize_bilinear_np(reliable_flow_weighting(weight_file), size=pastiche.shape[1:3])

        pastiche = (1 - args.temporal_blend) * blend_image + args.temporal_blend * pastiche

    output_image = optimize_frame(
        ctx, content_frames[1], pastiche, temporal_target, temporal_weights, max(num_iters // args.passes_per_scale, 1)
    )

    pastiche = match_histogram(output_image, style_images_big[0], mode=args.match_histograms)
    if pastiche.shape != content_frames[1].shape:
        pastiche = resize_bilinear_np(pastiche, size=content_frames[1].shape[1:3])

    disp = mio.deprocess(pastiche)
    if args.original_colors:
        from ..ops.colors import original_colors

        disp = original_colors(mio.deprocess(content_frames[1]), disp)
    disp.save(out_path)
    return pastiche


def _device_first_pass_batched(
    args, engine, style_images, hist_stats, out_hw, content_scale,
    output_dir, current_size, pass_n, frames, num_iters, saver,
):
    """Every unrendered frame of the first pass through
    ``engine.optimize_frames``, one stacked step per chunk (JAX
    frame_loop.py:359-412); per-frame random-init seeds are the sequential
    loop's ``seed + n``."""
    n_frames = len(frames)
    this_frames = frames[1:] + frames[: 10 if args.loop else 1]
    todo: dict[str, tuple[int, str]] = {}
    for n, this_frame in enumerate(this_frames):
        out_path = f"{output_dir}/{current_size}/{pass_n + 1}_{name(this_frame)}.png"
        if os.path.isfile(out_path) and not n >= n_frames:
            continue
        # --loop wrap re-optimises early frames; keep the last occurrence
        # per artifact (concurrent PNG writes to one path would race)
        todo[out_path] = (n, this_frame)

    items = sorted(todo.items(), key=lambda kv: kv[1][0])
    # JAX multiplies the auto batch by a "frames" mesh axis here; that waits
    # for multi-GPU runs (ROADMAP item 18)
    batch = _auto_frame_batch(out_hw, getattr(args, "frame_batch", 0), args)
    iters = max(num_iters // args.passes_per_scale, 1)
    seed0 = int(getattr(args, "seed", 0) or 0)
    init_mode = "random" if args.init == "random" else "content"

    pos = 0
    while pos < len(items):
        chunk_size = min(batch, len(items) - pos)
        chunk_size = 1 << (chunk_size.bit_length() - 1)  # power-of-two chunks, as JAX's
        chunk = items[pos : pos + chunk_size]
        pos += chunk_size
        names = ", ".join(name(tf) for _, (_, tf) in chunk)
        print(f"Optimizing... size: {current_size}, pass: {pass_n + 1}, frames: {names}")
        stack = np.stack([mio.load_u8(tf) for _, (_, tf) in chunk])
        _, displays = engine.optimize_frames(
            stack, style_images, iters,
            out_hw=out_hw,
            content_scale=content_scale,
            blend_weights=args.style_blend_weights,
            init_mode=init_mode,
            hist_stats=hist_stats,
            seeds=[seed0 + n for _, (n, _) in chunk],
        )
        for i, (out_path, _) in enumerate(chunk):
            saver.submit(displays[i], out_path)


def _chain_seed(engine, saver, output_dir, current_size, pass_n, prev_frame, out_hw, hist_stats, first, src_size, src_pass):
    """The chain tensor that feeds a chunk's first frame: a prev_warp pass
    warps this pass's artifact of the previous frame (or its preprocessed
    content); a later pass starts from the source pass's artifact."""
    if first:
        saver.drain()  # the previous frame's artifact may still be queued
        prev_art = f"{output_dir}/{current_size}/{pass_n + 1}_{name(prev_frame)}.png"
        if os.path.isfile(prev_art):
            return resize_bilinear_np(mio.preprocess(prev_art), size=out_hw)
        return engine.prep_frame(mio.load_u8(prev_frame), out_hw, hist_stats)
    return resize_bilinear_np(mio.preprocess(f"{output_dir}/{src_size}/{src_pass}_{name(prev_frame)}.png"), size=out_hw)


def _device_chain_chunk(
    args, engine, style_images, hist_stats, out_hw, content_scale,
    output_dir, current_size, prev_size, pass_n, idxs, pairs,
    flow_direction, first, use_temporal_targets, num_iters, chain, saver,
):
    """K consecutive frames through ``engine.optimize_frame_chain``, with
    ``_device_frame``'s init/blend/temporal semantics for the two chained
    modes (a prev_warp first pass, reference style.py:223-228; a later
    pass's blend and warped temporal target, style.py:232-286)."""
    iters = max(num_iters // args.passes_per_scale, 1)
    seed0 = int(getattr(args, "seed", 0) or 0)
    src_size = prev_size if pass_n == 0 else current_size
    src_pass = args.passes_per_scale if pass_n == 0 else pass_n

    contents, blends, flows, weights, out_paths, seeds = [], [], [], [], [], []
    for j in idxs:
        p_frame, t_frame = pairs[j]
        out_paths.append(f"{output_dir}/{current_size}/{pass_n + 1}_{name(t_frame)}.png")
        contents.append(mio.load_u8(t_frame))
        seeds.append(seed0 + j)
        flo = f"{output_dir}/flow/{flow_direction}_{name(p_frame)}_{name(t_frame)}.flo"
        if first:  # prev_warp: init = warp(chain), no temporal target
            flows.append(read_flo(flo))
        else:
            blends.append(mio.load_u8(f"{output_dir}/{src_size}/{src_pass}_{name(t_frame)}.png"))
            if use_temporal_targets:
                flows.append(read_flo(flo))
                with Image.open(f"{output_dir}/flow/{flow_direction}_{name(p_frame)}_{name(t_frame)}.png") as img:
                    weights.append(np.asarray(img.convert("L")))

    if chain is None:
        chain = _chain_seed(engine, saver, output_dir, current_size, pass_n, pairs[idxs[0]][0], out_hw,
                            hist_stats, first, src_size, src_pass)

    stacked = {"content_u8": np.stack(contents)}
    if first:
        mode, use_temp = "warp_prev", False
        stacked["flow"] = np.stack(flows).astype(np.float32)
    else:
        mode, use_temp = "blend", bool(use_temporal_targets)
        stacked["blend"] = np.stack(blends)
        if use_temporal_targets:
            stacked["flow"] = np.stack(flows).astype(np.float32)
            stacked["weights_u8"] = np.stack(weights)

    chain, displays = engine.optimize_frame_chain(
        chain, stacked, style_images, iters,
        out_hw=out_hw,
        content_scale=content_scale,
        blend_weights=args.style_blend_weights,
        init_mode=mode,
        use_temporal=use_temp,
        temporal_blend=float(args.temporal_blend),
        hist_stats=hist_stats,
        seeds=seeds,
    )
    for i, op in enumerate(out_paths):
        saver.submit(displays[i], op)
    return chain


def _device_frame(
    args, engine, style_images, hist_stats, out_hw, content_scale,
    output_dir, current_size, prev_size, pass_n, n, n_frames,
    prev_frame, this_frame, flo_file, flow_direction, first,
    use_temporal_targets, num_iters, chain, saver, out_path,
):
    """One frame through ``engine.optimize_frame``; returns the new chain
    tensor (the host path's init/blend/temporal semantics, reference
    style.py:192-297)."""
    kwargs: dict = {}
    if first:
        if args.init == "random":
            mode = "random"
            kwargs["seed"] = int(getattr(args, "seed", 0) or 0) + n
        elif args.init == "prev_warp":
            mode = "warp_prev"
            kwargs["flow"] = read_flo(flo_file)
            if chain is None:
                chain = _chain_seed(engine, saver, output_dir, current_size, pass_n, prev_frame, out_hw,
                                    hist_stats, True, None, None)
            kwargs["prev"] = chain
        else:
            mode = "content"
    else:
        src_size, src_pass = _src_size_pass(args, pass_n, n, n_frames, current_size, prev_size)
        if src_size == current_size and src_pass == pass_n + 1:
            saver.drain()  # loop-wrap reads artifacts of the current pass
        if chain is None:
            chain = _chain_seed(engine, saver, output_dir, current_size, pass_n, prev_frame, out_hw,
                                hist_stats, False, src_size, src_pass)
        mode = "blend"
        kwargs["prev"] = chain
        kwargs["blend"] = mio.load_u8(f"{output_dir}/{src_size}/{src_pass}_{name(this_frame)}.png")
        kwargs["temporal_blend"] = float(args.temporal_blend)
        if use_temporal_targets:
            kwargs["flow"] = read_flo(flo_file)
            weight_file = f"{output_dir}/flow/{flow_direction}_{name(prev_frame)}_{name(this_frame)}.png"
            with Image.open(weight_file) as img:
                kwargs["weights_u8"] = np.asarray(img.convert("L"))
            kwargs["use_temporal"] = True

    pastiche, display = engine.optimize_frame(
        mio.load_u8(this_frame),
        style_images,
        max(num_iters // args.passes_per_scale, 1),
        out_hw=out_hw,
        blend_weights=args.style_blend_weights,
        init_mode=mode,
        hist_stats=hist_stats,
        content_scale=content_scale,
        **kwargs,
    )
    saver.submit(display, out_path)
    return pastiche


__all__ = ["run_video_style_passes"]
