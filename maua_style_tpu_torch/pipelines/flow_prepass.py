"""Video flow pre-pass: extract frames, compute and cache forward/backward
flow and reliability maps (JAX counterpart:
maua_style_tpu/pipelines/flow_prepass.py; reference: load.py:141-188).

Artifacts (the reference's schema, so runs resume across crashes):
    {output_dir}/{content}_{styles}/frames/%05d.png
    {output_dir}/{content}_{styles}/flow/forward_{a}_{b}.flo  (+ .png reliability)
    {output_dir}/{content}_{styles}/flow/backward_{b}_{a}.flo (+ .png)

Frame extraction uses ffmpeg when available; otherwise the content may be a
frame directory, .gif, or .npy/.npz stack (io/video.py).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading

import numpy as np
import torch
from PIL import Image

from .. import flow as flowmod
from ..io.flo import write_flo
from ..io.video import read_video_rgb
from ..utils import name

PAIR_CHUNK = 8  # frame pairs per device call of the pair model


def extract_frames(content: str, frames_dir: str) -> None:
    os.makedirs(frames_dir, exist_ok=True)
    if len(os.listdir(frames_dir)) > 0:
        return
    if shutil.which("ffmpeg") and os.path.isfile(content) and not content.endswith((".npy", ".npz", ".gif")):
        subprocess.run(["ffmpeg", "-v", "error", "-i", content, os.path.join(frames_dir, "%05d.png")], check=True)
        return
    for i, frame in enumerate(read_video_rgb(content)):
        Image.fromarray(np.clip(frame, 0, 255).astype(np.uint8)).save(os.path.join(frames_dir, f"{i + 1:05d}.png"))


def work_dir(args) -> str:
    return args.output_dir + "/" + name(args.content) + "_" + "_".join(name(s) for s in args.style)


def _list_frames_and_missing(args) -> tuple[list[str], list[tuple[str, str]], str]:
    """Extract the frames and list the frame pairs whose flow artifacts
    are still missing."""
    frames_dir = work_dir(args) + "/frames/"
    flow_dir = work_dir(args) + "/flow/"
    os.makedirs(flow_dir, exist_ok=True)
    extract_frames(args.content, frames_dir)

    images = [frames_dir + f for f in sorted(os.listdir(frames_dir)) if f.endswith(".png") and "_" not in f]
    images.append(images[0])  # wrap-around pair for loopable videos
    missing = [
        (f1, f2)
        for f1, f2 in zip(images[:-1], images[1:])
        if not os.path.isfile(f"{flow_dir}/backward_{name(f2)}_{name(f1)}.png")
    ]
    images.pop(-1)
    return images, missing, flow_dir


def start_flow_prepass(args) -> tuple[list[str], "callable"]:
    """Extract the frames now and compute the flow in a background thread
    while the caller starts optimising (pass 1 reads no flow unless
    ``--init prev_warp``).  Returns ``(frames, join)``; ``join()`` waits for
    the thread and re-raises any error it met.  The thread holds
    ``torch.inference_mode()`` itself (grad mode is per thread) and its
    kernels launch on its own current stream."""
    images, missing, flow_dir = _list_frames_and_missing(args)
    if not missing:
        return images, lambda: None

    box: dict = {}

    def work():
        try:
            with torch.inference_mode():
                _compute_flow_pairs(flowmod.get_flow_pair_model(args), missing, flow_dir, args)
        except BaseException as e:  # noqa: BLE001 - re-raised by join()
            box["err"] = e

    # not a daemon: if the caller fails first, the interpreter waits for
    # the pre-pass to finish instead of killing it inside a device call
    t = threading.Thread(target=work, name="flow-prepass")
    t.start()

    def join():
        t.join()
        if "err" in box:
            raise box["err"]

    return images, join


def _compute_flow_pairs(model, missing, flow_dir, args) -> None:
    def write_pair(img_file1, img_file2, forward, backward, fwd_rel, bwd_rel):
        n1, n2 = name(img_file1), name(img_file2)
        write_flo(forward, f"{flow_dir}/forward_{n1}_{n2}.flo")
        write_flo(backward, f"{flow_dir}/backward_{n2}_{n1}.flo")
        if getattr(args, "no_check_occlusion", False):
            fwd_img = Image.fromarray(flowmod.flow_to_image(forward)).convert("L")
            bwd_img = Image.fromarray(flowmod.flow_to_image(backward)).convert("L")
        else:
            if fwd_rel is None:
                device = getattr(args, "device", None)
                fwd_rel = flowmod.check_consistency(forward, backward, device)
                bwd_rel = flowmod.check_consistency(backward, forward, device)
            fwd_img = Image.fromarray(((1 - fwd_rel) * 255).astype(np.uint8)).convert("L")
            bwd_img = Image.fromarray(((1 - bwd_rel) * 255).astype(np.uint8)).convert("L")
        fwd_img.save(f"{flow_dir}/forward_{n1}_{n2}.png")
        bwd_img.save(f"{flow_dir}/backward_{n2}_{n1}.png")
        if getattr(args, "verbose", False):
            print(f"processed optical flow: {n1} <---> {n2}")

    def load(f):
        with Image.open(f) as img:
            return np.array(img.convert("RGB"))

    batched = getattr(model, "batched", None)
    if batched is not None and len(missing) > 1:
        for i in range(0, len(missing), PAIR_CHUNK):
            chunk = missing[i : i + PAIR_CHUNK]
            # a short tail chunk repeats its last pair, as the JAX package
            # does to keep one batch shape
            padded = chunk + [chunk[-1]] * (PAIR_CHUNK - len(chunk))
            ims1 = np.stack([load(f1) for f1, _ in padded])
            ims2 = np.stack([load(f2) for _, f2 in padded])
            fwd, bwd, fr, br = batched(ims1, ims2)
            for k, (f1, f2) in enumerate(chunk):
                write_pair(f1, f2, fwd[k], bwd[k], fr[k], br[k])
    else:
        for img_file1, img_file2 in missing:
            im1, im2 = load(img_file1), load(img_file2)
            result = model(im1, im2)
            if isinstance(result, tuple):  # pair models return all four maps
                forward, backward, fwd_rel, bwd_rel = result
            else:
                forward, backward = result, model(im2, im1)
                fwd_rel = bwd_rel = None
            write_pair(img_file1, img_file2, forward, backward, fwd_rel, bwd_rel)


__all__ = ["start_flow_prepass", "extract_frames", "work_dir", "PAIR_CHUNK"]
