"""Frame warping and video muxing for the video pipelines (JAX counterpart:
maua_style_tpu/pipelines/vid_img_mux.py)."""

from __future__ import annotations

import glob
import shutil
import subprocess

import numpy as np
import torch
from PIL import Image

from ..engine.optimize import to_nchw, to_nhwc
from ..ops.warp import grid_sample
from ..utils import name


def warp(pastiche: np.ndarray, warp_map: np.ndarray, device) -> np.ndarray:
    """(1, H, W, 3) host pastiche warped through a (1, h, w, 2) host grid on
    ``device`` -> (1, h, w, 3) host array."""
    grid = torch.as_tensor(np.asarray(warp_map, np.float32)).to(device)
    return to_nhwc(grid_sample(to_nchw(pastiche, device), grid))


def mux_video(output_dir: str, size: int, args) -> None:
    """Assemble the last pass's frames into ``{work}_{size}.mp4`` with
    ffmpeg (reference style.py:302-304), or into a ``.npy`` stack of the RGB
    frames where there is no ffmpeg."""
    pattern = f"{output_dir}/{size}/{args.passes_per_scale}_%05d.png"
    out = f"{output_dir}/{name(output_dir)}_{size}.mp4"
    if shutil.which("ffmpeg"):
        ffargs = []
        for k, v in (args.ffmpeg or {}).items():
            ffargs += [f"-{k}", str(v)]
        subprocess.run(["ffmpeg", "-y", "-v", "error", "-i", pattern, *ffargs, out], check=False)
    else:
        files = sorted(glob.glob(f"{output_dir}/{size}/{args.passes_per_scale}_*.png"))
        if files:
            frames = []
            for f in files:
                with Image.open(f) as img:
                    frames.append(np.asarray(img.convert("RGB")))
            np.save(out.replace(".mp4", ".npy"), np.stack(frames))


__all__ = ["warp", "mux_video"]
