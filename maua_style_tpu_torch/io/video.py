"""Reading video content (JAX counterpart: maua_style_tpu/io/video.py;
reference: load.py:35-43).

Sources: a directory of frames, a ``.npy`` / ``.npz`` stack, a ``.gif``
through PIL, or any other video through ffmpeg's raw rgb24 pipe where the
binary exists.  Video writing is ``pipelines/vid_img_mux.mux_video``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess

import numpy as np
from PIL import Image

from .image import IMAGE_EXTENSIONS

def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _ffprobe_dims(path: str) -> tuple[int, int]:
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0", "-show_entries", "stream=width,height", "-of", "json", path],
        capture_output=True,
        check=True,
    )
    stream = json.loads(out.stdout)["streams"][0]
    return int(stream["width"]), int(stream["height"])


def _read_frames_ffmpeg(path: str, fps: float | None) -> np.ndarray:
    w, h = _ffprobe_dims(path)
    cmd = ["ffmpeg", "-v", "error", "-i", path]
    if fps:
        cmd += ["-r", f"{fps}"]
    cmd += ["-f", "rawvideo", "-pix_fmt", "rgb24", "-"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    n = len(raw) // (w * h * 3)
    return np.frombuffer(raw, np.uint8)[: n * w * h * 3].reshape(n, h, w, 3).astype(np.float32)


def _read_frames_pil_gif(path: str) -> np.ndarray:
    frames = []
    with Image.open(path) as img:
        try:
            while True:
                frames.append(np.asarray(img.convert("RGB"), np.float32))
                img.seek(img.tell() + 1)
        except EOFError:
            pass
    return np.stack(frames)


def read_video_rgb(path: str, fps: float | None = None) -> np.ndarray:
    """Read any supported source -> (T, H, W, 3) float32 RGB in [0, 255]."""
    if os.path.isdir(path):
        files = sorted(f for f in os.listdir(path) if os.path.splitext(f)[1].lower() in IMAGE_EXTENSIONS)
        if not files:
            raise FileNotFoundError(f"no frames in {path}")
        frames = []
        for f in files:
            with Image.open(os.path.join(path, f)) as img:
                frames.append(np.asarray(img.convert("RGB"), np.float32))
        return np.stack(frames)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path).astype(np.float32)
    if ext == ".npz":
        return np.load(path)["frames"].astype(np.float32)
    if ext == ".gif":
        return _read_frames_pil_gif(path)
    if ffmpeg_available():
        return _read_frames_ffmpeg(path, fps)
    raise RuntimeError(f"cannot read {path}: ffmpeg not available; provide a frame directory, .gif, or .npy/.npz stack")


__all__ = ["read_video_rgb", "ffmpeg_available"]
