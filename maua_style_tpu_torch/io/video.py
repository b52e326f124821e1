"""Video IO (JAX counterpart: maua_style_tpu/io/video.py; reference:
load.py:35-43, 65-69, 103-137).

Read: a directory of frames, a ``.npy`` / ``.npz`` stack, a ``.gif``
through PIL, or any other video through ffmpeg's raw rgb24 pipe where the
binary exists.  Write (``save_video``): an ``.mp4`` through ffmpeg where it
exists, else a sibling directory of numbered PNGs plus a ``.npy`` stack of
the RGB frames (both resume-compatible).  vid_img's muxer is
``pipelines/vid_img_mux.mux_video``.  Frames are (T, H, W, 3) float32 BGR
mean-subtracted, the space of images.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess

import numpy as np
from PIL import Image

from .image import CAFFE_MEAN, IMAGE_EXTENSIONS, preprocess

VIDEO_EXTENSIONS = (".mp4", ".gif", ".mov", ".avi", ".webm", ".mkv")


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


def preprocess_video(video_path: str, fps: float | None = None) -> np.ndarray:
    """Video -> (T, H, W, 3) float32 BGR mean-subtracted (reference
    load.py:35-43); an image (or "random") falls back to ``preprocess``,
    one frame, as the reference's KeyError handler does (load.py:41-43)."""
    if isinstance(video_path, str) and (
        video_path == "random" or os.path.splitext(video_path)[1].lower() in IMAGE_EXTENSIONS
    ):
        return preprocess(video_path)
    rgb = read_video_rgb(video_path, fps)
    return rgb[..., ::-1] - CAFFE_MEAN


def save_video(frames, path: str, fps: float = 24, ffmpeg_args: dict | None = None) -> str:
    """(T, H, W, 3) BGR mean-subtracted -> ``path`` (.mp4) through ffmpeg,
    or ``{stem}_frames/00001.png...`` plus ``{stem}.npy`` without it.
    Returns the file written."""
    frames = np.asarray(frames, np.float32)
    rgb = np.clip((frames + CAFFE_MEAN)[..., ::-1], 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if ffmpeg_available():
        _, h, w, _ = rgb.shape
        cmd = ["ffmpeg", "-y", "-v", "error", "-f", "rawvideo", "-pix_fmt", "rgb24",
               "-s", f"{w}x{h}", "-r", f"{fps}", "-i", "-"]
        ffargs = dict(ffmpeg_args or {})
        ffargs.pop("framerate", None)
        codec = ffargs.pop("vcodec", ffargs.pop("codec", "libx264"))
        cmd += ["-c:v", str(codec)]
        for k, v in ffargs.items():
            cmd += [f"-{k}", str(v)]
        cmd += ["-pix_fmt", "yuv420p", path]
        subprocess.run(cmd, input=rgb.tobytes(), check=True)
        return path
    stem = os.path.splitext(path)[0]
    frame_dir = stem + "_frames"
    os.makedirs(frame_dir, exist_ok=True)
    for i, frame in enumerate(rgb):
        Image.fromarray(frame).save(os.path.join(frame_dir, f"{i + 1:05d}.png"))
    np.save(stem + ".npy", rgb)
    return stem + ".npy"


def process_style_videos(args) -> list[np.ndarray]:
    """Style video arguments -> preprocessed (T, H, W, 3) stacks, with
    ``args.style_blend_weights`` normalised to sum to 1 (reference
    load.py:103-137).  A directory without images expands to the videos in
    it; a directory of images is one video."""
    inputs = args.style.split(",") if isinstance(args.style, str) else list(args.style)
    video_list: list[str] = []
    for v in inputs:
        if os.path.isdir(v) and not any(os.path.splitext(f)[1].lower() in IMAGE_EXTENSIONS for f in os.listdir(v)):
            video_list.extend(
                v + "/" + f for f in sorted(os.listdir(v)) if os.path.splitext(f)[1].lower() in VIDEO_EXTENSIONS
            )
        else:
            video_list.append(v)
    videos = [preprocess_video(p, getattr(args, "fps", None)) for p in video_list]

    weights = getattr(args, "style_blend_weights", None)
    if not weights:
        weights = [1.0] * len(video_list)
    elif isinstance(weights, str):
        weights = [float(x) for x in weights.split(",")]
    if len(weights) != len(video_list):
        raise ValueError("-style_blend_weights and -style must have the same number of elements!")
    total = sum(weights)
    args.style_blend_weights = [w / total for w in weights]
    return videos


__all__ = ["VIDEO_EXTENSIONS", "read_video_rgb", "ffmpeg_available", "preprocess_video", "save_video",
           "process_style_videos"]
