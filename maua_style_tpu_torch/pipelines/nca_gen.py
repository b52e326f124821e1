"""Neural-CA texture generation (JAX counterpart:
maua_style_tpu/pipelines/nca_gen.py; reference NCA_gen.py).

Three rollouts, each from ``models.nca.Draws(0)`` unless given draws:
1. ``evolution_video``: 600 frames from a zero seed, min(2**(k//30), 32)
   CA steps before frame k;
2. ``checkpoint_grid_video``: every checkpoint evolves its own column of one
   512-high grid (columns along the width, each with a 1-px halo);
3. ``text_video``: the update rate is a blurred rendered-text mask, with a
   fade-out after frame 400.

Frames go through ``io/video.save_video`` (an .mp4 through ffmpeg, else
PNG frames and an .npy stack).

Usage: python -m maua_style_tpu_torch.pipelines.nca_gen style.png out_dir/ [--text T] [--gpu c]
"""

from __future__ import annotations

import sys
from glob import glob

import numpy as np
import torch
from PIL import Image, ImageDraw, ImageFilter, ImageFont

from ..engine.optimize import resolve_device
from ..io.image import CAFFE_MEAN
from ..io.video import save_video
from ..models import nca
from ..utils import name


def _zoom(img: np.ndarray, scale: int = 2) -> np.ndarray:
    return np.repeat(np.repeat(img, scale, 0), scale, 1)


def _rgb(x: torch.Tensor) -> np.ndarray:
    """(1, C, H, W) state -> (H, W, 3) host RGB."""
    return nca.to_rgb(x)[0].permute(1, 2, 0).cpu().numpy()


def _write_video(frames01: list[np.ndarray], path: str, fps: float = 30.0):
    stack = np.stack([np.clip(f, 0, 1) * 255.0 for f in frames01])
    # save_video takes Caffe BGR, mean-subtracted; these are RGB in [0, 255]
    save_video(stack[..., ::-1] - CAFFE_MEAN, path, fps=fps)


@torch.no_grad()
def evolution_video(ca_params, out_path: str, num_frames: int = 600, size: int = 256, zoom: int = 2,
                    draws: nca.Draws | None = None):
    device = ca_params["w1"].device
    draws = nca.Draws(0, device) if draws is None else draws
    x = nca.seed_state(1, size, ca_params["w2"].shape[0], device=device)
    frames = []
    for k in range(num_frames):
        for _ in range(min(2 ** (k // 30), 32)):
            x = nca.ca_step(ca_params, x, draws.uniform((1, 1, size, size)))
        frames.append(_zoom(_rgb(x), zoom))
    _write_video(frames, out_path)


@torch.no_grad()
def checkpoint_grid_video(ckpt_paths: list[str], out_path: str, num_frames: int = 600, w: int = 128, device=None,
                          draws: nca.Draws | None = None):
    device = resolve_device(device)
    models = [nca.load_ca(p, device) for p in ckpt_paths]
    if not models:
        return
    chn = models[0]["w2"].shape[0]
    draws = nca.Draws(0, device) if draws is None else draws
    x = draws.uniform((1, chn, 512, w * len(models) + 2)) * 0.1
    frames = []
    for _ in range(num_frames):
        for _ in range(8):
            for ci, params in enumerate(models):
                out = nca.ca_step(params, x[..., ci * w : ci * w + w + 2], draws.uniform((1, 1, 512, w + 2)))
                x[..., ci * w + 1 : ci * w + w + 1] = out[..., 1:-1]
        frames.append(_zoom(_rgb(x), 2))
    _write_video(frames, out_path)


def text_mask(text: str = "WΛV", font_size: int = 256, pad: int = 64) -> np.ndarray:
    try:
        font = ImageFont.truetype("DejaVuSans.ttf", font_size)
    except OSError:
        font = ImageFont.load_default()
    bbox = ImageDraw.Draw(Image.new("L", (4, 4))).textbbox((0, 0), text, font=font)
    w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
    im = Image.new("L", (w + pad * 2, h + pad * 2))
    ImageDraw.Draw(im).text((pad - bbox[0], pad - bbox[1]), text, fill=255, font=font)
    im = im.filter(ImageFilter.GaussianBlur(5))
    p = np.float32(im)
    return p / p.max() * 0.6 + 0.05


@torch.no_grad()
def text_video(ca_params, out_path: str, text: str = "WΛV", num_frames: int = 600, draws: nca.Draws | None = None):
    device = ca_params["w1"].device
    p = text_mask(text)
    h, w = p.shape
    x = torch.zeros((1, ca_params["w2"].shape[0], h, w), device=device)
    rate = torch.as_tensor(p, device=device)
    draws = nca.Draws(0, device) if draws is None else draws
    frames = []
    for k in range(num_frames):
        for _ in range(min(int(2 ** (k / 30)), 32)):
            x = nca.ca_step(ca_params, x, draws.uniform((1, 1, h, w)), rate)
        frames.append(_zoom(_rgb(x) * min(1.0 - (k - 400) / 100, 1.0), 2))
    _write_video(frames, out_path)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    import argparse

    from ..config import single_device

    ap = argparse.ArgumentParser("nca_gen")
    ap.add_argument("style_file")
    ap.add_argument("out_dir")
    ap.add_argument("--num_frames", type=int, default=600)
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--text", type=str, default=None)
    ap.add_argument("--gpu", type=str, default="0", help="CUDA device id '0', or 'c' for the CPU")
    args = ap.parse_args(argv)
    device = single_device(args, "nca_gen", "JAX's CLI takes no device and runs on one")

    stem = name(args.style_file)
    ckpt = args.checkpoint or f"{args.out_dir}/{stem}_7500.npz"
    ca_params = nca.load_ca(ckpt, device)
    tag = name(ckpt).split("_")[-1]

    evolution_video(ca_params, f"{args.out_dir}/{stem}_{tag}.mp4", args.num_frames)
    ckpts = sorted(glob(f"{args.out_dir}/{stem}*.npz"))[2:-2]
    checkpoint_grid_video(ckpts, f"{args.out_dir}/{stem}_checkgrid.mp4", args.num_frames, device=device)
    if args.text:
        text_video(ca_params, f"{args.out_dir}/{stem}-{tag}-wav.mp4", args.text, args.num_frames)


if __name__ == "__main__":
    main()
