"""Image IO + Caffe-VGG preprocessing (JAX counterpart:
maua_style_tpu/io/image.py; reference: load.py:15-100).

Host arrays are (1, H, W, 3) float32, BGR, mean-subtracted — the JAX
package's layout, so both packages' artifacts compare byte for byte.  PNG
for images; the vid_img frames are PNGs too, and its video is muxed by
pipelines/vid_img_mux.  A (T > 1)-frame tensor saves through
``io/video.save_video``.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from .. import trace

Image.MAX_IMAGE_PIXELS = 1000000000  # gigapixel support (reference load.py:15)

CAFFE_MEAN = np.array([103.939, 116.779, 123.68], dtype=np.float32)  # B, G, R
IMAGE_EXTENSIONS = (".png", ".jpeg", ".jpg", ".tiff")


def _fetch(path_or_url: str):
    """Open a local path or an http(s) URL for reading (reference
    utils.py:70-73)."""
    if str(path_or_url).startswith(("http://", "https://")):
        import urllib.request

        return urllib.request.urlopen(path_or_url)
    return open(path_or_url, "rb")


def preprocess(image_path, size: tuple[int, int] | None = None) -> np.ndarray:
    """Load an image -> (1, H, W, 3) float32 BGR mean-subtracted.

    The string "random" yields a min-max-normalised gaussian noise image
    (reference load.py:22-25); an ndarray input (H, W, 3) in [0, 255] RGB is
    preprocessed directly; a path may be an http(s) URL.
    """
    with trace.span("pipeline.load"):
        if isinstance(image_path, str) and image_path == "random":
            image = np.random.normal(size=(256, 256, 3)).astype(np.float32)
            image -= image.min()
            image /= image.max()
            rgb = image * 255.0
        elif isinstance(image_path, np.ndarray):
            rgb = np.asarray(image_path, np.float32)
        else:
            with _fetch(str(image_path)) as f, Image.open(f) as img:
                pil = img.convert("RGB")
            if size is not None:
                pil = pil.resize((size[1], size[0]), Image.BILINEAR)
            rgb = np.asarray(pil, np.float32)
        bgr = rgb[..., ::-1] - CAFFE_MEAN
        return bgr[None]


def load_u8(image_path) -> np.ndarray:
    """Load an image as raw (H, W, 3) uint8 RGB, the per-frame transfer
    format of the vid_img frame path (ops/frame_ops); a path may be an
    http(s) URL."""
    with _fetch(str(image_path)) as f, Image.open(f) as img:
        return np.asarray(img.convert("RGB"))


def deprocess(tensor: np.ndarray) -> Image.Image:
    """(1, H, W, 3) or (H, W, 3) BGR mean-subtracted -> PIL RGB image
    (reference load.py:47-52)."""
    arr = np.asarray(tensor, np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    rgb = (arr + CAFFE_MEAN)[..., ::-1] / 255.0
    rgb = np.clip(rgb, 0.0, 1.0)
    return Image.fromarray((rgb * 255.0 + 0.5).astype(np.uint8))


def save_image(tensor: np.ndarray, filename: str, content_path: str | None = None, original_colors_flag: bool = False):
    img = deprocess(tensor)
    if original_colors_flag and content_path is not None:
        from ..ops.colors import original_colors

        img = original_colors(deprocess(preprocess(content_path)), img)
    os.makedirs(os.path.dirname(os.path.abspath(filename)) or ".", exist_ok=True)
    img.save(filename)


def save_tensor_to_file(tensor: np.ndarray, args, iteration=None, size=None, filename=None) -> str:
    """Save with the reference's filename schema (reference load.py:55-74):
    {output}[_{size}[_{iteration}]].png, or .mp4 for a video (T > 1 frames;
    see ``video.save_video`` for its fallback without ffmpeg)."""
    if filename is None:
        if size is None:
            filename = f"{args.output}"
        elif iteration is None:
            filename = f"{args.output}_{size}"
        else:
            filename = f"{args.output}_{size}_{iteration}"
    tensor = np.asarray(tensor)
    with trace.span("pipeline.save"):
        if tensor.shape[0] > 1:
            from .video import save_video

            out = f"{filename}.mp4"
            save_video(tensor, out, fps=getattr(args, "fps", 24), ffmpeg_args=getattr(args, "ffmpeg", None))
            return out
        out = f"{filename}.png"
        save_image(
            tensor,
            out,
            content_path=getattr(args, "content", None),
            original_colors_flag=bool(getattr(args, "original_colors", False)),
        )
        return out


def process_style_images(args) -> list[np.ndarray]:
    """Expand style args (paths / dirs) into preprocessed images (reference
    load.py:77-92).  Each input's blend weight splits equally among the
    images a directory expands to, then the whole vector renormalises."""
    style_list: list[str] = []
    weights_in = list(getattr(args, "style_blend_weights", None) or [1.0] * len(args.style))
    expanded_weights: list[float] = []
    for image, w in zip(args.style, weights_in):
        if os.path.isdir(image):
            members = [
                image + "/" + f
                for f in sorted(os.listdir(image))
                if os.path.splitext(f)[1].lower() in IMAGE_EXTENSIONS
            ]
            style_list.extend(members)
            expanded_weights.extend([w / max(len(members), 1)] * len(members))
        else:
            style_list.append(image)
            expanded_weights.append(w)
    total = sum(expanded_weights) or 1.0
    args.style_blend_weights = [w / total for w in expanded_weights]
    return [preprocess(p) for p in style_list]


__all__ = [
    "CAFFE_MEAN",
    "preprocess",
    "load_u8",
    "deprocess",
    "save_image",
    "save_tensor_to_file",
    "process_style_images",
]
