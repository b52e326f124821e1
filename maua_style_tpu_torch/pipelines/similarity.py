"""Dataset similarity batch pipeline (JAX counterpart:
maua_style_tpu/pipelines/similarity.py; reference: similarity.py).

Cached 64-bin RGB histograms of every image in a dataset, a chi² distance
matrix, each image's three nearest colour neighbours, optional neighbour
grids, then img_img style transfer of every image with each neighbour and
with each pair of its neighbours.  Paths are arguments instead of the
reference's hard-coded dataset folder (similarity.py:24-25).  The host
steps are numpy and PIL; every job is the port's img_img, on CUDA device 0
unless ``--gpu c`` asks for the CPU, and on the mesh of a preset's
``--gpu``/``--mesh`` (row bands on "space"), as JAX runs every job with the
preset's devices.

Usage: python -m maua_style_tpu_torch.pipelines.similarity DATASET_DIR [--args preset.json] [--grids] [--gpu c]
"""

from __future__ import annotations

import glob
import itertools
import os

import numpy as np
from PIL import Image

from ..utils import name

NUM_BINS = 64
TOP_N = 3


def compute_histograms(images: list[str], cache_path: str | None = None) -> np.ndarray:
    """(N, 3, 64) per-channel histograms / 3, cached to .npy (reference
    similarity.py:33-42)."""
    if cache_path and os.path.exists(cache_path):
        return np.load(cache_path)
    hists = np.zeros((len(images), 3, NUM_BINS))
    for i, img_file in enumerate(images):
        img = np.asarray(Image.open(img_file).convert("RGB"))
        for k in range(3):
            hists[i, k] = np.histogram(img[:, :, k], bins=NUM_BINS)[0] / 3
    if cache_path:
        np.save(cache_path, hists)
    return hists


def chi2_distance(hist_a: np.ndarray, hist_b: np.ndarray, eps: float = 1e-10) -> float:
    return 0.5 * np.sum((hist_a - hist_b) ** 2 / (hist_a + hist_b + eps))


def distance_matrix(hists: np.ndarray, cache_path: str | None = None) -> np.ndarray:
    """Pairwise chi² distances, cached to .npy; identical histograms get
    inf, so that an image is never its own neighbour (reference
    similarity.py:50-60, vectorised)."""
    if cache_path and os.path.exists(cache_path):
        return np.load(cache_path)
    flat = hists.reshape(len(hists), -1)
    a = flat[:, None, :]
    b = flat[None, :, :]
    dists = 0.5 * np.sum((a - b) ** 2 / (a + b + 1e-10), axis=-1)
    dists[np.all(a == b, axis=-1)] = np.inf
    if cache_path:
        np.save(cache_path, dists)
    return dists


def nearest_neighbors(images: list[str], dists: np.ndarray, top_n: int = TOP_N) -> list[list[str]]:
    best = np.argpartition(dists, top_n, axis=1)[:, :top_n]
    return [[images[j] for j in best[i]] for i in range(len(images))]


def generate_grids(images: list[str], closest: list[list[str]], out_dir: str) -> None:
    """3x3 neighbour contact sheets, 300 px cells (reference similarity.py:67-84)."""
    os.makedirs(out_dir, exist_ok=True)
    for ii in range(len(images)):
        grid = Image.new("RGB", (900, 900))
        im = Image.open(images[ii]).convert("RGB")
        im.thumbnail((300, 300))
        grid.paste(im, (0, 0))
        index = 0
        for i in range(300, 900, 300):
            for j in range(0, 900, 300):
                if index >= len(closest[ii]):
                    break
                im = Image.open(closest[ii][index]).convert("RGB")
                im.thumbnail((300, 300))
                grid.paste(im, (i, j))
                index += 1
        grid.save(os.path.join(out_dir, f"{name(images[ii])}.png"))


def run(dataset_dir: str, args, *, pattern: str = "*", grids: bool = False, dry_run: bool = False) -> list:
    """Histograms -> distances -> neighbours -> img_img on every pair and
    triple (reference similarity.py:91-98); returns the (content, styles)
    jobs.  ``args`` is set anew for each job and run through
    ``config.postprocess``."""
    from ..config import postprocess
    from .img_img import img_img

    images = sorted(
        p for p in glob.glob(os.path.join(dataset_dir, pattern))
        if os.path.splitext(p)[1].lower() in (".png", ".jpg", ".jpeg", ".tiff")
    )
    if not images:
        raise FileNotFoundError(f"no images matching {pattern} in {dataset_dir}")

    hists = compute_histograms(images, os.path.join(dataset_dir, "hists.npy"))
    dists = distance_matrix(hists, os.path.join(dataset_dir, "dists.npy"))
    closest = nearest_neighbors(images, dists, min(TOP_N, len(images) - 1))

    if grids:
        generate_grids(images, closest, os.path.join(dataset_dir, "grids"))

    jobs = []
    for ii, main_im in enumerate(images):
        for imfile in closest[ii]:
            jobs.append((main_im, [main_im, imfile]))
        for imfiles in itertools.combinations(closest[ii], 2):
            jobs.append((main_im, [main_im, *imfiles]))

    if dry_run:
        return jobs

    for content, styles in jobs:
        args.content = content
        args.style = styles
        args.style_blend_weights = None
        args = postprocess(args)
        args.output = f"{args.output_dir}/{name(content)}_{'_'.join(name(s) for s in styles)}"
        img_img(args)
    return jobs


def main(argv=None):
    import argparse

    from .. import config

    ap = argparse.ArgumentParser("similarity")
    ap.add_argument("dataset_dir")
    ap.add_argument("--args", dest="args_file", default=None, help="full args preset JSON")
    ap.add_argument("--grids", action="store_true")
    ap.add_argument("--output_dir", default="./output")
    ap.add_argument("--image_sizes", default="256,512")
    ap.add_argument("--num_iters", default="300,200")
    ap.add_argument("--gpu", default=None, help="CUDA device id (default 0, or the preset's), or 'c' for the CPU")
    a = ap.parse_args(argv)

    if a.args_file:
        args = config.load_args(a.args_file, **({"gpu": a.gpu} if a.gpu is not None else {}))
    else:
        args = config.get_args(
            ["--content", "placeholder.png", "--style", "placeholder.png", "--output_dir", a.output_dir,
             "--image_sizes", a.image_sizes, "--num_iters", a.num_iters, "--gpu", a.gpu or "0"]
        )
    run(a.dataset_dir, args, grids=a.grids)


if __name__ == "__main__":
    main()
