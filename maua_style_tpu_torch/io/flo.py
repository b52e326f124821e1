"""Middlebury .flo optical-flow files and the host warp map (JAX
counterpart: maua_style_tpu/io/flo.py; reference: load.py:191-231).  The
bytes of a written file equal the JAX package's."""

from __future__ import annotations

import numpy as np
import torch

FLO_MAGIC = 202021.25


def read_flo(filename: str) -> np.ndarray:
    """Read a Middlebury .flo file -> (H, W, 2) float32 (u, v) in pixels."""
    with open(filename, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if len(magic) == 0 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"Magic number incorrect. Invalid .flo file: {filename}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        flow = np.fromfile(f, np.float32, count=2 * w * h)
    return np.resize(flow, (h, w, 2))


def write_flo(flow: np.ndarray, filename: str) -> None:
    """Write (H, W, 2) float32 flow as Middlebury .flo (reference load.py:221-231)."""
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(filename, "wb") as f:
        np.array([FLO_MAGIC], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.tofile(f)


def flow_warp_map(filename_or_flow, current_size: tuple[int, int], smooth_sigma: float = 5.0) -> np.ndarray:
    """.flo (or raw flow array) -> (1, H, W, 2) host grid in [-1, 1]: the
    CPU run of ``ops.frame_ops.warp_map_from_flow`` (normalise by (W, H),
    gaussian sigma 5, identity grid, bilinear resize)."""
    from ..ops.frame_ops import warp_map_from_flow

    flow = read_flo(filename_or_flow) if isinstance(filename_or_flow, str) else np.asarray(filename_or_flow)
    return warp_map_from_flow(torch.from_numpy(np.array(flow, np.float32)), tuple(current_size), smooth_sigma).numpy()


def reliable_flow_weighting(filename: str) -> np.ndarray:
    """Load a reliability PNG -> (1, H, W, 1) float32 in [0, 1]
    (reference load.py:217-218)."""
    from PIL import Image

    with Image.open(filename) as img:
        arr = np.asarray(img.convert("L"), np.float32) / 255.0
    return arr[None, :, :, None]


__all__ = ["read_flo", "write_flo", "flow_warp_map", "reliable_flow_weighting"]
