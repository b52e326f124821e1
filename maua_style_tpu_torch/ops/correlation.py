"""Cost-volume correlation (JAX counterparts: maua_style_tpu/ops/correlation.py
``correlation_xla``, the oracle, and ``_corr_kernel`` / ``correlation_pallas``,
the TPU kernel).

    out[b, k, h, w] = sum_c f1[b, c, h, w] * f2[b, c, h + dy_k - d, w + dx_k - d] / C

for the (2d/s + 1)² displacements k = iy·n + ix (dy = iy·s outer, dx = ix·s
inner), with f2 zero outside the frame.  Inputs are NCHW; the output is
(B, K, H, W) float32.  Flow nets run inference only, so there is no
backward.

- ``correlation(f1, f2, max_disp, stride)``: on CUDA tensors it launches the
  hand-written kernel ``csrc/correlation.cu`` on the current stream or
  raises; on CPU tensors it takes ``correlation_reference``.
  ``correlation.launches`` counts kernel launches.
- ``correlation_reference``: the plain version, a loop over the K shifted
  products.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..kernels import build

_SMEM_BUDGET = 112 * 1024  # bytes of staging per block: two blocks fit an SM


def correlation_reference(f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 4, stride: int = 1) -> torch.Tensor:
    """Plain version: (B, C, H, W) x2 -> (B, K, H, W), float32 (float64
    for float64 inputs)."""
    b, c, h, w = f1.shape
    d = max_disp
    dtype = torch.promote_types(f1.dtype, torch.float32)
    f1 = f1.to(dtype)
    f2p = F.pad(f2.to(dtype), (d, d, d, d))
    outs = []
    for dy in range(0, 2 * d + 1, stride):
        for dx in range(0, 2 * d + 1, stride):
            outs.append((f1 * f2p[:, :, dy : dy + h, dx : dx + w]).sum(1))
    return torch.stack(outs, 1) / c


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("correlation")
    lib.correlation_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.correlation_forward.restype = ctypes.c_int
    return lib


def channel_chunk(max_disp: int, channels: int) -> int:
    """Channels the kernel stages per chunk: as many as fit the budget
    (at most 32), at least one.  Per channel it stages f1's 8 x 32 tile and
    f2's (8 + 2d) x (32 + 2d) halo window."""
    per_channel = 4 * (8 * 32 + (8 + 2 * max_disp) * (32 + 2 * max_disp))
    return max(1, min(32, channels, _SMEM_BUDGET // per_channel))


def correlation(f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 4, stride: int = 1) -> torch.Tensor:
    """(B, C, H, W) x2 -> (B, K, H, W) float32 cost volume; the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if max_disp < 0 or stride < 1 or (2 * max_disp) % stride:
        raise ValueError(f"correlation: 2 * max_disp ({max_disp}) must be a multiple of stride ({stride})")
    if f1.device.type == "cpu" and f2.device.type == "cpu":
        return correlation_reference(f1, f2, max_disp, stride)
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(f"correlation: both inputs must be on one CUDA device, got {f1.device} and {f2.device}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"correlation: expected two (B, C, H, W) tensors of one shape, got {tuple(f1.shape)}, {tuple(f2.shape)}")
    if f1.dtype != torch.float32 or f2.dtype != torch.float32:
        raise TypeError(f"correlation: expected float32, got {f1.dtype} and {f2.dtype}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("correlation: inputs must be contiguous NCHW")
    b, c, h, w = f1.shape
    if min(b, c, h, w) < 1:
        raise ValueError(f"correlation: empty input of shape {tuple(f1.shape)}")
    n = 2 * max_disp // stride + 1
    out = torch.empty((b, n * n, h, w), dtype=torch.float32, device=f1.device)
    lib = _lib()
    with torch.cuda.device(f1.device):
        rc = lib.correlation_forward(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w, max_disp, stride,
            channel_chunk(max_disp, c), torch.cuda.current_stream(f1.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"correlation kernel launch failed with CUDA error {rc}")
    correlation.launches += 1
    return out


correlation.launches = 0

__all__ = ["correlation", "correlation_reference", "channel_chunk"]
