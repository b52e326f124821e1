"""Gram / covariance matrices for style statistics (JAX counterparts:
maua_style_tpu/ops/gram.py ``batch_gram`` / ``gram_matrix``, and the
Pallas kernel maua_style_tpu/ops/pallas_gram.py).

Activations are NCHW, so a frame's feature matrix F is the (C, H*W) view
with H*W contiguous and the Gram is G = F Fᵀ, f32 even for bf16 inputs.

- ``gram(f)``: (B, C, N) -> (B, C, C).  On a CUDA tensor it launches the
  hand-written kernel ``csrc/gram.cu`` or raises; on a CPU tensor it uses
  ``gram_reference``, the plain PyTorch version.  ``gram.launches`` counts
  kernel launches.
- ``_GramFn``: autograd around ``gram`` with the symmetric backward
  dL/dF = (Ḡ + Ḡᵀ) F — one (C, C) x (C, N) product, as the JAX package's
  custom VJP (ops/gram.py:65-72).  The backward is a plain matrix product
  outside any kernel, as in the JAX package.
- ``batch_gram``: (B, C, H, W) -> (B, C, C), with covariance centering in
  plain torch around the Function.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build

_TILE = 64  # output tile edge of csrc/gram.cu
_TK = 32  # N-depth of one stage of csrc/gram.cu
_MIN_SPLIT = 256  # fewest N positions one block sums


def gram_reference(f: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, C, N) -> (B, C, C) f32, G = F Fᵀ."""
    f32 = f.float()
    return torch.bmm(f32, f32.transpose(1, 2))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _gram_lib() -> ctypes.CDLL:
    lib = build.load("gram")
    lib.gram_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.gram_forward.restype = ctypes.c_int
    return lib


def gram_splits(batch: int, channels: int, n: int, sm_count: int) -> tuple[int, int, int]:
    """(pairs, splits, chunk): upper-triangular 64x64 output tiles, and how N
    is cut so that batch * pairs * splits blocks fill about four waves of
    ``sm_count`` SMs, each block summing ``chunk`` positions (a multiple of
    the stage depth)."""
    tiles = _cdiv(channels, _TILE)
    pairs = tiles * (tiles + 1) // 2
    splits = max(1, min(_cdiv(4 * sm_count, batch * pairs), n // _MIN_SPLIT))
    chunk = _cdiv(_cdiv(n, splits), _TK) * _TK
    return pairs, _cdiv(n, chunk), chunk


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gram(f: torch.Tensor) -> torch.Tensor:
    """(B, C, N) -> (B, C, C) f32 Gram; the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if f.device.type == "cpu":
        return gram_reference(f)
    if f.device.type != "cuda":
        raise ValueError(f"gram: unsupported device {f.device}")
    if f.dim() != 3:
        raise ValueError(f"gram: expected a (B, C, N) tensor, got shape {tuple(f.shape)}")
    if f.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gram: expected float32 or bfloat16, got {f.dtype}")
    if not f.is_contiguous():
        raise ValueError("gram: the (B, C, N) view must be contiguous")
    b, c, n = f.shape
    if b < 1 or c < 1 or n < 1:
        raise ValueError(f"gram: empty input of shape {tuple(f.shape)}")
    pairs, splits, chunk = gram_splits(b, c, n, _sm_count(f.device.index))
    partial = torch.empty((splits, b, pairs, _TILE, _TILE), dtype=torch.float32, device=f.device)
    out = torch.empty((b, c, c), dtype=torch.float32, device=f.device)
    lib = _gram_lib()
    with torch.cuda.device(f.device):
        rc = lib.gram_forward(
            f.data_ptr(), int(f.dtype == torch.bfloat16), b, c, n, splits, chunk,
            partial.data_ptr(), out.data_ptr(), torch.cuda.current_stream(f.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gram kernel launch failed with CUDA error {rc}")
    gram.launches += 1
    return out


gram.launches = 0


class _GramFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f):
        ctx.save_for_backward(f)
        return gram(f)

    @staticmethod
    def backward(ctx, gbar):
        (f,) = ctx.saved_tensors
        sym = (gbar + gbar.transpose(1, 2)).to(f.dtype)  # (B, C, C)
        return torch.matmul(sym, f)


def batch_gram(x: torch.Tensor, use_covariance: bool = False) -> torch.Tensor:
    """Per-frame Grams: (B, C, H, W) -> (B, C, C) float32."""
    f = x.reshape(x.shape[0], x.shape[1], -1)
    if use_covariance:
        f = f - f.mean(dim=2, keepdim=True)
    return _GramFn.apply(f)


def gram_matrix(x: torch.Tensor, use_covariance: bool = False) -> torch.Tensor:
    """Gram of a single frame: (C, H, W) or (1, C, H, W) -> (C, C)
    (without the /nelement normalisation; callers divide)."""
    if x.dim() == 3:
        x = x[None]
    return batch_gram(x, use_covariance)[0]


__all__ = ["gram", "gram_reference", "gram_splits", "batch_gram", "gram_matrix"]
