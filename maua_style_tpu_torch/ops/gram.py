"""Gram / covariance matrices for style statistics (JAX counterparts:
maua_style_tpu/ops/gram.py ``batch_gram`` / ``gram_matrix``, and the
Pallas kernel maua_style_tpu/ops/pallas_gram.py).

Activations are NCHW, so a frame's feature matrix F is the (C, H*W) view
with H*W contiguous and the Gram is G = F Fᵀ, f32 even for bf16 inputs.

- ``gram(f)``: (B, C, N) -> (B, C, C).  On a CUDA tensor it launches the
  hand-written kernel ``csrc/gram.cu`` or raises; on a CPU tensor it uses
  ``gram_reference``, the plain PyTorch version.  The counter
  ``gram.launches`` (``trace.counter``) counts kernel launches.
- ``_GramFn``: autograd around ``gram`` with the symmetric backward
  dL/dF = (Ḡ + Ḡᵀ) F — one (C, C) x (C, N) product, as the JAX package's
  custom VJP (ops/gram.py:65-72).  The backward is a plain matrix product
  outside any kernel, as in the JAX package.
- ``batch_gram``: (B, C, H, W) -> (B, C, C), with covariance centering in
  plain torch around the Function.
- ``banded_gram``: the per-frame Grams of a stack cut into row bands on
  several devices (``parallel/spatial.py``), one kernel launch per band.
- ``video_gram``: the whole-window ("dynamic texture") Gram of img_vid,
  (T, C, H, W) -> (T·C, T·C): ``batch_gram`` of the (1, T·C, H, W) view,
  so it runs the same kernel.
- The whole-window Gram of a window laid out on a mesh
  (``parallel.window_shares``, ``parallel/spatial.py``):
  ``banded_video_gram`` of one share's row bands (K1 per band on its
  (1, T·C, hᵢ·W) view, summed), and ``video_gram_blocks`` /
  ``shared_video_gram`` of shares of frames: the diagonal block of each
  share is its ``banded_video_gram``, and each block FᵢFⱼᵀ above it a plain
  ``torch.matmul`` on share i's device after copying Fⱼ there (JAX computes
  ``video_gram`` as a ``dot_general`` outside any Pallas kernel,
  ops/gram.py:96-104); the block below is its transpose.
  On a "tensor" axis a share of frames is further cut by channel share
  into groups whose rows are not contiguous in the window's frame-major
  order: the same blocks, of the rows permuted into group order.
- ``channel_gram``: the per-frame Grams of a stack whose channels are cut
  into shares (the "tensor" axis, ``parallel.channel_shares``), each share
  in row bands: K1 on each band of each diagonal block over the stack,
  batched plain products off the diagonal (JAX's default Gram is a
  ``dot_general``, losses.py:42, 70-75).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import trace
from ..kernels import build
from ..parallel.spatial import sum_on

_STAGE = 64  # N positions of a bf16 stage of csrc/gram.cu, two f32 stages
_MIN_SPLIT = 256  # fewest N positions one block sums
_RESIDENT = {64: 2, 128: 1}  # blocks an SM holds, by tile edge (112 and 160 KB of shared memory each)
_FILL = 2  # a block's pipeline fill and epilogue, in stages of _STAGE positions


_PLAIN_CHUNK = 1 << 16  # N positions one product of the plain version sums


def gram_reference(f: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, C, N) -> (B, C, C) f32, G = F Fᵀ, one product per
    chunk of 2^16 positions, the chunks' products added.  cuBLAS's batched
    f32 kernels sum N in order, and one such sum drifts from the exact
    Gram by ≈ u·sqrt(N/3) (on an H100: 2.2e-5 of max|G| at (8, 64, 147456),
    and 1.0e-4 from the kernel's Gram at (8, 64, 589824)); in chunks it
    stays within ≈ 1e-6 at any N."""
    f32 = f.float()
    out = None
    for i in range(0, max(f32.shape[2], 1), _PLAIN_CHUNK):
        part = f32[:, :, i : i + _PLAIN_CHUNK]
        g = torch.bmm(part, part.transpose(1, 2))
        out = g if out is None else out + g
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _gram_lib() -> ctypes.CDLL:
    lib = build.load("gram")
    lib.gram_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.gram_forward.restype = ctypes.c_int
    return lib


class GramSplits(NamedTuple):
    """How csrc/gram.cu cuts the work: ``tile``-edge output tiles, ``pairs``
    of them on and above the diagonal, and for a diagonal and for an
    off-diagonal pair the splits of N and the positions each sums (a whole
    number of stages).  One block per (pair, split, frame)."""

    tile: int
    pairs: int
    splits_diag: int
    chunk_diag: int
    splits_off: int
    chunk_off: int


@functools.lru_cache(maxsize=None)
def gram_splits(batch: int, channels: int, n: int, sm_count: int, bf16: bool = False) -> GramSplits:
    """The tile is 64 for C <= 64, else 128.  For f32 a diagonal pair's
    block does about 2/3 of an off-diagonal one's work per position (two
    TF32 products and one operand staged, against three, two and the
    operand's split), so its chunk is 1.5 times as long; for bf16 equal
    chunks were faster on the card.  Of the cuts that fill one to four waves
    of the blocks that ``sm_count`` SMs hold at once, the one with the
    fewest waves x (a block's work in stages + pipeline fill)."""
    tile = 64 if channels <= 64 else 128
    tiles = _cdiv(channels, tile)
    pairs = tiles * (tiles + 1) // 2
    off = pairs - tiles
    ratio = 1.0 if bf16 else 1.5
    slots = _RESIDENT[tile] * sm_count
    cap = max(1, n // _MIN_SPLIT)

    def cut(splits):
        chunk = _cdiv(_cdiv(n, max(1, min(splits, cap))), _STAGE) * _STAGE
        return _cdiv(n, chunk), chunk

    best = None
    for waves in range(1, 5):
        splits_diag, chunk_diag = cut(int(waves * slots / (batch * (tiles + off * ratio))))
        splits_off, chunk_off = cut(round(splits_diag * ratio)) if off else (0, chunk_diag)
        blocks = batch * (tiles * splits_diag + off * splits_off)
        work = max(chunk_diag, chunk_off * ratio if off else 0) / _STAGE  # in diagonal stages
        cost = _cdiv(blocks, slots) * (work + _FILL)
        if best is None or cost < best[0]:
            best = (cost, GramSplits(tile, pairs, splits_diag, chunk_diag, splits_off, chunk_off))
    return best[1]


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
    bf16 = f.dtype == torch.bfloat16
    sp = gram_splits(b, c, n, _sm_count(f.device.index), bf16)
    splits = max(sp.splits_diag, sp.splits_off)
    partial = torch.empty((splits, b, sp.pairs, sp.tile, sp.tile), dtype=torch.float32, device=f.device)
    out = torch.empty((b, c, c), dtype=torch.float32, device=f.device)
    lib = _gram_lib()
    with torch.cuda.device(f.device):
        rc = lib.gram_forward(
            f.data_ptr(), int(bf16), b, c, n, sp.tile, sp.splits_diag, sp.chunk_diag, sp.splits_off, sp.chunk_off,
            partial.data_ptr(), out.data_ptr(), torch.cuda.current_stream(f.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gram kernel launch failed with CUDA error {rc}")
    trace.count("gram.launches")
    return out


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


def video_gram(x: torch.Tensor, use_covariance: bool = False) -> torch.Tensor:
    """Whole-window Gram: (T, C, H, W) -> (T·C, T·C) float32 (JAX
    ``ops/gram.py`` ``video_gram``; reference loss.py:84-91 with T > 1).  In
    contiguous NCHW the (1, T·C, H·W) view holds the frame-major rows of
    JAX's (T·C, HW) feature matrix, and centering each row is JAX's
    ``_video_mean``; autograd through the centering gives its
    ``df - _video_mean(df)``."""
    t, c = x.shape[:2]
    return batch_gram(x.reshape(1, t * c, *x.shape[2:]), use_covariance)[0]


def _band_features(bands, use_covariance: bool) -> list:
    """(B, C, h_i, W) bands -> their (B, C, h_i·W) feature views; with
    ``use_covariance`` each frame's channels centred by their means over
    the whole image, summed from the bands."""
    fs = [x.reshape(x.shape[0], x.shape[1], -1) for x in bands]
    if use_covariance:
        n = sum(f.shape[2] for f in fs)
        acc = torch.promote_types(fs[0].dtype, torch.float32)  # f32 sums for bf16 bands
        mean = sum_on(fs[0].device, [f.sum(dim=2, keepdim=True, dtype=acc) for f in fs]) / n
        fs = [f - mean.to(device=f.device, dtype=f.dtype) for f in fs]
    return fs


def banded_gram(bands, use_covariance: bool = False) -> torch.Tensor:
    """Per-frame unnormalised Grams of a stack cut into row bands, (B, C,
    h_i, W) each on its own device: each band's Grams through ``_GramFn``
    (one K1 launch per band over the whole stack on a CUDA band) on the
    band's device, the partials summed on the first band's device -> (B,
    C, C) f32.  ``use_covariance`` centres each frame of every band with
    that frame's channel means over the whole image, summed from the
    bands.  The backward of the sum hands each band the summed Grams'
    gradient, once."""
    return sum_on(bands[0].device, [_GramFn.apply(f) for f in _band_features(bands, use_covariance)])


def _window_view(x: torch.Tensor) -> torch.Tensor:
    """(T, C, h, W) -> the (1, T·C, h, W) view whose rows are JAX's
    frame-major (T·C, HW) feature matrix."""
    return x.reshape(1, x.shape[0] * x.shape[1], *x.shape[2:])


def banded_video_gram(bands, use_covariance: bool = False) -> torch.Tensor:
    """``video_gram`` of a window cut into row bands, (T, C, h_i, W) each on
    its own device: the sum over bands of each band's (1, T·C, h_i·W) K1
    Gram, on the first band's device -> (T·C, T·C) f32; with
    ``use_covariance`` each (frame, channel) row centred by its whole-frame
    mean, summed from the bands (``banded_gram`` of the window views)."""
    return banded_gram([_window_view(x) for x in bands], use_covariance)[0]


def _cross_block(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An off-diagonal block of a Gram cut into groups of rows, (…, R, N) x
    (…, S, N) -> (…, R, S) f32 on ``a``'s device (per frame for a leading
    frame dim), ``b`` copied there (autograd carries its gradient back
    through the copy)."""
    return torch.matmul(a.float(), b.to(a.device).float().transpose(-2, -1))


def _gram_blocks(groups) -> list[list[torch.Tensor]]:
    """The blocks on and above the diagonal of the Gram of features cut into
    groups of rows, each group a list of its bands' (B, R_i, N_j) feature
    views (every group has the same bands): row i is [G_ii, G_i,i+1, ...],
    each (B, R_i, R_k) f32 on group i's first device.  G_ii is K1 on each
    band, summed; G_ik = Σ_j F_ij F_kjᵀ a plain product per band
    (``_cross_block``), summed."""
    rows = []
    for i, fi in enumerate(groups):
        dev = fi[0].device
        row = [sum_on(dev, [_GramFn.apply(f) for f in fi])]
        row += [sum_on(dev, [_cross_block(a, b) for a, b in zip(fi, fk)]) for fk in groups[i + 1 :]]
        rows.append(row)
    return rows


def _assemble(blocks) -> torch.Tensor:
    """``_gram_blocks``' blocks (or 2-D ones) as the whole matrix on the
    first block's device, the blocks below the diagonal the transposes of
    those above."""
    dev = blocks[0][0].device
    rows = []
    for i, row in enumerate(blocks):
        below = [blocks[k][i - k].transpose(-2, -1).to(dev) for k in range(i)]
        rows.append(torch.cat(below + [b.to(dev) for b in row], dim=-1))
    return torch.cat(rows, dim=-2)


def video_gram_blocks(shares, use_covariance: bool = False) -> list[list[torch.Tensor]]:
    """The whole-window Gram of a window cut into groups of its (frame,
    channel) rows, each a list of row bands ((T_i, C_i, h_j, W) each; every
    group has the same band heights), as blocks on and above the diagonal:
    row i is [G_ii, G_i,i+1, ...], each (T_i·C_i, T_k·C_k) f32 on group
    i's first device.  A group is a share of frames (``parallel.window_
    shares``), or on a "tensor" axis a share of frames' channel share: its
    rows are the window's rows t·C + c of its frames t and channels c, in
    that (frame-major) order, so the blocks of channel shares are those of
    the whole Gram with its rows and columns permuted into group order.
    G_ii is the group's ``banded_video_gram``; G_ik = Σ_j F_ij F_kjᵀ (band
    j of both groups) is a plain product per band on group i's band-j
    device, summed on its first device.  ``use_covariance`` centres each
    group's rows as ``banded_video_gram`` does.  G_ki is G_ikᵀ."""
    blocks = _gram_blocks([_band_features([_window_view(x) for x in bands], use_covariance) for bands in shares])
    return [[b[0] for b in row] for row in blocks]


def shared_video_gram(shares, use_covariance: bool = False) -> torch.Tensor:
    """``video_gram`` of a window cut into shares of frames (each a list of
    row bands): ``video_gram_blocks`` assembled into the (T·C, T·C) matrix
    on the first share's device."""
    return _assemble(video_gram_blocks(shares, use_covariance))


def channel_gram(shares, use_covariance: bool = False) -> torch.Tensor:
    """The per-frame (B, C, C) f32 Grams of a stack of B frames whose
    channels are cut into shares, each a list of its row bands ((B, C_t,
    h_j, W) each; every share has the same band heights), on the first
    share's device.  Each diagonal block (B, C_t, C_t) is the share's
    bands' K1 Grams over the stack, summed on its first device; each block
    above it the bands' batched plain products (``_cross_block``), (B,
    C_s, N) x (B, N, C_u), summed there; the blocks below their transposes.
    Frames never meet: each frame's Gram is its own (the window view of a
    stack would give one (B·C, B·C) Gram).  An empty share (past the last
    channel) has no block.  ``use_covariance`` centres each frame's
    channels by their means over every band."""
    return _assemble(_gram_blocks([_band_features(bands, use_covariance) for bands in shares if bands[0].shape[1]]))


def gram_matrix(x: torch.Tensor, use_covariance: bool = False) -> torch.Tensor:
    """Gram of a single frame: (C, H, W) or (1, C, H, W) -> (C, C)
    (without the /nelement normalisation; callers divide)."""
    if x.dim() == 3:
        x = x[None]
    return batch_gram(x, use_covariance)[0]


__all__ = ["gram", "gram_reference", "gram_splits", "batch_gram", "banded_gram", "video_gram", "banded_video_gram",
           "video_gram_blocks", "shared_video_gram", "channel_gram", "gram_matrix"]
