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
  raises; on CPU tensors it takes ``correlation_reference``.  The counter
  ``correlation.launches`` (``trace.counter``) counts kernel launches.
- ``launch_plan``: how the kernel cuts the work (tile, register blocking,
  displacement groups, channel splits, ring stages, shared memory).
- ``correlation_reference``: the plain version, a loop over the K shifted
  products.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import trace
from ..kernels import build

# csrc/correlation.cu's constants
PX = 4  # pixels a thread owns, along x
STAGES = 3  # ring stages of channel chunks
MAX_THREADS = 192  # per block (its __launch_bounds__, two blocks an SM)
# what the plan chooses within
ACC_BUDGET = 108  # f32 sums a thread keeps in registers (4 pixels x 3 rows x 9 columns at d = 4)
RING_BUDGET = 96 * 1024  # bytes of ring per block
SMEM_MAX = 227 * 1024  # shared memory a block may have on sm_90
MAX_QUADS = 64  # 4-pixel groups in a tile (8 x 32 pixels)
MAX_CC = 8  # channels per ring stage
MIN_SPLIT_CHANNELS = 8  # fewest channels a channel split sums


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


class LaunchPlan(NamedTuple):
    """How csrc/correlation.cu cuts one call.

    Compile-time (one library per value, its ``defines``): the displacement
    ``stride``; ``nx`` displacement columns and ``rows`` displacement rows
    per thread, each thread summing PX pixels x rows x nx in registers;
    ``off`` = (-d) mod 4, which puts the halo's column 0 on a 16-byte
    boundary.

    Run time: a ``th`` x ``tw`` pixel tile; ``groups`` thread groups of
    ``rows`` displacement rows per block; ``dy_blocks`` x ``dx_groups``
    blocks over the displacement rows and columns; ``splits`` channel splits
    of ``chunk_c`` channels (summed by a second pass in split order);
    ``cc`` channels per ring stage; ``hh`` x ``hws`` halo staged per
    channel; TMA copies if ``tma``, else 4-byte cp.async; ``threads`` per
    block; ``smem_bytes`` of dynamic shared memory; ``blocks`` in the
    grid."""

    stride: int
    nx: int
    rows: int
    off: int
    th: int
    tw: int
    groups: int
    dy_blocks: int
    dx_groups: int
    splits: int
    chunk_c: int
    cc: int
    hh: int
    hws: int
    tma: bool
    threads: int
    smem_bytes: int
    blocks: int

    @property
    def defines(self) -> tuple[str, ...]:
        return (f"CORR_S={self.stride}", f"CORR_NX={self.nx}", f"CORR_ROWS={self.rows}", f"CORR_OFF={self.off}")


def _kernel_shape(max_disp: int, stride: int) -> tuple[int, int]:
    """(nx, rows): every displacement column in one thread where 4·n sums
    fit the budget, else the most columns whose span (nx·s) keeps the next
    column group's halo 16-byte aligned; then as many rows as fit."""
    n = 2 * max_disp // stride + 1
    nx = n
    if PX * n > ACC_BUDGET:
        step = 4 // math.gcd(stride, 4)
        nx = ACC_BUDGET // PX // step * step
    return nx, max(1, min(n, ACC_BUDGET // (PX * nx)))


@functools.lru_cache(maxsize=None)
def launch_plan(batch: int, channels: int, height: int, width: int, max_disp: int, stride: int = 1,
                sm_count: int = 132, aligned: bool = True) -> LaunchPlan:
    """The tile fits the frame (at most 32 columns, 64 groups of 4 pixels;
    a 1 x 1 level stages a 1 x 4 tile).  A block covers as many displacement
    rows as MAX_THREADS allow.  Where the grid would hold fewer blocks than
    the card has SMs, C is split across blocks (at least MIN_SPLIT_CHANNELS
    each): up to one block per SM, since each split writes and rereads a
    whole partial cost volume.
    ``aligned``: both inputs start on a 16-byte boundary."""
    d, s = max_disp, stride
    n = 2 * d // s + 1
    nx, rows = _kernel_shape(d, s)
    off = -d % 4
    dx_groups = _cdiv(n, nx)

    tw = min(32, _round_up(width, PX))
    tiles_w = _cdiv(width, tw)
    tw = _round_up(_cdiv(width, tiles_w), PX)
    tiles_h = _cdiv(height, max(1, MAX_QUADS * PX // tw))
    th = _cdiv(height, tiles_h)
    quads = th * tw // PX

    row_groups = _cdiv(n, rows)
    dy_blocks = _cdiv(row_groups, max(1, MAX_THREADS // quads))
    groups = _cdiv(row_groups, dy_blocks)
    threads = _round_up(quads * groups, 32)

    base = batch * tiles_w * tiles_h * dy_blocks * dx_groups
    splits = 1
    if base < sm_count:
        splits = max(1, min(_cdiv(sm_count, base), channels // MIN_SPLIT_CHANNELS))
    chunk_c = _cdiv(channels, splits)
    splits = _cdiv(channels, chunk_c)

    hh = th + (rows * groups - 1) * s
    hws = tw - PX + 4 * ((off + PX + (nx - 1) * s + 3) // 4)
    cs = th * tw + hh * hws  # floats per channel in a stage
    cc = max(1, min(MAX_CC, chunk_c, RING_BUDGET // (STAGES * cs * 4)))
    # TMA wants 16-byte rows and halo origins and boxes of at most 256
    tma = aligned and width % 4 == 0 and (dx_groups == 1 or nx * s % 4 == 0) and max(hh, hws) <= 256
    # a 128-byte boundary, the ring (f1's tiles and f2's halos, each rounded
    # up to 128 bytes), a 64-bit mbarrier per stage, the 4-byte copies'
    # source offsets
    slot = _round_up(cc * th * tw, 32) + _round_up(cc * hh * hws, 32)
    smem = 128 + 4 * (STAGES * slot + 2 * STAGES + cs)
    if smem > SMEM_MAX:
        raise ValueError(f"correlation: max_disp {d}, stride {s} needs {smem} bytes of shared memory per block (> {SMEM_MAX})")
    return LaunchPlan(s, nx, rows, off, th, tw, groups, dy_blocks, dx_groups, splits, chunk_c, cc, hh, hws, tma,
                      threads, smem, base * splits)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib(defines: tuple[str, ...]) -> ctypes.CDLL:
    lib = build.load("correlation", defines)
    lib.correlation_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    lib.correlation_forward.restype = ctypes.c_int
    return lib


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
    aligned = f1.data_ptr() % 16 == 0 and f2.data_ptr() % 16 == 0
    p = launch_plan(b, c, h, w, max_disp, stride, _sm_count(f1.device.index), aligned)
    n = 2 * max_disp // stride + 1
    out = torch.empty((b, n * n, h, w), dtype=torch.float32, device=f1.device)
    part = torch.empty((p.splits, b, n * n, h, w), dtype=torch.float32, device=f1.device) if p.splits > 1 else out
    lib = _lib(p.defines)
    with torch.cuda.device(f1.device):
        rc = lib.correlation_forward(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), part.data_ptr(), b, c, h, w, max_disp, p.th, p.tw,
            p.groups, p.dy_blocks, p.dx_groups, p.splits, p.chunk_c, p.cc, int(p.tma), p.threads, p.smem_bytes,
            torch.cuda.current_stream(f1.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"correlation kernel launch failed with CUDA error {rc}")
    trace.count("correlation.launches")
    return out

__all__ = ["correlation", "correlation_reference", "launch_plan", "LaunchPlan"]
