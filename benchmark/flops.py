"""The yardstick's arithmetic: the chip's peaks, a step's operations from
the layer tables, and the least times of the Gram kernel (K1) and the
cost-volume kernel (K2).

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit."""

from __future__ import annotations

from .reference import nets

PEAK_FP32 = 67e12  # FLOP/s, float32 outside the tensor cores
PEAK_TF32 = 495e12  # FLOP/s, TF32 tensor cores
PEAK_BYTES = 3.35e12  # B/s, HBM3


def conv_forward_flops(arch: str, wanted, h: int, w: int) -> float:
    """2·Cin·Cout·k²·Hout·Wout over every convolution up to the deepest
    wanted layer."""
    return float(sum(2 * ci * co * k * k * ho * wo for _, ci, co, k, ho, wo in nets.conv_shapes(arch, wanted, h, w)))


def gram_flops(arch: str, style_layers, h: int, w: int) -> float:
    """N·C·(C+1) over the style layers: the entries on and above the
    diagonal of each Gram, two operations each."""
    sizes = nets.layer_sizes(arch, style_layers, h, w)
    return float(sum(hh * ww * c * (c + 1) for c, hh, ww in sizes.values()))


def iteration_flops(cfg: dict, h: int, w: int) -> float:
    """One iteration: the convolutions' forward and input gradient (the
    weights are frozen, so no weight gradient) up to the deepest loss
    layer, and the style Grams."""
    layers = list(dict.fromkeys(cfg["content_layers"] + cfg["style_layers"]))
    return 2 * conv_forward_flops(cfg["arch"], layers, h, w) + gram_flops(cfg["arch"], cfg["style_layers"], h, w)


def gram_bound_s(b: int, c: int, n: int) -> float:
    """K1's least time for an f32 (B, C, N) input: max(3·B·N·C·(C+1) /
    the TF32 peak (an f32-accurate product is three TF32 products),
    (4·B·C·N + 4·B·C²) bytes / the HBM bandwidth)."""
    ops = 3.0 * b * n * c * (c + 1) / PEAK_TF32
    byt = (4.0 * b * c * n + 4.0 * b * c * c) / PEAK_BYTES
    return max(ops, byt)


def correlation_bound_s(b: int, c: int, h: int, w: int, k: int) -> float:
    """K2's least time for f32 (B, C, H, W) inputs and K displacements:
    max(2·B·H·W·K·C / the f32 peak (2·C operations an output, outside the
    tensor cores), 4·B·H·W·(2C + K) bytes / the HBM bandwidth (both inputs
    read once, the f32 output written once))."""
    ops = 2.0 * b * h * w * k * c / PEAK_FP32
    byt = 4.0 * b * h * w * (2 * c + k) / PEAK_BYTES
    return max(ops, byt)
