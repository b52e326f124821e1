"""Everything a run feeds the program and the reference, made from
``--seed``: the feature net's weights (on the device, in a few large
draws of one ``torch.Generator``), the content and style images, and the
random init.  The same seed gives the same inputs; every seed gives
inputs of the same sizes."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .reference import nets

CAFFE_MEAN_BGR = np.array([103.939, 116.779, 123.68], np.float32)


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of one seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 8 + stream) % (2**63))


def make_weights(arch: str, seed: int, device) -> dict[str, torch.Tensor]:
    """He-normal float32 weights and small biases for every convolution of
    the whole net, keyed ``{conv}.weight`` (OIHW) / ``{conv}.bias``: one
    draw for all weights and one for all biases, cut into views."""
    convs, in_ch = [], 3
    for kind, name, c, k, _, _ in nets.TABLES[arch]:
        if kind == "conv":
            convs.append((name, c, in_ch, k))
            in_ch = c
    n_w = sum(c * ci * k * k for _, c, ci, k in convs)
    n_b = sum(c for _, c, _, _ in convs)
    gen = generator(seed, device, 0)
    flat_w = torch.randn(n_w, generator=gen, device=device)
    flat_b = torch.randn(n_b, generator=gen, device=device) * 0.01
    out, iw, ib = {}, 0, 0
    for name, c, ci, k in convs:
        n = c * ci * k * k
        out[f"{name}.weight"] = (flat_w[iw : iw + n] * math.sqrt(2.0 / (ci * k * k))).view(c, ci, k, k)
        out[f"{name}.bias"] = flat_b[ib : ib + c]
        iw, ib = iw + n, ib + c
    return out


def image_u8(h: int, w: int, seed: int, stream: int, device) -> torch.Tensor:
    """A (3, H, W) uint8 RGB picture: a smooth colour field at three
    scales (bicubic from 4x4, 32x32 and 256x256 draws) and fine noise."""
    gen = generator(seed, device, stream)
    img = torch.zeros((1, 3, h, w), device=device)
    for cells, amp in ((4, 60.0), (32, 35.0), (256, 20.0)):
        field = torch.randn((1, 3, min(cells, h), min(cells, w)), generator=gen, device=device)
        img += amp * F.interpolate(field, size=(h, w), mode="bicubic", align_corners=False)
    img += 8.0 * torch.randn((1, 3, h, w), generator=gen, device=device)
    return (img[0] + 128.0).clamp(0, 255).round().to(torch.uint8)


def caffe_array(rgb_u8: torch.Tensor) -> np.ndarray:
    """(3, H, W) RGB uint8 -> the program's (1, H, W, 3) float32 BGR minus
    the Caffe mean, on the host."""
    bgr = rgb_u8.flip(0).permute(1, 2, 0).float() - torch.as_tensor(CAFFE_MEAN_BGR, device=rgb_u8.device)
    return bgr[None].cpu().numpy()


def random_init(h: int, w: int, seed: int, device) -> np.ndarray:
    """The CLI's random init, 0.001 · N(0, 1), as a (1, H, W, 3) host array."""
    gen = generator(seed, device, 3)
    return (torch.randn((1, h, w, 3), generator=gen, device=device) * 0.001).cpu().numpy()
