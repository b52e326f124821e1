"""Optical flow for vid_img (JAX counterpart: maua_style_tpu/flow.py;
reference: flow.py).

- ``get_flow_model(args)``: the averaging ensemble over ``--flow_models``
  (reference flow.py:33-74); one pair at a time.
- ``get_flow_pair_model(args)``: the pre-pass model: for a batch of frame
  pairs, forward flow, backward flow and both reliability maps, computed on
  the device in one call (``pair.batched``).
- ``check_consistency`` / ``_reliability``: the forward-backward occlusion
  check (reference flow.py:77-137, Ruder et al.).
- ``flow_to_image``: the Middlebury colour wheel (flow.py:140-265), numpy.

Every flow computation runs under ``torch.inference_mode()``, which the
caller's thread must hold (grad mode is per thread).  Nets come from
``modelzoo/{name}.npz`` (the JAX package's layout) or
``modelzoo/{name}.pytorch`` (a sniklaus state dict); without either, only
``--allow_random_weights`` gives a seeded random net.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .engine.optimize import resolve_device
from .ops.gaussian import gaussian_blur
from .ops.resize import resize_bilinear

_MODEL_CACHE: dict[tuple[str, str], torch.nn.Module] = {}


def _get_net(name: str, device, allow_random: bool | None = None) -> torch.nn.Module:
    key = (name, str(device))
    if key in _MODEL_CACHE:
        return _MODEL_CACHE[key]
    from .models.flownets import convert

    if name == "spynet":
        from .models.flownets import SPyNet as Net
    elif name == "pwc":
        from .models.flownets import PWCNet as Net
    elif name == "unflow":
        from .models.flownets import UnFlow as Net
    elif name == "liteflownet":
        from .models.flownets import LiteFlowNet as Net
    else:
        raise ValueError(f"unknown flow model {name!r}")

    net = Net()
    if os.path.exists(f"modelzoo/{name}.npz"):
        net.load_state_dict(convert.flow_params_from_jax(name, convert.load_npz(f"modelzoo/{name}.npz")))
    elif os.path.exists(f"modelzoo/{name}.pytorch"):
        sd = torch.load(f"modelzoo/{name}.pytorch", map_location="cpu", weights_only=True)
        net.load_state_dict(convert.flow_params_from_torch(name, sd))
    else:
        from .models.registry import allow_random_weights

        if not allow_random_weights(allow_random):
            raise FileNotFoundError(
                f"No checkpoint for flow model '{name}' (modelzoo/{name}.npz or modelzoo/{name}.pytorch).\n"
                f"Put the sniklaus weights at modelzoo/{name}.pytorch, or pass --allow_random_weights to "
                f"proceed with seeded random weights (flow output will be meaningless; tests only)."
            )
        print(f"Warning: no checkpoint for flow model '{name}' (modelzoo/{name}.npz); using seeded random init.")
    net = net.to(device).eval()
    _MODEL_CACHE[key] = net
    return net


def _nets(args) -> list[torch.nn.Module]:
    names = [n.strip() for n in str(args.flow_models).split(",") if n.strip()]
    if not names:
        raise ValueError("no flow models selected")
    allow = getattr(args, "allow_random_weights", False) or None  # False defers to the env-var policy
    device = resolve_device(getattr(args, "device", None))
    return [_get_net(n, device, allow) for n in names]


def _ensemble(nets, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) u8 pairs -> (B, 2, H, W) mean flow.  The nets need
    multiples of 64: frames are resized to that and the flow back, with its
    magnitudes rescaled (what the reference's submodule scripts do)."""
    h, w = a.shape[1:3]
    h64, w64 = max(64, -(-h // 64) * 64), max(64, -(-w // 64) * 64)
    # contiguous NCHW: a permuted (channels-last) input would carry its
    # layout through the convolutions to the cost volume, which refuses it
    t1 = resize_bilinear(a.permute(0, 3, 1, 2).contiguous().float() / 255.0, size=(h64, w64))
    t2 = resize_bilinear(b.permute(0, 3, 1, 2).contiguous().float() / 255.0, size=(h64, w64))
    acc = 0.0
    for net in nets:
        acc = acc + resize_bilinear(net(t1, t2), size=(h, w))
    scale = torch.tensor([w / w64, h / h64], dtype=torch.float32, device=a.device).view(1, 2, 1, 1)
    return acc * scale / len(nets)


def get_flow_model(args):
    """Averaging ensemble: ``estimate(im1, im2)`` on (H, W, 3) RGB frames ->
    (H, W, 2) host flow."""
    nets = _nets(args)
    device = next(nets[0].parameters()).device

    def estimate(im1: np.ndarray, im2: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            a = torch.as_tensor(np.asarray(im1))[None].to(device)
            b = torch.as_tensor(np.asarray(im2))[None].to(device)
            return _ensemble(nets, a, b)[0].permute(1, 2, 0).cpu().numpy()

    return estimate


def _sample_border(field: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (B, H, W, C) ``field`` at float pixel coordinates
    (B, H, W), the taps clamped to the border."""
    b, h, w, c = field.shape
    x0, y0 = torch.floor(px), torch.floor(py)
    tx, ty = (px - x0)[..., None], (py - y0)[..., None]
    flat = field.reshape(b, h * w, c)

    def tap(yi, xi):
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()).reshape(b, -1, 1)
        return torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(b, h, w, c)

    top = tap(y0, x0) * (1 - tx) + tap(y0, x0 + 1) * tx
    bot = tap(y0 + 1, x0) * (1 - tx) + tap(y0 + 1, x0 + 1) * tx
    return top * (1 - ty) + bot * ty


def _forward_diff_energy(f: torch.Tensor) -> torch.Tensor:
    """Squared forward differences of (B, H, W, 2) flow along both image
    axes, the last row/column taken against 0."""
    dx = torch.cat([f[:, :, 1:] - f[:, :, :-1], -f[:, :, -1:]], 2)
    dy = torch.cat([f[:, 1:] - f[:, :-1], -f[:, -1:]], 1)
    return torch.sum(dx * dx + dy * dy, -1)


def _reliability(fwd: torch.Tensor, bwd: torch.Tensor) -> torch.Tensor:
    """(B, H, W) reliability in [0, 1] for warping along (B, H, W, 2) ``fwd``:
    round-trip error over a motion-dependent threshold marks occlusions
    (-1, so the blur bleeds them outward); pixels leaving the frame and
    motion boundaries are 0; gaussian blur (sigma 5), clip to [0, 1]."""
    fwd, bwd = fwd.float(), bwd.float()
    _, h, w, _ = fwd.shape
    px = torch.arange(w, dtype=torch.float32, device=fwd.device)[None, None, :] + fwd[..., 0]
    py = torch.arange(h, dtype=torch.float32, device=fwd.device)[None, :, None] + fwd[..., 1]

    bwd_at = _sample_border(bwd, px.clamp(0, w - 2), py.clamp(0, h - 2))
    roundtrip = fwd + bwd_at
    err = torch.sum(roundtrip * roundtrip, -1)
    occ_thresh = 0.01 * torch.sum(bwd_at * bwd_at + fwd * fwd, -1) + 0.5
    one = torch.ones_like(err)
    rel = torch.where(err >= occ_thresh, -one, one)

    in_frame = (px >= 0) & (py >= 0) & (px < w - 1) & (py < h - 1)
    rel = torch.where(in_frame, rel, 0.0)

    edge_thresh = 0.01 * torch.sum(fwd * fwd, -1) + 0.002
    at_edge = _forward_diff_energy(fwd) > edge_thresh
    rel = torch.where(at_edge & (rel != -1.0), 0.0, rel)
    return torch.clamp(gaussian_blur(rel, [0, 5.0, 5.0]), 0.0, 1.0)


def check_consistency(flow1: np.ndarray, flow2: np.ndarray, device=None) -> np.ndarray:
    """(H, W, 2) forward and backward host flows -> (H, W) reliability of
    ``flow1``, computed on ``device`` (CUDA device 0 unless named)."""
    device = resolve_device(device)
    f1 = torch.as_tensor(np.asarray(flow1, np.float32), device=device)[None]
    f2 = torch.as_tensor(np.asarray(flow2, np.float32), device=device)[None]
    return _reliability(f1, f2)[0].cpu().numpy()


def get_flow_pair_model(args):
    """The pre-pass model: ``pair(im1, im2)`` on (H, W, 3) frames and
    ``pair.batched(ims1, ims2)`` on (B, H, W, 3) stacks return host arrays
    (forward flow, backward flow, forward reliability, backward
    reliability), flows (…, H, W, 2) and reliabilities (…, H, W)."""
    nets = _nets(args)
    device = next(nets[0].parameters()).device

    def batched(ims1: np.ndarray, ims2: np.ndarray):
        with torch.inference_mode():
            a = torch.as_tensor(np.asarray(ims1)).to(device)
            b = torch.as_tensor(np.asarray(ims2)).to(device)
            fwd = _ensemble(nets, a, b).permute(0, 2, 3, 1)
            bwd = _ensemble(nets, b, a).permute(0, 2, 3, 1)
            out = (fwd, bwd, _reliability(fwd, bwd), _reliability(bwd, fwd))
            return tuple(o.cpu().numpy() for o in out)

    def pair(im1: np.ndarray, im2: np.ndarray):
        return tuple(o[0] for o in batched(np.asarray(im1)[None], np.asarray(im2)[None]))

    pair.batched = batched
    return pair


# ---------------------------------------------------------------------------
# Middlebury flow visualisation (semantics of reference flow.py:140-265)

_WHEEL_ANCHORS = np.array(
    # red -> yellow -> green -> cyan -> blue -> magenta -> red
    [[255, 0, 0], [255, 255, 0], [0, 255, 0], [0, 255, 255], [0, 0, 255], [255, 0, 255], [255, 0, 0]],
    dtype=np.float64,
)
_WHEEL_SEGMENT_LENGTHS = (15, 6, 4, 11, 13, 6)


def make_color_wheel() -> np.ndarray:
    """Middlebury colour wheel: six hue segments of uneven length stepping
    between the primary/secondary RGB anchors (integer ramps)."""
    rows = []
    for i, length in enumerate(_WHEEL_SEGMENT_LENGTHS):
        a, b = _WHEEL_ANCHORS[i], _WHEEL_ANCHORS[i + 1]
        t = np.arange(length, dtype=np.float64)[:, None]
        rows.append(a + np.sign(b - a) * np.floor(np.abs(b - a) * t / length))
    return np.concatenate(rows, axis=0)


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """Flow -> Middlebury colour image (uint8): hue from direction via the
    colour wheel, saturation from magnitude (normalised to the frame max)."""
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    unknown = (~np.isfinite(u)) | (~np.isfinite(v)) | (np.abs(u) > 1e7) | (np.abs(v) > 1e7)
    u = np.where(unknown, 0.0, u)
    v = np.where(unknown, 0.0, v)

    scale = max(np.max(np.hypot(u, v)), -1.0) + np.finfo(float).eps
    u, v = u / scale, v / scale
    rad = np.hypot(u, v)[..., None]

    wheel = make_color_wheel() / 255.0
    ncols = wheel.shape[0]
    pos = (np.arctan2(-v, -u) / np.pi + 1.0) / 2.0 * (ncols - 1)  # [0, ncols-1]
    k0 = np.floor(pos).astype(np.int64)
    frac = (pos - k0)[..., None]
    col = (1.0 - frac) * wheel[k0] + frac * wheel[(k0 + 1) % ncols]
    col = np.where(rad <= 1.0, 1.0 - rad * (1.0 - col), 0.75 * col)
    col = np.where(unknown[..., None], 0.0, col)
    return np.floor(255.0 * col).astype(np.uint8)


__all__ = ["get_flow_model", "get_flow_pair_model", "check_consistency", "flow_to_image", "make_color_wheel"]
