"""Plain neural style transfer: the losses, their gradient, L-BFGS and Adam,
and the host steps of a pyramid (preprocessing, bilinear resize, colour
histogram matching), written from the published method (Gatys et al.,
arXiv:1508.06576; the maua-style reference's losses and optimisers) in
plain PyTorch, float32 on the device with TF32 off.

- content: mean squared error of a layer's activations to the content
  image's; style: mean squared error of each layer's Gram matrix divided by
  C·H·W to the style image's; tv: the anisotropic L1 total variation.
- The values reported are ``weight · term`` (``tv_weight · tv``); the
  gradient is that of ``weight² · term`` for content and style, because
  the reference scales each term's gradient by the L2 norm of its upstream
  gradient (a scalar, so a sign) times weight² (``J`` below).
- L-BFGS: ``torch.optim.LBFGS``'s step without a line search: the first
  direction -g with the step min(1, 1/|g|₁)·lr, later ones the two-loop
  recursion over at most ``history`` (s, y) pairs with H0 = y·s / y·y,
  a pair kept only where y·s > 1e-10, the step lr.
- Adam: b1 0.9, b2 0.999, eps 1e-8 added outside the square root, bias
  corrected (optax's ``adam``).

Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import nets

CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)
CHUNK = 1 << 16  # positions one product of a Gram sums; the chunks' products are added


def precise() -> None:
    """float32 without TF32 for matrix products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def gram(a: torch.Tensor) -> torch.Tensor:
    """(1, C, H, W) -> (C, C) F Fᵀ, summed in chunks of ``CHUNK`` positions."""
    f = a.reshape(a.shape[1], -1)
    out = None
    for i in range(0, f.shape[1], CHUNK):
        part = f[:, i : i + CHUNK]
        g = part @ part.T
        out = g if out is None else out + g
    return out


def tv(x: torch.Tensor) -> torch.Tensor:
    return (x[:, :, 1:] - x[:, :, :-1]).abs().sum() + (x[:, :, :, 1:] - x[:, :, :, :-1]).abs().sum()


class Objective:
    """The losses of one scale: targets captured from the content and style
    images (NCHW on the device), ``terms(p)`` the reported values in the
    order content layers, style layers, tv; ``value_and_grad(p)`` adds
    (J, dJ/dp)."""

    def __init__(self, cfg: dict, weights: dict, content: torch.Tensor, style: torch.Tensor):
        self.arch = cfg["arch"]
        self.content_layers = list(cfg["content_layers"])
        self.style_layers = list(cfg["style_layers"])
        self.cw, self.sw, self.tvw = float(cfg["content_weight"]), float(cfg["style_weight"]), float(cfg["tv_weight"])
        self.weights = weights
        self.layers = list(dict.fromkeys(self.content_layers + self.style_layers))
        with torch.no_grad():
            c_acts = nets.forward(self.arch, weights, content, self.content_layers)
            self.content = {l: c_acts[l] for l in self.content_layers}
            s_acts = nets.forward(self.arch, weights, style, self.style_layers)
            self.style = {l: gram(a) / a[0].numel() for l, a in s_acts.items()}
            del c_acts, s_acts

    def _parts(self, p: torch.Tensor) -> list[tuple[torch.Tensor, float]]:
        """(term, weight in J) in reporting order."""
        acts = nets.forward(self.arch, self.weights, p, self.layers)
        parts = [(torch.mean((acts[l] - self.content[l]) ** 2), self.cw) for l in self.content_layers]
        for l in self.style_layers:
            a = acts[l]
            parts.append((torch.mean((gram(a) / a[0].numel() - self.style[l]) ** 2), self.sw))
        if self.tvw > 0:
            parts.append((tv(p), None))
        return parts

    def _combine(self, parts) -> tuple[torch.Tensor, torch.Tensor]:
        values = torch.stack([t * (self.tvw if w is None else w) for t, w in parts])
        j = sum(t * (self.tvw if w is None else w * w) for t, w in parts)
        return values, j

    @torch.no_grad()
    def terms(self, p: torch.Tensor) -> tuple[torch.Tensor, float]:
        """(reported values, J) at ``p``."""
        values, j = self._combine(self._parts(p))
        return values, float(j)

    def value_and_grad(self, p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        p = p.detach().requires_grad_(True)
        values, j = self._combine(self._parts(p))
        (g,) = torch.autograd.grad(j, p)
        return values.detach(), g


class LBFGS:
    def __init__(self, lr: float, history: int):
        self.lr, self.m = float(lr), int(history)
        self.s, self.y = [], []
        self.h0 = 1.0
        self.prev = None  # (g, d, t)

    def step(self, g: torch.Tensor) -> torch.Tensor:
        gf = g.reshape(-1)
        if self.prev is None:
            d = -gf
            t = min(1.0, 1.0 / float(gf.abs().sum())) * self.lr
        else:
            g0, d0, t0 = self.prev
            y, s = gf - g0, d0 * t0
            ys = float(torch.dot(y, s))
            if ys > 1e-10:
                if len(self.s) == self.m:
                    self.s.pop(0)
                    self.y.pop(0)
                self.s.append(s)
                self.y.append(y)
                self.h0 = ys / float(torch.dot(y, y))
            q = -gf
            alphas = []
            for s_i, y_i in zip(reversed(self.s), reversed(self.y)):
                a = float(torch.dot(s_i, q)) / float(torch.dot(y_i, s_i))
                alphas.append(a)
                q = q - a * y_i
            d = q * self.h0
            for (s_i, y_i), a in zip(zip(self.s, self.y), reversed(alphas)):
                b = float(torch.dot(y_i, d)) / float(torch.dot(y_i, s_i))
                d = d + (a - b) * s_i
            t = self.lr
        self.prev = (gf, d, t)
        return (t * d).reshape(g.shape)


class Adam:
    def __init__(self, lr: float):
        self.lr, self.t, self.mu, self.nu = float(lr), 0, None, None

    def step(self, g: torch.Tensor) -> torch.Tensor:
        self.t += 1
        if self.mu is None:
            self.mu, self.nu = torch.zeros_like(g), torch.zeros_like(g)
        self.mu = 0.9 * self.mu + 0.1 * g
        self.nu = 0.999 * self.nu + 0.001 * g * g
        mu_hat = self.mu / (1 - 0.9**self.t)
        nu_hat = self.nu / (1 - 0.999**self.t)
        return -self.lr * mu_hat / (torch.sqrt(nu_hat) + 1e-8)


def optimise(obj: Objective, init: torch.Tensor, iters: int, optimizer: str, lr: float, history: int):
    """``iters`` steps from ``init``: (log (iters, n_terms) of the values at
    each step's start, the last pastiche)."""
    opt = LBFGS(lr, history) if optimizer == "lbfgs" else Adam(lr)
    p, log = init.clone(), []
    for _ in range(iters):
        values, g = obj.value_and_grad(p)
        log.append(values)
        p = p + opt.step(g)
    return torch.stack(log).cpu().double().numpy(), p


# -- host steps of the pyramid (numpy (1, H, W, 3) BGR arrays) -------------


def preprocess(rgb_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB uint8 -> (1, H, W, 3) float32 BGR minus the Caffe mean."""
    return (rgb_u8[..., ::-1].astype(np.float32) - np.array(CAFFE_MEAN_BGR, np.float32))[None]


def resize(x: np.ndarray, size=None, scale=None) -> np.ndarray:
    """Bilinear, half-pixel centres, no antialiasing; with ``scale`` the
    source coordinate is (i + 0.5) / scale - 0.5 and the size floor(n · scale)."""
    t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).float()
    if size is not None:
        if tuple(size) == tuple(t.shape[-2:]):
            return x
        out = F.interpolate(t, size=tuple(int(s) for s in size), mode="bilinear", align_corners=False)
    else:
        out = F.interpolate(t, scale_factor=float(scale), mode="bilinear", align_corners=False,
                            recompute_scale_factor=False)
    return out.permute(0, 2, 3, 1).contiguous().numpy()


def _sqrt_psd(c: np.ndarray) -> np.ndarray:
    vals, vecs = np.linalg.eigh(c)
    return (vecs * np.sqrt(np.maximum(vals, 0.0))) @ vecs.T


def match_colors(target: np.ndarray, source: np.ndarray, eps: float = 1e-2) -> np.ndarray:
    """Each frame of ``target`` recoloured so that its channel mean and
    covariance (plus eps·I) become those of the mean frame of ``source``:
    centred pixels map through Qs Qt⁻¹, Q the symmetric square roots;
    in float64."""
    src = source.astype(np.float64).mean(axis=0).reshape(-1, 3)
    mu_s = src.mean(axis=0)
    cs = np.cov(src.T, bias=True) + eps * np.eye(3)
    out = np.empty_like(target, dtype=np.float32)
    for i, frame in enumerate(target.astype(np.float64)):
        t = frame.reshape(-1, 3)
        mu_t = t.mean(axis=0)
        ct = np.cov(t.T, bias=True) + eps * np.eye(3)
        m = _sqrt_psd(cs) @ np.linalg.inv(_sqrt_psd(ct))
        out[i] = ((t - mu_t) @ m.T + mu_s).reshape(frame.shape)
    return out


def nchw(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2))).to(device)
