"""Neural cellular automaton texture model (JAX counterpart:
maua_style_tpu/models/nca.py; reference NCA_train.py:154-195), NCHW.

- ``perception``: four fixed 3x3 filters per channel (identity, Sobel x,
  Sobel y, Laplacian) as one depthwise convolution with circular padding,
  channel-major (channel c's filters are outputs 4c..4c+3);
- ``ca_step``: a 1x1 conv MLP (4C -> hidden -> C, ReLU, no bias on the
  second layer, which starts at zero) and the stochastic update
  ``x + y * floor(u + rate)``, ``rate`` a scalar or an (H, W) map;
- ``rollout``: ``n_steps`` steps.

Randomness comes from one explicit source, a ``Draws`` object: the update
masks' uniform draws, the training batch's pool indices and its rollout
length.  ``Draws`` holds a ``torch.Generator`` on the state's device; tests
hand the functions JAX's own draws instead (JAX uses threefry keys).

Parameters are ``{"w1": (hidden, 4C, 1, 1), "b1": (hidden,), "w2": (C,
hidden, 1, 1)}`` tensors.  ``save_ca`` / ``load_ca`` read and write the JAX
package's npz (``w1`` (1, 1, 4C, hidden), ``b1``, ``w2`` (1, 1, hidden, C)),
so a checkpoint from either package loads in the other.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

IDENT = np.array([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], np.float32)
LAP = np.array([[1.0, 2.0, 1.0], [2.0, -12.0, 2.0], [1.0, 2.0, 1.0]], np.float32)


class Draws:
    """The CA's random numbers, from one ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def uniform(self, shape) -> torch.Tensor:
        """U[0, 1) float32 of ``shape`` on the device."""
        return torch.rand(shape, generator=self.generator, device=self.device)

    def batch(self, pool_size: int, batch_size: int) -> torch.Tensor:
        """``batch_size`` distinct pool indices."""
        return torch.randperm(pool_size, generator=self.generator, device=self.device)[:batch_size]

    def steps(self, low: int, high: int) -> int:
        """A rollout length in [low, high)."""
        return int(torch.randint(low, high, (), generator=self.generator, device=self.device))


@functools.lru_cache(maxsize=None)
def _perception_weight(chn: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The depthwise kernel (4C, 1, 3, 3), made once per device and dtype."""
    filters = np.stack([IDENT, SOBEL_X, SOBEL_X.T, LAP])  # (4, 3, 3)
    return torch.as_tensor(np.tile(filters, (chn, 1, 1))[:, None], device=device, dtype=dtype)  # (4C, 1, 3, 3)


def perception(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H, W), circular padding."""
    chn = x.shape[1]
    xp = F.pad(x, (1, 1, 1, 1), mode="circular")
    return F.conv2d(xp, _perception_weight(chn, x.device, x.dtype), groups=chn)


def init_ca_params(chn: int = 12, hidden_n: int = 96, seed: int = 0, *, device) -> dict[str, torch.Tensor]:
    """torch Conv2d's default init for the first layer, weights and bias
    uniform in ±1/sqrt(4C) (the bias keeps a zero state from being a fixed
    point with zero gradient); the second layer zero, without bias
    (NCA_train.py:179).  Seeded; it does not reproduce JAX's threefry
    draws (tests carry weights across with ``ca_params_from_jax``)."""
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(chn * 4)
    w1 = (torch.rand((hidden_n, chn * 4, 1, 1), generator=gen) * 2 - 1) * bound
    b1 = (torch.rand((hidden_n,), generator=gen) * 2 - 1) * bound
    return {"w1": w1.to(device), "b1": b1.to(device), "w2": torch.zeros((chn, hidden_n, 1, 1), device=device)}


def ca_step(params: dict, x: torch.Tensor, u: torch.Tensor, update_rate=0.5) -> torch.Tensor:
    """One CA update (reference NCA_train.py:181-186).  ``u``: (B, 1, H, W)
    uniform draws; ``update_rate``: a scalar or an (H, W) map (the text
    mask of NCA_gen.py:50-56)."""
    y = perception(x)
    y = torch.relu(F.conv2d(y, params["w1"], params["b1"]))
    y = F.conv2d(y, params["w2"])
    rate = update_rate
    if torch.is_tensor(rate) and rate.dim() > 0:
        rate = rate.reshape(1, 1, *x.shape[2:])
    mask = torch.floor(u + rate)
    return x + y * mask


def rollout(params: dict, x: torch.Tensor, draws: Draws, n_steps: int, update_rate=0.5) -> torch.Tensor:
    """``n_steps`` CA updates, each with a fresh (B, 1, H, W) draw."""
    b, _, h, w = x.shape
    for _ in range(n_steps):
        x = ca_step(params, x, draws.uniform((b, 1, h, w)), update_rate)
    return x


def seed_state(n: int, size: int = 128, chn: int = 12, *, device) -> torch.Tensor:
    return torch.zeros((n, chn, size, size), device=device)


def to_rgb(x: torch.Tensor) -> torch.Tensor:
    return x[:, :3]


def ca_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX layout (HWIO 1x1 kernels) -> this module's (OIHW)."""
    return {
        "w1": torch.from_numpy(np.ascontiguousarray(np.asarray(params["w1"], np.float32).transpose(3, 2, 0, 1))),
        "b1": torch.from_numpy(np.array(params["b1"], np.float32)),
        "w2": torch.from_numpy(np.ascontiguousarray(np.asarray(params["w2"], np.float32).transpose(3, 2, 0, 1))),
    }


def ca_params_to_jax(params: dict) -> dict[str, np.ndarray]:
    """This module's layout -> the JAX package's, host numpy arrays."""
    return {
        "w1": params["w1"].detach().cpu().numpy().transpose(2, 3, 1, 0).copy(),
        "b1": params["b1"].detach().cpu().numpy().copy(),
        "w2": params["w2"].detach().cpu().numpy().transpose(2, 3, 1, 0).copy(),
    }


def save_ca(params: dict, path: str) -> None:
    np.savez(path, **ca_params_to_jax(params))


def load_ca(path: str, device) -> dict[str, torch.Tensor]:
    with np.load(path) as data:
        return {k: v.to(device) for k, v in ca_params_from_jax({k: data[k] for k in data.files}).items()}


__all__ = [
    "Draws",
    "perception",
    "init_ca_params",
    "ca_step",
    "rollout",
    "seed_state",
    "to_rgb",
    "ca_params_from_jax",
    "ca_params_to_jax",
    "save_ca",
    "load_ca",
]
