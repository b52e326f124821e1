"""PCA-based colour/histogram matching (JAX counterpart:
maua_style_tpu/ops/histogram.py; reference: utils.py:88-151).

Recolours a target so its per-channel covariance matches the source's:
with channel covariances Ct, Cs and their symmetric square roots Qt, Qs,
centred pixels t map through Qs @ Qt^-1.  Runs once per scale on 3x3
matrices, in numpy on the host.  It consumes the global numpy RNG in the
same order as the JAX package, so ``--seed`` reproduces a JAX run.

- mode in (False, None): no-op.
- mode == "avg": per-frame matching against the mean source frame.
- any other truthy mode: whole-tensor matching against one random source
  frame (the default path — ``match_histograms`` is True unless
  --no_hist_match).

Numerical failure falls back to the unmatched input, like the reference.
"""

from __future__ import annotations

import traceback

import numpy as np


def _channel_stats(x: np.ndarray, eps: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """x: (..., C) -> per-channel mean, centred (C, N) matrix, covariance (C, C)."""
    c = x.shape[-1]
    mu = x.reshape(-1, c).mean(axis=0)
    h = (x.reshape(-1, c) - mu).T  # (C, N)
    cov = h @ h.T / h.shape[1] + eps * np.eye(c, dtype=x.dtype)
    return mu, h, cov


def _sqrt_psd(cov: np.ndarray) -> np.ndarray:
    eva, eve = np.linalg.eigh(cov)
    root = np.sqrt(np.maximum(eva, 0.0))
    return (eve * root) @ eve.T


def match_histogram(target, source, eps: float = 1e-2, mode="avg", rng: np.random.Generator | None = None, jitter: float = 1e-3):
    """Match target's colour statistics to source's.

    target: (B, H, W, C) float array.  source: same layout, or a list of
    them (multi-style blending averages the matched results).
    """
    if not mode:
        return target
    target = np.asarray(target, dtype=np.float32)
    backup = target.copy()
    rng = rng or np.random.default_rng(np.random.randint(2**31))
    elementwise = mode == "avg"
    sources = source if isinstance(source, list) else [source]
    try:
        out = np.zeros_like(target)
        for src in sources:
            src = np.asarray(src, dtype=np.float32)
            if elementwise:
                src_frames = src.mean(axis=0, keepdims=True)
            else:
                src_frames = src[rng.integers(0, src.shape[0])][None]

            matched = np.zeros_like(target)
            n_iter = target.shape[0] if elementwise else 1
            for idx in range(n_iter):
                frame = target[idx][None] if elementwise else target
                # jitter guards the eigendecomposition against singular covariances
                _, t, ct = _channel_stats(frame + jitter * rng.standard_normal(frame.shape).astype(np.float32), eps)
                mu_s, _, cs = _channel_stats(
                    src_frames + jitter * rng.standard_normal(src_frames.shape).astype(np.float32), eps
                )
                qt = _sqrt_psd(ct)
                qs = _sqrt_psd(cs)
                ts = qs @ np.linalg.inv(qt) @ t  # (C, N)
                match = ts.T.reshape(frame.shape) + mu_s
                if elementwise:
                    matched[idx] = match[0]
                else:
                    matched = match
            out += matched / len(sources)
        return out
    except np.linalg.LinAlgError:
        traceback.print_exc()
        print("Skipping histogram matching...")
        return backup


__all__ = ["match_histogram"]
