"""Neural-CA texture training (JAX counterpart:
maua_style_tpu/pipelines/nca_train.py; reference NCA_train.py:197-256).

Sample-pool training: a pool of 1024 CA states on the device, batches of 4,
a zero seed reinjected every 32 steps, 32-96 CA steps a rollout; the loss is
the MSE of VGG-16 Grams (relu{1..5}_1, ImageNet normalisation, batch-averaged)
against the style image's, on the unclipped RGB channels; each gradient is
normalised per tensor; Adam 1e-3, x0.3 at steps 2000 and 4000; 7500 steps,
a checkpoint and a tile grid every 500.

The Grams run through ``ops/gram._GramFn``: the hand-written kernel K1 on a
CUDA device, forward (5 launches a step and 5 for the style target), and its
symmetric backward.  Randomness comes from one ``models.nca.Draws``.

Usage: python -m maua_style_tpu_torch.pipelines.nca_train style.png out_dir/ [--gpu c]
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch
from PIL import Image

from ..engine.lbfgs import Adam
from ..engine.optimize import resolve_device
from ..models import nca
from ..models.conv_plans import apply_precision
from ..models.extractor import Extractor, truncate_spec
from ..models.registry import load_params, select_model
from ..ops.gram import _GramFn
from ..utils import name

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STYLE_LAYERS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")
LR_BOUNDARIES = (2000, 4000)


def _build_style_fn(model_file: str = "vgg16", allow_random: bool | None = None, device=None):
    """``calc_styles``: (B, 3, H, W) RGB in [0, 1] -> one (B, C, C) Gram per
    style layer, divided by H·W (reference NCA_train.py:123-136)."""
    device = resolve_device(device)
    spec = truncate_spec(select_model("vgg16", "max"), STYLE_LAYERS)
    extractor = Extractor(spec, load_params(spec, model_file, allow_random=allow_random)).to(device).eval()
    mean = torch.tensor(IMAGENET_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=device).view(1, 3, 1, 1)
    layers = STYLE_LAYERS

    def calc_styles(imgs01: torch.Tensor) -> list[torch.Tensor]:
        acts = extractor((imgs01 - mean) / std, layers)
        grams = []
        for layer in layers:
            a = acts[layer]
            b, c, h, w = a.shape
            grams.append(_GramFn.apply(a.reshape(b, c, h * w)) / (h * w))
        return grams

    return calc_styles


def style_loss(grams_x, grams_y) -> torch.Tensor:
    loss = 0.0
    for x, y in zip(grams_x, grams_y):
        loss = loss + torch.mean(torch.square(x - y))
    return loss


def learning_rate(count: int) -> float:
    """``optax.piecewise_constant_schedule(1e-3, {2000: 0.3, 4000: 0.3})`` at
    ``count``, the number of updates made before this one (optax reads its
    count before the update): 1e-3 for the first 2000 updates."""
    lr = 1e-3
    for boundary in LR_BOUNDARIES:
        if count >= boundary:
            lr *= 0.3
    return lr


def normalized_adam_update(params: dict, grads: dict, adam: Adam, opt_state: dict, count: int) -> dict:
    """Each gradient scaled to unit norm (g / (|g| + 1e-8)), then one Adam
    step at ``learning_rate(count)``; ``opt_state`` is updated in place."""
    lr = learning_rate(count)
    out = {}
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k] / (torch.linalg.vector_norm(grads[k]) + 1e-8)
            upd, opt_state[k] = adam.update(g, opt_state[k])
            out[k] = p + upd * lr
    return out


def train_step(params: dict, adam: Adam, opt_state: dict, pool: torch.Tensor, draws: nca.Draws, step: int,
               calc_styles, target_grams, *, batch_size: int, min_rollout: int, max_rollout: int):
    """One pool step: gather a batch, reinject a zero seed every 32 steps,
    roll out a drawn number of CA steps, take the loss's gradient, update,
    scatter the batch back.  Returns (params, loss, batch after the rollout),
    the loss and batch on the device."""
    idx = draws.batch(pool.shape[0], batch_size)
    x = pool[idx]
    if step % 32 == 0:  # seed reinjection (NCA_train.py:219-220)
        x[0] = 0
    n = draws.steps(min_rollout, max_rollout)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    x_out = nca.rollout(leaves, x, draws, n)
    # The loss sees the unclipped RGB channels (NCA_train.py:224-229 clips
    # only the saved images): the Gram MSE's quartic growth in the pixel
    # scale is the force that keeps the CA state bounded.
    grams = [g.mean(0) for g in calc_styles(nca.to_rgb(x_out))]
    loss = style_loss(grams, target_grams)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    params = normalized_adam_update(leaves, grads, adam, opt_state, step)
    x_out = x_out.detach()
    pool[idx] = x_out
    return params, loss.detach(), x_out


def train(
    style_file: str,
    out_dir: str,
    *,
    n_steps: int = 7500,
    pool_size: int = 1024,
    batch_size: int = 4,
    grid_size: int = 128,
    chn: int = 12,
    seed: int = 0,
    log_every: int = 10,
    save_every: int = 500,
    model_file: str = "vgg16",
    allow_random_weights: bool | None = None,
    min_rollout: int = 32,
    max_rollout: int = 96,
    device=None,
    draws: nca.Draws | None = None,
):
    """Train a CA on ``style_file``; returns (params, per-step losses).
    Runs on CUDA device 0 unless ``device`` names another (``"cpu"``); the
    draws come from ``nca.Draws(seed, device)`` unless given."""
    device = resolve_device(device)
    apply_precision("highest")  # f32 convolutions and products, no TF32
    os.makedirs(out_dir, exist_ok=True)
    img = Image.open(style_file).convert("RGB")
    img.thumbnail((128, 128), Image.LANCZOS)
    style01 = torch.from_numpy(np.asarray(img, np.float32)[None] / 255.0).permute(0, 3, 1, 2).contiguous().to(device)

    calc_styles = _build_style_fn(model_file, allow_random_weights, device)
    with torch.no_grad():
        target_grams = [g[0] for g in calc_styles(style01)]

    params = nca.init_ca_params(chn=chn, seed=seed, device=device)
    adam = Adam(1.0)  # the schedule scales its unit-rate step
    opt_state = {k: adam.init(v) for k, v in params.items()}
    pool = nca.seed_state(pool_size, grid_size, chn, device=device)
    draws = nca.Draws(seed, device) if draws is None else draws

    loss_log: list[float] = []
    stem = name(style_file)
    boundaries = [v for v in (log_every, save_every) if v]
    chunk = math.gcd(*boundaries) if boundaries else n_steps
    pending: list[torch.Tensor] = []  # this chunk's losses, read once at its end
    x_out = None
    for step in range(n_steps):
        params, loss, x_out = train_step(params, adam, opt_state, pool, draws, step, calc_styles, target_grams,
                                         batch_size=batch_size, min_rollout=min_rollout, max_rollout=max_rollout)
        pending.append(loss)
        done = step + 1
        if done % chunk and done != n_steps:
            continue
        losses = torch.stack(pending).double().cpu().numpy()
        pending.clear()
        if not np.isfinite(losses).all():
            # fail loud: a NaN loss means the rollout or the feature net
            # overflowed, and would poison every artifact downstream
            bad = int(np.flatnonzero(~np.isfinite(losses))[0])
            raise FloatingPointError(
                f"non-finite NCA training loss at step {done - len(losses) + bad + 1} (losses[{bad}] = {losses[bad]})"
            )
        loss_log.extend(losses.tolist())
        if log_every and (done % log_every == 0 or done == n_steps):
            recent = loss_log[-200:]
            print(
                f"\rstep_n: {len(loss_log):5d}  loss: [{np.min(recent):.3f}, {np.mean(recent):.3f}, "
                f"{np.max(recent):.3f}]    lr: {learning_rate(done - 1):g}"
            )
        if save_every and done % save_every == 0:
            nca.save_ca(params, f"{out_dir}/{stem}_{len(loss_log)}.npz")
            imgs = np.clip(nca.to_rgb(x_out).permute(0, 2, 3, 1).cpu().numpy(), 0, 1)
            Image.fromarray((np.hstack(list(imgs)) * 255).astype(np.uint8)).save(f"{out_dir}/{stem}_{len(loss_log)}.png")
    return params, loss_log


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    import argparse

    from ..config import single_device

    ap = argparse.ArgumentParser("nca_train")
    ap.add_argument("style_file")
    ap.add_argument("out_dir")
    ap.add_argument("--n_steps", type=int, default=7500)
    ap.add_argument("--pool_size", type=int, default=1024)
    ap.add_argument("--grid_size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model_file", type=str, default="vgg16")
    ap.add_argument("--allow_random_weights", action="store_true")
    ap.add_argument("--gpu", type=str, default="0", help="CUDA device id '0', or 'c' for the CPU")
    args = ap.parse_args(argv)
    train(
        args.style_file,
        args.out_dir,
        n_steps=args.n_steps,
        pool_size=args.pool_size,
        grid_size=args.grid_size,
        seed=args.seed,
        model_file=args.model_file,
        allow_random_weights=args.allow_random_weights or None,
        device=single_device(args, "nca_train", "JAX's CLI takes no device and runs on one"),
    )


if __name__ == "__main__":
    main()
