"""Run-state checkpointing (JAX counterpart: maua_style_tpu/engine/checkpoint.py).

Long optimisations can checkpoint (pastiche, optimizer state, window index,
iteration) every ``--checkpoint_every`` iterations, so an interrupted
L-BFGS run resumes with its curvature history intact instead of re-warming
from pixels alone.  The state is one ``torch.save`` file, ``state.pt``, in
the run-state directory (``{output}_{size}_runstate``, the JAX package's
name); a save writes a sibling ``.tmp`` directory and renames it over the
old one.
"""

from __future__ import annotations

import os
import pickle
import shutil

import torch

_FILE = "state.pt"


def save_state(path: str, pastiche: torch.Tensor, opt_state: dict, window: int, done_iters: int) -> None:
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    state = {
        "pastiche": pastiche.detach().cpu(),
        "opt_state": {k: v.detach().cpu() for k, v in opt_state.items()},
        "window": int(window),
        "done_iters": int(done_iters),
    }
    torch.save(state, os.path.join(tmp, _FILE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def load_state(path: str, like_pastiche: torch.Tensor, like_opt_state: dict):
    """(pastiche, opt_state, window, done_iters) on the template's device, or
    None when there is no checkpoint or it does not fit the templates."""
    fname = os.path.join(os.path.abspath(path), _FILE)
    if not os.path.exists(fname):
        return None
    try:
        state = torch.load(fname, map_location="cpu", weights_only=True)
    except (OSError, RuntimeError, EOFError, pickle.UnpicklingError) as e:
        print(f"Warning: could not restore run checkpoint {path}: {e}")
        return None
    opt = state["opt_state"]
    fits = state["pastiche"].shape == like_pastiche.shape and set(opt) == set(like_opt_state) and all(
        opt[k].shape == v.shape and opt[k].dtype == v.dtype for k, v in like_opt_state.items()
    )
    if not fits:
        print(f"Warning: run checkpoint {path} does not match this run's shapes; starting fresh")
        return None
    dev = like_pastiche.device
    return (
        state["pastiche"].to(dev),
        {k: v.to(dev) for k, v in opt.items()},
        state["window"],
        state["done_iters"],
    )


__all__ = ["save_state", "load_state"]
