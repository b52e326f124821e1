"""Faults planted under the timed path, to show that the comparison
deciding ``correct`` catches them (``tests/test_bench_faults.py`` on the
CPU, ``calibrate.py --fault`` on a card).  Each is a list of ``patched``
targets; the program's files are not touched.  These four are the Gram-
style cells'; a configuration with a judge of its own brings its faults
in that judge's ``FAULTS``, where ``patches`` looks for a name not here.

- ``unchanged``: every optimiser step returns a zero update and its state
  as it was: the pastiche never moves.
- ``altered``: the top half of ``StyleEngine.optimize``'s result is left
  at its init: an answer altered where it is produced.
- ``nearest_resize``: the pyramid's host resize takes the nearest pixel
  instead of interpolating.
- ``no_matching``: the pyramid's colour histogram matching returns its
  input.

``names(cell)`` says which faults a cell is held to."""

from __future__ import annotations

import numpy as np
import torch


def _unchanged(fn, opt, g, state):
    zero = [torch.zeros_like(x) for x in g] if isinstance(g, list) else torch.zeros_like(g)
    return zero, state


def _altered(fn, engine, content, styles, init, num_iters, **kw):
    out = fn(engine, content, styles, init, num_iters, **kw).copy()
    half = out.shape[1] // 2
    out[:, :half] = np.asarray(init)[:, :half]
    return out


def _nearest(fn, x, size=None, scale_factor=None):
    h, w = x.shape[-3], x.shape[-2]
    if size is None:
        size = (int(h * scale_factor), int(w * scale_factor))
    rows = np.minimum((np.arange(size[0]) * h) // size[0], h - 1)
    cols = np.minimum((np.arange(size[1]) * w) // size[1], w - 1)
    return np.asarray(x)[..., rows, :, :][..., :, cols, :]


def _no_matching(fn, target, source, **kw):
    return np.asarray(target, np.float32)


def patches(name: str) -> list:
    from maua_style_tpu_torch.engine import LBFGS, Adam, StyleEngine
    from maua_style_tpu_torch.pipelines import img_img

    own = {
        "unchanged": [(LBFGS, "update", _unchanged), (Adam, "update", _unchanged)],
        "altered": [(StyleEngine, "optimize", _altered)],
        "nearest_resize": [(img_img, "resize_bilinear_np", _nearest)],
        "no_matching": [(img_img, "match_histogram", _no_matching)],
    }
    if name in own:
        return own[name]
    from .harness import judge_module, judge_names

    for judge in judge_names():
        found = getattr(judge_module(judge), "FAULTS", {})
        if name in found:
            return found[name]()
    raise KeyError(f"no fault {name!r} in faults.py or in any judge's FAULTS")


def names(cell: dict) -> tuple:
    """The faults ``cell`` can have, by its judge: a ``style`` cell
    ``unchanged`` and ``altered``, and its runner's ``STYLE_FAULTS``; a cell
    of any other judge that judge's ``FAULTS``, and those of this file's
    that it lists in ``SHARED_FAULTS`` (the paths its runner drives)."""
    from .harness import judge_module, judge_name, runner

    name = judge_name(cell)
    if name == "style":
        return ("unchanged", "altered") + tuple(getattr(runner(cell["traffic"]), "STYLE_FAULTS", ()))
    judge = judge_module(name)
    return tuple(getattr(judge, "FAULTS", {})) + tuple(getattr(judge, "SHARED_FAULTS", ()))
