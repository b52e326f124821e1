"""The Gram-style comparison that decides ``correct`` for the ``style``
judge's cells (``judges/style.py`` calls ``judge``).

A unit's answer is one or more optimised scales, each with the content,
style and init the program optimised from, its loss log and its result.
For each scale the plain reference (``reference/style.py``) captures its
own targets from that content and style, starts from that init, and runs
the same number of steps:

- ``loss_gap``: the largest relative gap between a term the program logged
  and the reference's, over the first ``compare_iters`` steps of every
  scale.  Before the steps follow the rounding it holds the feature net,
  the content, style (K1) and TV terms, the gradient and the optimiser's
  update.
- ``step_gap`` (where ``step_iters`` > 0: the L-BFGS cells): the same gap
  over the ``step_iters`` steps after those.  L-BFGS's first step is
  min(1, 1/|g|₁)·lr, too short to move a term past rounding; its second,
  scaled by the first (s, y) pair, is the first whole step, and from it
  on the two sides follow their rounding, so this limit is looser.
- ``answer_gap``: by how much the reference's objective J (the one whose
  gradient both sides follow) at the program's result exceeds J at the
  reference's own result, relative to the latter, over the scales.  It
  holds the result itself against an answer altered where it is produced
  or steps that leave the pastiche unchanged.
- ``last_gap`` (where a scale carries ``last_update``, the optimiser's
  update of its last step: the cells whose ``answer_gap`` the rounding
  swamps): the result less that update is where the program's last step
  started; the largest relative gap between the reference's terms there
  and the program's last logged terms.  It holds the result against an
  answer altered where it is produced, tight as ``loss_gap``.
- ``host_gap`` (where a scale carries the reference's own ``host``
  inputs: the pyramid): the largest relative gap, max|Δ| / max|reference|,
  between what the program optimised from and what the reference works
  out itself: each scale's content and style (bilinear resize of the
  colour-matched content and of the style), each later scale's init (the
  previous result colour-matched, resized, matched again), and for the
  first scale's init, the program's own random draw, the gap of its
  channel means to the style's (what matching guarantees there).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import style as ref

DIAGNOSTIC_ITERS = 8  # steps whose gaps are reported, compared or not


def rel_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def colour_mean_gap(init: np.ndarray, style: np.ndarray) -> float:
    """The gap of ``init``'s channel means to the style's, relative to the
    style's largest channel deviation: matching moves the mean exactly
    (its covariance only where the init's own exceeds the 1e-2 the
    matching adds to it, which random noise of 1e-3 does not)."""
    i, s = (np.asarray(x, np.float64).reshape(-1, 3) for x in (init, style))
    return float(np.abs(i.mean(axis=0) - s.mean(axis=0)).max() / s.std(axis=0).max())


def host_gap(sc: dict) -> float:
    h = sc["host"]
    gaps = [rel_gap(sc["content"], h["content"]), rel_gap(sc["style"], h["style"])]
    gaps.append(rel_gap(sc["init"], h["init"]) if h["init"] is not None else colour_mean_gap(sc["init"], h["style_big"]))
    return max(gaps)


def judge(cfg: dict, weights: dict, scales, device, compare_iters: int, step_iters: int = 0) -> dict:
    """Run the reference over each scale of ``scales`` (dicts with
    ``content``, ``style`` and ``init`` as (1, H, W, 3) host arrays, the
    ``iters``, the program's ``log`` and ``out``, and for the pyramid the
    reference's own ``host`` inputs); returns {number: value} and
    ``per_scale`` details."""
    ref.precise()
    out_numbers = {"loss_gap": 0.0, "answer_gap": -math.inf}
    if step_iters:
        out_numbers["step_gap"] = 0.0
    if any("host" in sc for sc in scales):
        out_numbers["host_gap"] = 0.0
    rows = []
    for sc in scales:
        row = {"hw": list(np.shape(sc["init"])[1:3]), "iters": sc["iters"]}
        if "host" in sc:
            row["host_gap"] = host_gap(sc)
            out_numbers["host_gap"] = max(out_numbers["host_gap"], row["host_gap"])
        log, out = np.asarray(sc["log"], np.float64), np.asarray(sc["out"], np.float32)
        if log.shape[0] != sc["iters"] or not (np.isfinite(log).all() and np.isfinite(out).all()):
            rows.append({**row, "finite": False})
            out_numbers.update({k: math.inf for k in out_numbers if k != "host_gap"})
            continue
        obj = ref.Objective(cfg, weights, ref.nchw(sc["content"], device), ref.nchw(sc["style"], device))
        ref_log, ref_out = ref.optimise(obj, ref.nchw(sc["init"], device), sc["iters"], cfg["optimizer"],
                                        cfg["learning_rate"], cfg.get("lbfgs_history", 0))
        n_terms = ref_log.shape[1]
        # columns past the reference's terms (the program logs a temporal
        # term for every transfer type) must be zero
        extra = np.abs(log[:, n_terms:]).max() if log.shape[1] > n_terms else 0.0
        k = min(DIAGNOSTIC_ITERS, sc["iters"])
        prog, want = log[:k, :n_terms], ref_log[:k]
        both_zero = (prog == 0) & (want == 0)
        by_iter = np.where(both_zero, 0.0, np.abs(prog - want) / np.maximum(np.abs(want), 1e-30)).max(axis=1)
        if extra > 0:
            by_iter[:] = math.inf
        if "last_update" in sc:
            before, _ = obj.terms(ref.nchw(out - np.asarray(sc["last_update"], np.float32), device))
            before = before.double().cpu().numpy()
            row["last_gap"] = float((np.abs(log[-1, :n_terms] - before) / np.maximum(np.abs(before), 1e-30)).max())
            out_numbers["last_gap"] = max(out_numbers.get("last_gap", 0.0), row["last_gap"])
        _, j_prog = obj.terms(ref.nchw(out, device))
        _, j_ref = obj.terms(ref_out)
        a_gap = (j_prog - j_ref) / j_ref
        a_gap = a_gap if math.isfinite(a_gap) else math.inf
        out_numbers["loss_gap"] = max(out_numbers["loss_gap"], float(by_iter[:compare_iters].max()))
        if step_iters:
            out_numbers["step_gap"] = max(out_numbers["step_gap"],
                                          float(by_iter[compare_iters : compare_iters + step_iters].max()))
        out_numbers["answer_gap"] = max(out_numbers["answer_gap"], a_gap)
        rows.append({**row, "loss_gap_by_iter": by_iter.tolist(), "j_program": j_prog, "j_reference": j_ref,
                     "answer_gap": a_gap})
        del obj, ref_out
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return {**out_numbers, "per_scale": rows}
