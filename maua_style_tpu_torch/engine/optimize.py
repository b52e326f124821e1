"""StyleEngine — the pixel-optimisation core (JAX counterpart:
maua_style_tpu/engine/optimize.py; reference: optim.py:111-255).

One engine holds the feature net on its device and the loss configuration;
pipelines create an engine per scale and call :meth:`optimize` per image.
An iteration runs the extractor forward, the losses, the backward and the
optimiser update on the device; the per-loss values of every iteration stay
on the device until the end of a chunk (``save_iter`` / ``checkpoint_every``
/ ``print_iter``), so the loop never waits on the host in between.

Host arrays in and out are the JAX package's (1, H, W, 3) Caffe-BGR
layout; the engine works in NCHW.

Precision: ``highest`` turns TF32 off for both matmul and cuDNN (cuDNN
allows it by default); ``high`` and ``default`` allow TF32.
``compute_dtype=torch.bfloat16`` runs the feature net in bf16; the Grams,
the losses, the optimiser and the pastiche stay f32 (the L-BFGS histories
then store bf16, as in the JAX package's serving config).

The vid_img frame path (``prep_frame``, ``optimize_frame``,
``optimize_frames``, ``optimize_frame_chain``) keeps every frame on the
device: a uint8 frame goes up, the pastiche chains to the next frame as a
tensor, and a uint8 image comes back.  ``optimize_frames`` runs a chunk of
independent frames as one stacked step per iteration, as JAX's ``vmap``
does: one extractor forward and backward over the stack, each style
layer's Grams in one kernel launch, and per-frame content targets, losses,
gradient normalisation and optimiser state.  ``optimize_frame_chain``
keeps JAX's signature and results, but where JAX runs one ``lax.scan``
program it loops over ``optimize_frame`` on the host.

img_vid (``transfer_type="img_vid"``) optimises a T-frame pastiche in
circular ``gram_frame_window`` windows (``engine/windows.py``): the whole
pastiche stays on the host, each window goes up, runs, and is scattered
back.  Windows after the first freeze the frames earlier windows styled,
by a gradient mask or, without run-state checkpoints, by the frozen-split
runner (``_run``).  JAX's fused pyramid program (``optimize_pyramid``) only
saves TPU executable loads and is not ported.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..losses import (
    LossConfig,
    capture_content_targets,
    capture_style_targets,
    capture_style_video_targets,
    capture_temporal_targets,
    evaluate_frame_losses,
    evaluate_losses,
)
from ..models.extractor import Extractor, ExtractorSpec, truncate_spec
from ..ops.frame_ops import deprocess_to_u8, match_histogram_device, preprocess_u8, warp_map_from_flow
from ..ops.resize import resize_bilinear, scale_shape
from ..ops.warp import grid_sample
from .checkpoint import load_state, save_state
from ..utils import wrapping_indices
from .lbfgs import Adam, LBFGS
from .windows import compute_windows, overlap_grad_mask, window_overlaps

# img_vid's frozen-split window runner (see _run); False selects the masked
# runner, so that a test can compare the two
_WINDOW_SPLIT = True

_TF32 = {"highest": False, "high": True, "default": True}


def to_nchw(x, device) -> torch.Tensor:
    """(B, H, W, C) host array -> (B, C, H, W) f32 tensor on ``device``."""
    arr = np.ascontiguousarray(np.transpose(np.asarray(x, np.float32), (0, 3, 1, 2)))
    return torch.from_numpy(arr).to(device)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    """(B, C, H, W) tensor -> (B, H, W, C) f32 host array."""
    return t.detach().float().permute(0, 2, 3, 1).cpu().numpy()


def apply_precision(precision: str) -> None:
    """``highest`` turns TF32 off for matmul and cuDNN; ``high`` and
    ``default`` allow it.  The flags are process-wide."""
    if precision not in _TF32:
        raise ValueError(f"unknown precision {precision!r}; one of {sorted(_TF32)}")
    torch.backends.cuda.matmul.allow_tf32 = _TF32[precision]
    torch.backends.cudnn.allow_tf32 = _TF32[precision]


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA device 0 unless the caller names another;
    a CUDA device without CUDA raises."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("StyleEngine: a CUDA device was asked for but torch.cuda.is_available() is False; "
                           "pass device='cpu' (--gpu c) to run on the CPU")
    return device


class StyleEngine:
    def __init__(
        self,
        spec: ExtractorSpec,
        params: dict[str, torch.Tensor],
        loss_cfg: LossConfig,
        *,
        optimizer: str = "lbfgs",
        learning_rate: float = 1.0,
        lbfgs_history: int = 100,
        lbfgs_method: str = "compact",
        precision: str = "highest",
        normalize_weights: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        apply_precision(precision)
        if optimizer not in ("lbfgs", "adam"):
            raise ValueError(f"unknown optimizer {optimizer}")
        self.device = resolve_device(device)
        self.loss_cfg = loss_cfg
        self.spec = truncate_spec(spec, loss_cfg.all_layers)
        self.extractor = Extractor(self.spec, params).to(device=self.device, dtype=compute_dtype).eval()
        self.optimizer_name = optimizer
        self.learning_rate = learning_rate
        self.lbfgs_history = lbfgs_history
        self.lbfgs_method = lbfgs_method
        self.precision = precision
        self.normalize_weights = normalize_weights
        self.compute_dtype = compute_dtype
        self.last_loss_log: np.ndarray | None = None
        # one capture per engine (engines live per scale); per-frame callers
        # pass the same style images every call
        self._style_target_cache: dict[Any, dict] = {}

    def _extract(self, x: torch.Tensor, layers: Sequence[str]) -> dict[str, torch.Tensor]:
        return self.extractor(x.to(self.compute_dtype), layers)

    # -- target capture ----------------------------------------------------

    def content_targets(self, content) -> dict[str, torch.Tensor]:
        return capture_content_targets(self._extract, to_nchw(content, self.device), self.loss_cfg)

    def style_targets(self, styles: Sequence, blend_weights: Sequence[float]) -> dict[str, torch.Tensor]:
        # content-addressed cache of the blended Gram targets
        key = tuple((np.shape(s), float(bw), hash(np.asarray(s).tobytes())) for s, bw in zip(styles, blend_weights))
        hit = self._style_target_cache.get(key)
        if hit is not None:
            return hit
        targets = capture_style_targets(
            self._extract, [to_nchw(s, self.device) for s in styles], blend_weights, self.loss_cfg
        )
        self._style_target_cache.clear()
        self._style_target_cache[key] = targets
        return targets

    def style_video_targets(
        self, style_videos: Sequence, blend_weights: Sequence[float], gram_frame_window: int
    ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        """Static and dynamic targets averaged over every window of each
        (T, H, W, 3) style video (JAX optimize.py:162-179), under no-grad."""
        videos = [to_nchw(v, self.device) for v in style_videos]
        return capture_style_video_targets(self._extract, videos, blend_weights, self.loss_cfg, int(gram_frame_window))

    def _set_style_video_targets(self, targets: dict, style_videos, blend_weights, gfw: int) -> None:
        static, dynamic = self.style_video_targets(style_videos, blend_weights, gfw)
        targets["style"] = static
        if dynamic:
            targets["style_video"] = dynamic

    # -- strength normalisation (reference optim.py:176-178) ----------------

    def _strength_scale(self, targets: dict) -> tuple[tuple[str, float], ...]:
        if not self.normalize_weights:
            return ()
        scale = []
        for l, t in targets.get("content", {}).items():
            scale.append((f"content:{l}", 1.0 / max(t.shape)))
        for l, t in targets.get("style", {}).items():
            scale.append((f"style:{l}", 1.0 / max(t.shape)))
        temporal = targets.get("temporal")
        if temporal is not None:
            scale.append(("temporal", 1.0 / max(temporal["target"].shape)))
        return tuple(scale)

    # -- the optimisation loop ---------------------------------------------

    def _make_optimizer(self, frames: bool = False) -> LBFGS | Adam:
        """``frames``: the pastiche's leading dim stacks independent frames,
        each with its own L-BFGS state (Adam is elementwise)."""
        if self.optimizer_name == "lbfgs":
            # bf16 activations also store the L-BFGS histories in bf16
            hdt = torch.bfloat16 if self.compute_dtype == torch.bfloat16 else None
            return LBFGS(self.learning_rate, self.lbfgs_history, method=self.lbfgs_method, history_dtype=hdt,
                         frames=frames)
        return Adam(self.learning_rate)

    def _run(self, pastiche, opt, opt_state, targets, scale, n_iters, *, mask=None, frozen=None, frames=False):
        """``n_iters`` steps; returns (pastiche, opt_state, (n_iters, n_losses) log).

        ``frames``: the pastiche stacks independent frames (vid_img's first
        pass, ``optimize_frames``); the losses are each frame's own
        (``evaluate_frame_losses``) and the log is (n_iters, B, n_losses).

        img_vid's window runners (JAX optimize.py:235-341): ``mask``, a
        (T, 1, 1, 1) tensor, multiplies the gradient before the optimiser
        update.  ``frozen=(fo, eo)`` is the frozen split: the first ``fo``
        and last ``eo`` frames of the window have a zero gradient, so they
        never move (Adam's moments stay zero there, and so does every
        L-BFGS (s, y) pair).  Their activations are extracted once, under
        no-grad; each iteration runs forward and backward on the middle
        slice alone, the losses see the activations concatenated in window
        order, and ``opt_state`` covers the middle slice only."""
        cfg = self.loss_cfg
        logs = []
        p, fixed = pastiche, None
        if frozen is not None:
            fo, eo = frozen
            t_w = pastiche.shape[0]
            front, end, p = pastiche[:fo], pastiche[t_w - eo :], pastiche[fo : t_w - eo]
            with torch.no_grad():
                fixed = self._extract(torch.cat([front, end]), cfg.all_layers)
        for _ in range(n_iters):
            p = p.detach().requires_grad_(True)
            acts, full = self._extract(p, cfg.all_layers), p
            if fixed is not None:
                acts = {l: torch.cat([fixed[l][:fo], a, fixed[l][fo:]]) for l, a in acts.items()}
                full = torch.cat([front, p, end])
            total, per = (evaluate_frame_losses if frames else evaluate_losses)(full, acts, targets, cfg, scale)
            (grad,) = torch.autograd.grad(total, p)
            grad = grad.float() if mask is None else grad.float() * mask
            upd, opt_state = opt.update(grad, opt_state)
            p = p.detach() + upd
            logs.append(per.detach())
        if fixed is not None:
            p = torch.cat([front, p, end])
        log = torch.stack(logs) if logs else p.new_zeros((0, *p.shape[:frames], len(cfg.loss_names())))
        return p, opt_state, log

    def _iterate(self, p, opt, st, targets, scale, num_iters, done, after_chunk, *, save_iter, print_iter,
                 checkpoint_every, profile_dir, mask=None, frozen=None):
        """Iterations ``done`` .. ``num_iters`` in chunks of ``save_iter``,
        ``checkpoint_every`` and ``print_iter``; the loss values stay on the
        device within a chunk.  ``after_chunk(p, st, done)`` runs after each
        chunk but the last.  Returns (p, st, [each chunk's host log])."""
        chunk = num_iters if save_iter <= 0 else save_iter
        if checkpoint_every > 0:
            chunk = min(chunk, checkpoint_every)
        if print_iter > 0:
            chunk = min(chunk, print_iter)
        logs = []
        while done < num_iters:
            this = min(chunk, num_iters - done)
            if profile_dir is not None:
                p, st, log = self._profiled_run(profile_dir, p, opt, st, targets, scale, this, mask=mask, frozen=frozen)
                profile_dir = None
            else:
                p, st, log = self._run(p, opt, st, targets, scale, this, mask=mask, frozen=frozen)
            done += this
            logs.append(log.cpu().numpy())
            if print_iter > 0 and (done // print_iter > (done - this) // print_iter or done == num_iters):
                # fire on crossing each print_iter boundary (reference optim.py:228-229)
                print(f"Iteration {done} / {num_iters}, Loss: {float(logs[-1][-1].sum()):g}")
            if done < num_iters:
                after_chunk(p, st, done)
        return p, st, logs

    def optimize(
        self,
        content,
        styles: Sequence,
        init,
        num_iters: int,
        *,
        transfer_type: str = "img_img",
        blend_weights: Sequence[float] | None = None,
        gram_frame_window: int | None = None,
        avg_frame_window: int = -1,
        temporal_target=None,
        temporal_weights=None,
        temporal_warp=None,
        save_iter: int = 0,
        save_callback: Callable[[np.ndarray, int], None] | None = None,
        run_checkpoint: str | None = None,
        checkpoint_every: int = 0,
        profile_dir: str | None = None,
        print_iter: int = 0,
    ) -> np.ndarray:
        """Optimise a (1, H, W, 3) pastiche, or for img_vid a (T, H, W, 3)
        one, against content + style targets; returns the result as a host
        array.

        ``run_checkpoint``: directory for interruptible runs — saves the
        pastiche (img_vid: and the whole output), the optimizer state, the
        window and the iteration at every chunk end and resumes with the
        optimizer state intact.  ``profile_dir``: a ``torch.profiler``
        chrome trace of the first chunk.

        vid_img's host path (``--original_colors``) passes its temporal
        target as ``temporal_warp=(prev_frame, warp_map)``, warped here on
        the device, with ``temporal_weights``, the (1, H, W, 1) reliability;
        ``temporal_target`` is an already warped target.

        img_vid: ``gram_frame_window`` frames a window; ``avg_frame_window``
        -1 averages the style targets over whole style videos, else over an
        ``avg_frame_window``-frame stretch of each style per window.
        ``save_callback`` gets the window's pastiche numbered
        ``w * num_iters + done``.
        """
        if transfer_type not in ("img_img", "vid_img", "img_vid"):
            raise ValueError(f"unknown transfer_type {transfer_type!r}")
        blend_weights = list(blend_weights) if blend_weights is not None else [1.0 / max(len(styles), 1)] * len(styles)
        targets = {"content": self.content_targets(content)}
        weights = None if temporal_weights is None else to_nchw(temporal_weights, self.device)
        if temporal_warp is not None:
            src, wmap = temporal_warp
            warped = grid_sample(to_nchw(src, self.device), _on(np.asarray(wmap, np.float32), self.device))
            targets["temporal"] = capture_temporal_targets(warped, weights)
        elif temporal_target is not None:
            targets["temporal"] = capture_temporal_targets(to_nchw(temporal_target, self.device), weights)
        loop = dict(save_iter=save_iter, print_iter=print_iter, checkpoint_every=checkpoint_every, profile_dir=profile_dir)
        if transfer_type == "img_vid":
            if gram_frame_window is None:
                raise ValueError("img_vid needs gram_frame_window")
            return self._optimize_windows(targets, styles, blend_weights, init, num_iters, int(gram_frame_window),
                                          avg_frame_window, save_callback, run_checkpoint, loop)

        targets["style"] = self.style_targets(styles, blend_weights)
        scale = dict(self._strength_scale(targets))
        pastiche = to_nchw(init, self.device)
        opt = self._make_optimizer()
        opt_state = opt.init(pastiche)
        done = 0
        if run_checkpoint is not None:
            restored = load_state(run_checkpoint, pastiche, opt_state)
            if restored is not None:
                pastiche, opt_state, _, done = restored

        def after_chunk(p, st, done):
            if save_callback is not None:
                save_callback(to_nhwc(p), done)
            if run_checkpoint is not None:
                save_state(run_checkpoint, p, st, 0, done)

        pastiche, _, logs = self._iterate(pastiche, opt, opt_state, targets, scale, num_iters, done, after_chunk, **loop)
        if run_checkpoint is not None:
            shutil.rmtree(run_checkpoint, ignore_errors=True)  # run completed
        self.last_loss_log = np.concatenate(logs, axis=0) if logs else None
        return to_nhwc(pastiche)

    def _optimize_windows(self, targets, styles, blend_weights, init, num_iters, gfw, avg_frame_window,
                          save_callback, run_checkpoint, loop) -> np.ndarray:
        """img_vid's window loop (JAX optimize.py:907-1069)."""
        dev = self.device
        styles = [np.asarray(s, np.float32) for s in styles]
        output = np.array(init, np.float32)  # the whole pastiche stays on the host
        total = output.shape[0]
        windows = compute_windows(total, [s.shape[0] for s in styles], gfw)
        if avg_frame_window == -1:
            self._set_style_video_targets(targets, styles, blend_weights, gfw)
        opt = self._make_optimizer()

        def blob(p):
            return {"pastiche": p, "output": torch.from_numpy(output)}

        resume = None
        if run_checkpoint is not None:
            like = torch.empty((len(wrapping_indices(total, 0, gfw)), 3, *output.shape[1:3]), device=dev)
            # restored to the device of the first template; the state's
            # template only gives shapes and dtypes
            resume = load_state(run_checkpoint, {"pastiche": like, "output": torch.empty(output.shape)},
                                opt.init(like.to("meta")))
            if resume is not None:
                output = resume[0]["output"].cpu().numpy()

        logs = []
        for w, start in enumerate(windows[0]):
            if resume is not None and w < resume[2]:
                continue  # finished before the checkpoint
            front, end = window_overlaps(windows[0], w, start, gfw, total)
            idx = wrapping_indices(total, start, gfw)
            if avg_frame_window != -1:
                current = [
                    s[wrapping_indices(s.shape[0], windows[n + 1][w], avg_frame_window)] if s.shape[0] != 1 else s
                    for n, s in enumerate(styles)
                ]
                self._set_style_video_targets(targets, current, blend_weights, gfw)
            # sized to the actual window: a 1-frame pastiche has 1-frame windows
            t_w = len(idx)
            mask, frozen = None, None
            if w != 0:
                fo, eo = max(0, min(front, t_w)), (min(end, t_w) if end > 0 else 0)
                # a checkpointed run keeps the masked runner: its saved
                # optimizer state then has the whole window's shape
                if run_checkpoint is None and _WINDOW_SPLIT and fo + eo > 0 and t_w - fo - eo > 0:
                    frozen = (fo, eo)
                else:
                    mask = torch.from_numpy(overlap_grad_mask(t_w, w, front, end)).to(dev)
            scale = dict(self._strength_scale(targets))
            pastiche = to_nchw(output[idx], dev)
            opt_state = opt.init(pastiche if frozen is None else pastiche[frozen[0] : t_w - frozen[1]])
            done = 0
            if resume is not None:
                # a checkpoint from a window's end (done 0) starts this window
                # afresh from the saved output (JAX would resume it from the
                # previous window's pastiche and optimizer state)
                if resume[3] > 0:
                    pastiche, opt_state, done = resume[0]["pastiche"], resume[1], resume[3]
                resume = None

            def after_chunk(p, st, done, w=w):
                if save_callback is not None:
                    save_callback(to_nhwc(p), w * num_iters + done)
                if run_checkpoint is not None:
                    save_state(run_checkpoint, blob(p), st, w, done)

            pastiche, opt_state, wlogs = self._iterate(pastiche, opt, opt_state, targets, scale, num_iters, done,
                                                       after_chunk, mask=mask, frozen=frozen, **loop)
            loop["profile_dir"] = None  # the first window's first chunk only
            logs += wlogs
            output[idx] = to_nhwc(pastiche)
            if run_checkpoint is not None and w + 1 < len(windows[0]):
                save_state(run_checkpoint, blob(pastiche), opt_state, w + 1, 0)

        if run_checkpoint is not None:
            shutil.rmtree(run_checkpoint, ignore_errors=True)  # run completed
        self.last_loss_log = np.concatenate(logs, axis=0) if logs else None
        return output

    def _profiled_run(self, profile_dir, *run_args, **run_kw):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            out = self._run(*run_args, **run_kw)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        return out


    # -- the vid_img frame path ---------------------------------------------

    def prep_frame(self, content_u8, out_hw: tuple[int, int], hist_stats=None) -> torch.Tensor:
        """One u8 frame -> the (1, 3, h, w) preprocessed (and histogram-
        matched) tensor that seeds a prev_warp chain (reference
        style.py:223-228)."""
        c = preprocess_u8(_on(content_u8, self.device), size=tuple(out_hw))
        return match_histogram_device(c, *hist_stats) if hist_stats is not None else c

    def optimize_frame(
        self,
        content_u8,
        styles: Sequence,
        num_iters: int,
        *,
        out_hw: tuple[int, int],
        content_scale: float | None = None,
        blend_weights: Sequence[float] | None = None,
        init_mode: str = "content",
        prev=None,
        blend=None,
        temporal_blend: float = 1.0,
        flow=None,
        weights_u8=None,
        use_temporal: bool = False,
        hist_stats=None,
        seed: int = 0,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One vid_img frame on the device (reference style.py:192-297):
        u8 preprocess and resize, histogram match, content target, the
        flow-warped temporal target, the init (``content``, ``random``,
        ``warp_prev`` or ``blend``), ``num_iters`` iterations, the output
        histogram match and the u8 display image.

        ``prev``: the previous frame's pastiche, a (1, 3, h, w) tensor (or a
        (1, h, w, 3) host array), resized if it comes from a smaller scale.
        ``flow``: (H, W, 2) pixel flow; ``weights_u8``: (H, W) reliability.
        Returns ``(pastiche (1, 3, h, w), display (h, w, 3) uint8)``, both
        on the device; ``last_loss_log`` is the (num_iters, n_losses) log,
        also on the device."""
        dev = self.device
        out_hw = tuple(int(v) for v in out_hw)
        blend_weights = list(blend_weights) if blend_weights is not None else [1.0 / max(len(styles), 1)] * len(styles)
        c = self._frame_content(_on(content_u8, dev), out_hw, content_scale, hist_stats)
        targets = {"style": self.style_targets(styles, blend_weights),
                   "content": capture_content_targets(self._extract, c, self.loss_cfg)}
        # the strength scale leaves the temporal term out, as the JAX frame
        # program's does (its key is built from the content image and style)
        scale = dict(self._strength_scale(targets))

        if prev is not None:
            prev = _nchw(prev, dev)
            if tuple(prev.shape[2:]) != out_hw:
                prev = resize_bilinear(prev, size=out_hw)
        wmap = warp_map_from_flow(_on(flow, dev), out_hw) if flow is not None else None
        if use_temporal:
            wts = None
            if weights_u8 is not None:
                wts = resize_bilinear(_on(weights_u8, dev).float()[None, None] / 255.0, size=out_hw)
            targets["temporal"] = capture_temporal_targets(grid_sample(prev, wmap), wts)

        if init_mode == "content":
            p0 = c
        elif init_mode == "random":
            p0 = self._noise(seed, out_hw)
        elif init_mode == "warp_prev":
            p0 = grid_sample(prev, wmap)
        elif init_mode == "blend":
            if blend.dtype in (np.uint8, torch.uint8):  # an artifact PNG's (H, W, 3) pixels
                b = preprocess_u8(_on(blend, dev), size=out_hw)
            else:
                b = resize_bilinear(_nchw(blend, dev), size=out_hw)
            p0 = (1.0 - temporal_blend) * b + temporal_blend * prev
        else:
            raise ValueError(f"unknown init_mode {init_mode!r}")

        opt = self._make_optimizer()
        p, _, log = self._run(p0, opt, opt.init(p0), targets, scale, int(num_iters))
        out = match_histogram_device(p, *hist_stats) if hist_stats is not None else p
        self.last_loss_log = log
        return out, deprocess_to_u8(out)

    def optimize_frames(
        self,
        contents_u8,
        styles: Sequence,
        num_iters: int,
        *,
        out_hw: tuple[int, int],
        content_scale: float | None = None,
        blend_weights: Sequence[float] | None = None,
        init_mode: str = "content",
        hist_stats=None,
        seeds: Sequence[int] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Independent frames (first pass, ``content`` / ``random`` init)
        as one stacked step per iteration (JAX's ``vmap`` of the frame
        program): (B, H, W, 3) u8 -> (pastiches (B, 1, 3, h, w), displays
        (B, h, w, 3) u8), both on the device.  Each frame is preprocessed,
        histogram-matched and given its content target on its own, its
        random init drawn from its own seed as ``optimize_frame`` draws it,
        and its losses, gradient normalisation and optimiser state are its
        own; the style targets are shared.  ``last_loss_log`` is
        (B, num_iters, n_losses)."""
        if init_mode not in ("content", "random"):
            raise ValueError(f"optimize_frames takes a chain-free init, not {init_mode!r}")
        out_hw = tuple(int(v) for v in out_hw)
        blend_weights = list(blend_weights) if blend_weights is not None else [1.0 / max(len(styles), 1)] * len(styles)
        u8 = _on(np.asarray(contents_u8), self.device)  # the chunk goes up at once
        seeds = list(seeds) if seeds is not None else list(range(u8.shape[0]))
        c = torch.cat([self._frame_content(f, out_hw, content_scale, hist_stats) for f in u8])
        targets = {"style": self.style_targets(styles, blend_weights),
                   "content": capture_content_targets(self._extract, c, self.loss_cfg)}
        # one frame's shapes, as optimize_frame's scale sees them
        scale = dict(self._strength_scale({"style": targets["style"],
                                           "content": {l: t[:1] for l, t in targets["content"].items()}}))
        p0 = c if init_mode == "content" else torch.cat([self._noise(seed, out_hw) for seed in seeds])
        opt = self._make_optimizer(frames=True)
        p, _, log = self._run(p0, opt, opt.init(p0), targets, scale, int(num_iters), frames=True)
        outs = [match_histogram_device(f, *hist_stats) if hist_stats is not None else f for f in p.split(1)]
        self.last_loss_log = log.transpose(0, 1)
        return torch.stack(outs), torch.stack([deprocess_to_u8(o) for o in outs])

    def _frame_content(self, u8: torch.Tensor, out_hw: tuple[int, int], content_scale, hist_stats) -> torch.Tensor:
        """One (H, W, 3) u8 frame on the device -> its (1, 3, h, w) content
        image, preprocessed, resized and histogram-matched."""
        if content_scale is not None:
            # scale_factor resampling keeps the host path's scale quirk
            if tuple(scale_shape(tuple(u8.shape[:2]), content_scale)) != out_hw:
                raise ValueError(f"content_scale {content_scale} does not map {tuple(u8.shape[:2])} to {out_hw}")
            c = preprocess_u8(u8, scale_factor=content_scale)
        else:
            c = preprocess_u8(u8, size=out_hw)
        return match_histogram_device(c, *hist_stats) if hist_stats is not None else c

    def _noise(self, seed: int, out_hw: tuple[int, int]) -> torch.Tensor:
        """The random init: 0.001 N(0, 1) from a generator seeded ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return 0.001 * torch.randn((1, 3, *out_hw), generator=gen, device=self.device)

    def optimize_frame_chain(
        self,
        chain,
        stacked_aux: dict,
        styles: Sequence,
        num_iters: int,
        *,
        out_hw: tuple[int, int],
        content_scale: float | None = None,
        blend_weights: Sequence[float] | None = None,
        init_mode: str = "blend",
        use_temporal: bool = False,
        temporal_blend: float = 1.0,
        hist_stats=None,
        seeds: Sequence[int] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """K chained frames: frame i's result is frame i+1's ``prev``.
        ``stacked_aux`` holds per-frame arrays with leading dim K
        ("content_u8"; "blend", "flow", "weights_u8" per mode).  Returns
        (chain (1, 3, h, w), displays (K, h, w, 3) u8) on the device;
        ``last_loss_log`` is (K, num_iters, n_losses)."""
        if init_mode not in ("blend", "warp_prev"):
            raise ValueError(f"optimize_frame_chain takes a chained init, not {init_mode!r}")
        k_frames = len(stacked_aux["content_u8"])
        seeds = list(seeds) if seeds is not None else list(range(k_frames))
        disps, logs = [], []
        for i in range(k_frames):
            aux = {k: v[i] for k, v in stacked_aux.items()}
            chain, disp = self.optimize_frame(
                aux["content_u8"], styles, num_iters, out_hw=out_hw, content_scale=content_scale,
                blend_weights=blend_weights, init_mode=init_mode, prev=chain, blend=aux.get("blend"),
                temporal_blend=temporal_blend, flow=aux.get("flow"), weights_u8=aux.get("weights_u8"),
                use_temporal=use_temporal, hist_stats=hist_stats, seed=seeds[i],
            )
            disps.append(disp)
            logs.append(self.last_loss_log)
        self.last_loss_log = torch.stack(logs)
        return chain, torch.stack(disps)


def _on(x, device) -> torch.Tensor:
    """A host array or a tensor, as a tensor on ``device`` (dtype kept)."""
    return x.to(device) if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x)).to(device)


def _nchw(x, device) -> torch.Tensor:
    """A (1, 3, H, W) tensor as it is, or a (1, H, W, 3) host array as NCHW."""
    return x.to(device).float() if isinstance(x, torch.Tensor) else to_nchw(x, device)


__all__ = ["StyleEngine", "to_nchw", "to_nhwc", "resolve_device", "apply_precision"]
