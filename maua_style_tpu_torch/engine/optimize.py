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
tensor, and a uint8 image comes back.  ``optimize_frames`` and
``optimize_frame_chain`` keep the JAX package's signatures and results,
but where JAX runs one ``vmap`` / ``lax.scan`` program (to save TPU
executable loads and round trips) they loop over ``optimize_frame`` on the
host.  The window, pyramid and video-style runners (img_vid) come with a
later slice.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..losses import LossConfig, capture_content_targets, capture_style_targets, capture_temporal_targets, evaluate_losses
from ..models.extractor import Extractor, ExtractorSpec, truncate_spec
from ..ops.frame_ops import deprocess_to_u8, match_histogram_device, preprocess_u8, warp_map_from_flow
from ..ops.resize import resize_bilinear, scale_shape
from ..ops.warp import grid_sample
from .checkpoint import load_state, save_state
from .lbfgs import Adam, LBFGS

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

    def _make_optimizer(self) -> LBFGS | Adam:
        if self.optimizer_name == "lbfgs":
            # bf16 activations also store the L-BFGS histories in bf16
            hdt = torch.bfloat16 if self.compute_dtype == torch.bfloat16 else None
            return LBFGS(self.learning_rate, self.lbfgs_history, method=self.lbfgs_method, history_dtype=hdt)
        return Adam(self.learning_rate)

    def _run(self, pastiche, opt, opt_state, targets, scale, n_iters):
        """``n_iters`` steps; returns (pastiche, opt_state, (n_iters, n_losses) log)."""
        cfg = self.loss_cfg
        logs = []
        p = pastiche
        for _ in range(n_iters):
            p = p.detach().requires_grad_(True)
            total, per = evaluate_losses(p, self._extract(p, cfg.all_layers), targets, cfg, scale)
            (grad,) = torch.autograd.grad(total, p)
            upd, opt_state = opt.update(grad.float(), opt_state)
            p = p.detach() + upd
            logs.append(per.detach())
        log = torch.stack(logs) if logs else p.new_zeros((0, len(cfg.loss_names())))
        return p, opt_state, log

    def optimize(
        self,
        content,
        styles: Sequence,
        init,
        num_iters: int,
        *,
        transfer_type: str = "img_img",
        blend_weights: Sequence[float] | None = None,
        temporal_warp=None,
        temporal_weights=None,
        save_iter: int = 0,
        save_callback: Callable[[np.ndarray, int], None] | None = None,
        run_checkpoint: str | None = None,
        checkpoint_every: int = 0,
        profile_dir: str | None = None,
        print_iter: int = 0,
    ) -> np.ndarray:
        """Optimise a (1, H, W, 3) pastiche against content + style targets;
        returns the result as a host array.

        ``run_checkpoint``: directory for interruptible runs — saves the
        pastiche, the optimizer state and the iteration at every chunk end
        and resumes with the optimizer state intact.  ``profile_dir``: a
        ``torch.profiler`` chrome trace of the first chunk.

        vid_img's host path (``--original_colors``) passes its temporal
        target as ``temporal_warp=(prev_frame, warp_map)``, warped here on
        the device, with ``temporal_weights``, the (1, H, W, 1) reliability.
        """
        if transfer_type not in ("img_img", "vid_img"):
            raise NotImplementedError(f"transfer_type={transfer_type!r} is not ported yet (ROADMAP Slice C: img_vid)")
        blend_weights = list(blend_weights) if blend_weights is not None else [1.0 / max(len(styles), 1)] * len(styles)
        targets = {"content": self.content_targets(content), "style": self.style_targets(styles, blend_weights)}
        if temporal_warp is not None:
            src, wmap = temporal_warp
            warped = grid_sample(to_nchw(src, self.device), _on(np.asarray(wmap, np.float32), self.device))
            weights = None if temporal_weights is None else to_nchw(temporal_weights, self.device)
            targets["temporal"] = capture_temporal_targets(warped, weights)
        scale = dict(self._strength_scale(targets))

        pastiche = to_nchw(init, self.device)
        opt = self._make_optimizer()
        opt_state = opt.init(pastiche)
        done = 0
        if run_checkpoint is not None:
            restored = load_state(run_checkpoint, pastiche, opt_state)
            if restored is not None:
                pastiche, opt_state, _, done = restored

        chunk = num_iters if save_iter <= 0 else save_iter
        if checkpoint_every > 0:
            chunk = min(chunk, checkpoint_every)
        if print_iter > 0:
            chunk = min(chunk, print_iter)
        loss_logs = []
        profiled = profile_dir is None
        while done < num_iters:
            this = min(chunk, num_iters - done)
            if not profiled:
                pastiche, opt_state, log = self._profiled_run(profile_dir, pastiche, opt, opt_state, targets, scale, this)
                profiled = True
            else:
                pastiche, opt_state, log = self._run(pastiche, opt, opt_state, targets, scale, this)
            done += this
            loss_logs.append(log.cpu().numpy())
            if print_iter > 0 and (done // print_iter > (done - this) // print_iter or done == num_iters):
                # fire on crossing each print_iter boundary (reference optim.py:228-229)
                print(f"Iteration {done} / {num_iters}, Loss: {float(loss_logs[-1][-1].sum()):g}")
            if save_callback is not None and done < num_iters:
                save_callback(to_nhwc(pastiche), done)
            if run_checkpoint is not None and done < num_iters:
                save_state(run_checkpoint, pastiche, opt_state, 0, done)

        if run_checkpoint is not None:
            shutil.rmtree(run_checkpoint, ignore_errors=True)  # run completed

        self.last_loss_log = np.concatenate(loss_logs, axis=0) if loss_logs else None
        return to_nhwc(pastiche)

    def _profiled_run(self, profile_dir, *run_args):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            out = self._run(*run_args)
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
        u8 = _on(content_u8, dev)
        if content_scale is not None:
            # scale_factor resampling keeps the host path's scale quirk
            if tuple(scale_shape(tuple(u8.shape[:2]), content_scale)) != out_hw:
                raise ValueError(f"content_scale {content_scale} does not map {tuple(u8.shape[:2])} to {out_hw}")
            c = preprocess_u8(u8, scale_factor=content_scale)
        else:
            c = preprocess_u8(u8, size=out_hw)
        if hist_stats is not None:
            c = match_histogram_device(c, *hist_stats)
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
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            p0 = 0.001 * torch.randn((1, 3, *out_hw), generator=gen, device=dev)
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
        """Independent frames (first pass, ``content`` / ``random`` init):
        (B, H, W, 3) u8 -> (pastiches (B, 1, 3, h, w), displays (B, h, w, 3)
        u8), one ``optimize_frame`` each; ``last_loss_log`` is
        (B, num_iters, n_losses)."""
        if init_mode not in ("content", "random"):
            raise ValueError(f"optimize_frames takes a chain-free init, not {init_mode!r}")
        seeds = list(seeds) if seeds is not None else list(range(len(contents_u8)))
        outs, disps, logs = [], [], []
        for u8, seed in zip(contents_u8, seeds):
            out, disp = self.optimize_frame(
                u8, styles, num_iters, out_hw=out_hw, content_scale=content_scale, blend_weights=blend_weights,
                init_mode=init_mode, hist_stats=hist_stats, seed=seed,
            )
            outs.append(out)
            disps.append(disp)
            logs.append(self.last_loss_log)
        self.last_loss_log = torch.stack(logs)
        return torch.stack(outs), torch.stack(disps)

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
