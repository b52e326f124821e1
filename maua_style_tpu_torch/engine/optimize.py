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

Only ``transfer_type="img_img"`` is ported; the frame, window, pyramid and
video-style runners come with later slices.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..losses import LossConfig, capture_content_targets, capture_style_targets, evaluate_losses
from ..models.extractor import Extractor, ExtractorSpec, truncate_spec
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
        if precision not in _TF32:
            raise ValueError(f"unknown precision {precision!r}; one of {sorted(_TF32)}")
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
        torch.backends.cuda.matmul.allow_tf32 = _TF32[precision]
        torch.backends.cudnn.allow_tf32 = _TF32[precision]

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
        return p, opt_state, torch.stack(logs)

    def optimize(
        self,
        content,
        styles: Sequence,
        init,
        num_iters: int,
        *,
        transfer_type: str = "img_img",
        blend_weights: Sequence[float] | None = None,
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
        """
        if transfer_type != "img_img":
            raise NotImplementedError(
                f"transfer_type={transfer_type!r} is not ported yet (ROADMAP Slice B: vid_img, Slice C: img_vid)"
            )
        blend_weights = list(blend_weights) if blend_weights is not None else [1.0 / max(len(styles), 1)] * len(styles)
        targets = {"content": self.content_targets(content), "style": self.style_targets(styles, blend_weights)}
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


__all__ = ["StyleEngine", "to_nchw", "to_nhwc", "resolve_device"]
