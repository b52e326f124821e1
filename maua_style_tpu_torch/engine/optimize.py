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

A mesh (``mesh=``, ``parallel/mesh.py``): on a "space" axis a pastiche
(img_img's, a vid_img frame's, or a stack of frames) is cut into row
bands, one per device (``parallel/spatial.py``; any model of the
registry, NIN's strided convolution and overlapping pools included), and
every iteration runs the bands' forward with halo rows, the losses from
per-band sums (``losses.evaluate_banded_losses``, K1 per band over the
whole stack) and the optimiser band by band; a frame's set-up (preprocess, histogram
match, the warp of the previous frame, the init) runs whole on the first
device and is then split, and the result, the ``save_iter`` snapshots and
the run-state checkpoints are gathered to the single-device layout.  On a
"frames" axis ``optimize_frames`` shares a chunk's frames out to the rows
of the mesh (``parallel.mesh_rows``: one device, or with "space" too a
row of bands), each row with its own copy of the extractor and the style
targets and its own stacked step, the host issuing every row's iteration
in turn.  The per-frame and chained passes run on the first row, as JAX's
frames-stripped programs do.  On a "tensor" axis a pastiche (img_img's,
a vid_img frame's or stack's) is cut into (band, share) pieces of
contiguous channel shares on the first "frames" row's grid
(``parallel.mesh_grid``; one band without "space"; a share past the last
channel empty): each convolution splits its contraction dim
(``spatial.conv_pieces``), each style layer's per-frame Grams are
assembled from their blocks (``ops.gram.channel_gram``: K1 on each
share's diagonal block over the stack), the temporal weights go to every
share's device band by band, and the optimiser state is kept piece by
piece; the results, snapshots and run-states are gathered to the
single-device layout.  A "frames" row's replica runs on the row's own
(space, tensor) mesh (``parallel.row_mesh``).

img_vid (``transfer_type="img_vid"``) optimises a T-frame pastiche in
circular ``gram_frame_window`` windows (``engine/windows.py``): the whole
pastiche stays on the host, each window goes up, runs, and is scattered
back.  Windows after the first freeze the frames earlier windows styled,
by a gradient mask or, without run-state checkpoints, by the frozen-split
runner (``_run``).  On a mesh each window's frames are shared out to the
rows of a "frames" axis and cut into row bands on "space" and channel
shares on "tensor" (``_window_layout``; JAX shards the window's frames and
channels), the losses summed from the pieces
(``losses.evaluate_window_losses``: the whole-window Gram by groups of
frame share and channel share, against the target permuted once into
group order).

``optimize_pyramid`` (``--fuse_scales``) runs img_img's whole pyramid with
every scale's tail on the device, as JAX's fused program does: each
scale's init is the previous output resized on the device, and with
colour statistics both that init and each output are recoloured there by
``match_histogram_device``, so its artifacts differ from the per-scale
loop's, which matches histograms on the host.
"""

from __future__ import annotations

import functools
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from .. import trace
from ..losses import (
    LossConfig,
    capture_content_targets,
    capture_style_targets,
    capture_style_video_targets,
    capture_temporal_targets,
    evaluate_banded_losses,
    evaluate_frame_losses,
    evaluate_losses,
    evaluate_window_losses,
    frame_slice,
)
from ..models.extractor import Extractor, ExtractorSpec, truncate_spec
from ..ops.frame_ops import deprocess_to_u8, match_histogram_device, preprocess_u8, warp_map_from_flow
from ..ops.resize import resize_bilinear, scale_shape
from ..ops.warp import grid_sample
from ..parallel import (channel_shares, frame_shards, mesh_grid, mesh_rows, row_mesh, sharding_for, spatial,
                        window_shares)
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
    with trace.span("engine.copy_in"):
        arr = np.ascontiguousarray(np.transpose(np.asarray(x, np.float32), (0, 3, 1, 2)))
        trace.count("engine.h2d_bytes", arr.nbytes)
        return torch.from_numpy(arr).to(device)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    """(B, C, H, W) tensor -> (B, H, W, C) f32 host array."""
    with trace.span("engine.copy_out"):
        out = t.detach().float().permute(0, 2, 3, 1).cpu().numpy()
        trace.count("engine.d2h_bytes", out.nbytes)
        return out


# elements of one chunk of the style cache's comparison (16 MiB of f32), and
# the threads that compare chunks (numpy's comparison releases the GIL: on the
# 8-core host of an H100 machine 4 threads compare 991 MB with a copy in
# ≈ 0.1 s where one takes ≈ 0.3)
_COMPARE_CHUNK = 1 << 22
_COMPARE_THREADS = 4


class _StyleEntry(NamedTuple):
    """``style_targets``' one cache entry: the blend weights, a private
    read-only C-contiguous f32 host copy of each style (the values
    ``to_nchw`` uploads), and the targets captured from them."""

    weights: tuple[float, ...]
    styles: tuple[np.ndarray, ...]
    targets: dict


def _snapshot(style) -> np.ndarray:
    snap = np.array(style, np.float32, order="C")  # a copy, whatever the caller's array
    snap.flags.writeable = False
    return snap


def _chunks(a: np.ndarray, snap: np.ndarray):
    """(piece of ``a``, piece of ``snap``) views of at most ``_COMPARE_CHUNK``
    elements each, cut over the leading axes, in order."""
    if a.size <= _COMPARE_CHUNK:
        yield a, snap
        return
    row = a.size // len(a)
    if row > _COMPARE_CHUNK:
        for x, y in zip(a, snap):
            yield from _chunks(x, y)
        return
    step = _COMPARE_CHUNK // row
    for i in range(0, len(a), step):
        yield a[i:i + step], snap[i:i + step]


def _same_chunk(pair) -> bool:
    a, snap = pair
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32), snap.view(np.uint32))


def _same_f32_bits(a: np.ndarray, snap: np.ndarray, pool) -> bool:
    """Whether ``a`` as f32 equals ``snap`` (f32, C-contiguous, of its shape)
    bit for bit, so that NaN payloads and signed zeros count as they did in
    a byte hash: chunk by chunk on ``pool``'s threads, each chunk converted
    alone; at the first chunk (in order) that differs, the chunks not yet
    started are cancelled.  Counts the bytes of ``snap`` up to that chunk."""
    chunks = list(_chunks(a, snap))
    for (_, s), same in zip(chunks, pool.map(_same_chunk, chunks)):
        trace.count("engine.style_compare_bytes", s.nbytes)
        if not same:
            return False
    return True


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
        mesh=None,
    ):
        apply_precision(precision)
        if optimizer not in ("lbfgs", "adam"):
            raise ValueError(f"unknown optimizer {optimizer}")
        # the pastiche's plan on the mesh (``parallel.sharding_for``): its
        # spec names the axis that shards each NCHW dim
        self.sharding = sharding_for(mesh)
        _, tensor_axis, space_axis, _ = self.sharding.spec if self.sharding else (None,) * 4
        if self.sharding is not None:
            device = mesh.devices[0]
            for d in mesh.devices:
                resolve_device(d)
        self.mesh = self.sharding.mesh if self.sharding else None
        self.device = resolve_device(device)
        self.loss_cfg = loss_cfg
        self.spec = truncate_spec(spec, loss_cfg.all_layers)
        # "space" and "tensor": the first "frames" row as a (band, share)
        # grid (``parallel.mesh_grid``), the bands' devices (share 0's), the
        # channel shares, and the rows a band boundary is a multiple of (the
        # product of the spec's strides in H, ``spatial.band_geometry``)
        self.grid = mesh_grid(mesh) if space_axis or tensor_axis else None
        self.band_devices = [row[0] for row in self.grid] if space_axis else None
        self.shares = len(self.grid[0]) if tensor_axis else 1
        self.band_align = spatial.band_alignment(self.spec) if self.band_devices else 1
        if self.shares > 1 and any(l.kind == "softmax" for l in self.spec.layers):
            raise NotImplementedError(f"mesh {mesh.axes}: a softmax over channel shares is not split")
        with trace.span("weights.upload"):
            self.extractor = Extractor(self.spec, params).to(device=self.device, dtype=compute_dtype).eval()
            trace.count("weights.uploads")
            trace.count("weights.upload_bytes", sum(w.nbytes for w in self.extractor.parameters()))
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
        self._style_cache: _StyleEntry | None = None
        self._replicas: dict[tuple[torch.device, ...], StyleEngine] = {}

    def _extract(self, x: torch.Tensor, layers: Sequence[str]) -> dict[str, torch.Tensor]:
        return self.extractor(x.to(self.compute_dtype), layers)

    def _extract_bands(self, bands: Sequence[torch.Tensor], layers: Sequence[str]) -> dict[str, list]:
        """The activations of row bands, or on a "tensor" axis of (band,
        share) pieces ({layer: [pieces]}, share-major)."""
        extractors = [self._replica((b.device,)).extractor for b in bands]
        return spatial.banded_forward(extractors, [b.to(self.compute_dtype) for b in bands], layers, self.shares)

    def _replica(self, row: tuple) -> "StyleEngine":
        """This engine's copy on a row of devices (one piece's device, or a
        "frames" row of the mesh, ``parallel.mesh_rows``): the extractor's
        weights and the settings, on a row of several the row's own mesh
        (``parallel.row_mesh``: its "space" and "tensor" axes, so a row of
        frames:2,tensor:2 splits channels, not rows); the engine itself
        where it already runs."""
        row = tuple(torch.device(d) for d in row)
        own = tuple(self.band_devices or ()) if self.shares == 1 else mesh_rows(self.mesh)[0]
        if row in ((self.device,), own):
            return self
        if row not in self._replicas:
            self._replicas[row] = StyleEngine(
                self.spec, self.extractor.state_dict(), self.loss_cfg, optimizer=self.optimizer_name,
                learning_rate=self.learning_rate, lbfgs_history=self.lbfgs_history, lbfgs_method=self.lbfgs_method,
                precision=self.precision, normalize_weights=self.normalize_weights, compute_dtype=self.compute_dtype,
                device=row[0], mesh=row_mesh(self.mesh, row) if len(row) > 1 else None,
            )
        return self._replicas[row]

    # -- target capture ----------------------------------------------------

    def content_targets(self, content) -> dict:
        """The content activations of a (1, H, W, 3) image; on a "space"
        mesh a list of each band's, captured band by band (on a "tensor"
        axis each piece's)."""
        with trace.span("engine.capture", kind="content"):
            return self._content_targets(to_nchw(content, self.device))

    def _content_targets(self, x: torch.Tensor) -> dict:
        """``content_targets`` of a (B, 3, H, W) tensor on the device."""
        if not self.grid:
            return capture_content_targets(self._extract, x, self.loss_cfg)
        split, _ = self._band_layout(x.shape)
        with torch.no_grad():
            acts = self._extract_bands(split(x), self.loss_cfg.content_layers)
        return {l: [a.float() for a in acts[l]] for l in self.loss_cfg.content_layers}

    def _temporal_targets(self, warped: torch.Tensor, weights: torch.Tensor | None) -> dict:
        """The temporal target, a whole warped image (a flow moves pixels
        across band boundaries, so the warp never runs band by band), and
        its (1, 1, H, W) reliability weights; on a mesh the target then cut
        as the pastiche is (``_band_layout``), and the weights, which every
        channel reads, into row bands only, band i copied to each channel
        share's device (``spatial.split_bands_shared``)."""
        t = capture_temporal_targets(warped, weights)
        if not self.grid:
            return t
        _, _, h, w = warped.shape
        out = {"target": self._band_layout(warped.shape)[0](t["target"])}
        if "weights" in t:
            out["weights"] = spatial.split_bands_shared(t["weights"], self._band_heights(h), self.grid, 1, w)
        return out

    def style_targets(self, styles: Sequence, blend_weights: Sequence[float]) -> dict[str, torch.Tensor]:
        """The blended Gram targets of (1, H, W, 3) style arrays, from the
        engine's one-entry cache when the weights and every style's f32
        values are those of its last capture."""
        with trace.span("engine.capture", kind="style"):
            weights = tuple(float(bw) for bw in blend_weights)
            entry = self._style_cache
            with trace.span("engine.style_key"):
                arrays = [np.asarray(s) for s in styles]
                hit = (entry is not None and entry.weights == weights and len(arrays) == len(entry.styles)
                       and all(a.shape == snap.shape for a, snap in zip(arrays, entry.styles)))
                if hit:
                    with ThreadPoolExecutor(_COMPARE_THREADS) as pool:
                        hit = all(_same_f32_bits(a, snap, pool) for a, snap in zip(arrays, entry.styles))
            if hit:
                trace.count("engine.style_cache.hit")
                return entry.targets
            trace.count("engine.style_cache.miss")
            snaps = tuple(_snapshot(a) for a in arrays)
            targets = capture_style_targets(
                self._extract, [to_nchw(s, self.device) for s in snaps], blend_weights, self.loss_cfg
            )
            self._style_cache = _StyleEntry(weights, snaps, targets)
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
            scale.append((f"content:{l}", 1.0 / max(_whole_shape(t, self.shares))))
        for l, t in targets.get("style", {}).items():
            scale.append((f"style:{l}", 1.0 / max(t.shape)))
        temporal = targets.get("temporal")
        if temporal is not None:
            scale.append(("temporal", 1.0 / max(_whole_shape(temporal["target"], self.shares))))
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

    def _run(self, *args, **kw):
        """``_steps`` to its end: (pastiche, opt_state, log)."""
        return _drain(self._steps(*args, **kw))

    def _steps(self, pastiche, opt, opt_state, targets, scale, n_iters, *, mask=None, frozen=None, frames=False,
               window=None):
        """``n_iters`` steps, a generator that yields after each; returns
        (pastiche, opt_state, (n_iters, n_losses) log).

        A list ``pastiche`` is a banded one ("space" mesh; on a "tensor" axis
        its (band, share) pieces): the bands' forward and
        ``evaluate_banded_losses``, the optimiser over the pieces.

        ``frames``: the pastiche (or each band) stacks independent frames
        (vid_img's first pass, ``optimize_frames``); the losses are each
        frame's own (``evaluate_frame_losses``) and the log is (n_iters, B,
        n_losses).

        img_vid's window runners (JAX optimize.py:235-341): ``mask``, a
        (T, 1, 1, 1) tensor, multiplies the gradient before the optimiser
        update.  ``frozen=(fo, eo)`` is the frozen split: the first ``fo``
        and last ``eo`` frames of the window have a zero gradient, so they
        never move (Adam's moments stay zero there, and so does every
        L-BFGS (s, y) pair).  Their activations are extracted once, under
        no-grad; each iteration runs forward and backward on the middle
        slice alone, the losses see the activations concatenated in window
        order, and ``opt_state`` covers the middle slice only.  ``window``,
        a ``spatial.WindowLayout``: the window laid out on a mesh, the
        pastiche its pieces and ``targets`` each share's
        (``_window_pieces``)."""
        cfg = self.loss_cfg
        logs = []
        if window is not None:
            p, loss_of, assemble = self._window_pieces(window, pastiche, targets, scale, frozen)
            if mask is not None:  # the masked runner: every piece moves
                mask = [mask[part].to(d) for (_, part), devs in zip(window.shares, window.devices()) for d in devs]
        elif frozen is not None:
            fo, eo = frozen
            t_w = pastiche.shape[0]
            front, end, p = pastiche[:fo], pastiche[t_w - eo :], pastiche[fo : t_w - eo]
            with torch.no_grad():
                fixed = self._extract(torch.cat([front, end]), cfg.all_layers)

            def loss_of(p):
                acts = {l: torch.cat([fixed[l][:fo], a, fixed[l][fo:]]) for l, a in self._extract(p, cfg.all_layers).items()}
                with trace.span("losses"):
                    return evaluate_losses(torch.cat([front, p, end]), acts, targets, cfg, scale)

            def assemble(p):
                return torch.cat([front, p, end])
        else:
            p, assemble = pastiche, _same
            banded = isinstance(pastiche, list)
            extract = self._extract_bands if banded else self._extract
            evaluate = (functools.partial(evaluate_frame_losses, shares=self.shares) if frames else
                        functools.partial(evaluate_banded_losses, shares=self.shares) if banded else evaluate_losses)

            def loss_of(p):
                acts = extract(p, cfg.all_layers)
                with trace.span("losses"):
                    return evaluate(p, acts, targets, cfg, scale)

        banded = isinstance(p, list)
        for _ in range(n_iters):
            with trace.span("engine.step"):
                p = [b.detach().requires_grad_(True) for b in p] if banded else p.detach().requires_grad_(True)
                total, per = loss_of(p)
                # an empty channel share's piece (tensor:4 over 3 colours) may reach no term
                empty = banded and any(b.numel() == 0 for b in p)
                with trace.span("net.backward"):
                    raw = torch.autograd.grad(total, p, allow_unused=empty)
                grads = [torch.zeros_like(x) if g is None else g.float() for g, x in zip(raw, p if banded else [p])]
                if mask is not None:
                    grads = [g * m for g, m in zip(grads, mask if banded else [mask])]
                with trace.span("optimizer.update"):
                    upd, opt_state = opt.update(grads if banded else grads[0], opt_state)
                p = [b.detach() + u for b, u in zip(p, upd)] if banded else p.detach() + upd
                logs.append(per.detach())
            trace.count("engine.iterations")
            yield
        p = assemble(p)
        one = p[0] if banded else p
        log = torch.stack(logs) if logs else one.new_zeros((0, *one.shape[:frames], len(cfg.loss_names())))
        return p, opt_state, log

    def _window_pieces(self, layout, pieces, targets, scale, frozen):
        """An img_vid window laid out on the mesh, for ``_steps``: (the
        pieces that move, the window's loss of them, and a function of them
        back to every piece of the window).  ``targets`` holds each share's
        (``_share_targets``).  Each share's forward runs on its row
        (``_extract_row``), and ``evaluate_window_losses`` sums the shares.
        Under the frozen split ``frozen=(fo, eo)`` each share's frozen
        frames are cut off its bands and their activations extracted once,
        on its row."""
        layers = self.loss_cfg.all_layers
        shares = []  # (row, frames frozen at its start, at its end, bands, the frozen frames' activations)
        for (row, _), bands, (a, e) in zip(layout.shares, layout.by_share(pieces), layout.frozen_cut(frozen)):
            fixed = None
            if a + e:
                n = bands[0].shape[0]
                with torch.no_grad():
                    fixed = self._extract_row(row, [torch.cat([b[:a], b[n - e :]]) for b in bands], layers)
            shares.append((row, a, e, bands, fixed))

        def windowed(p):
            """Per share: its bands with the moving pieces ``p`` put back,
            and its moving bands (None where every frame is frozen)."""
            it, out = iter(p), []
            for _, a, e, bands, _ in shares:
                n = bands[0].shape[0]
                if n == a + e:
                    out.append((bands, None))
                    continue
                mid = [next(it) for _ in bands]
                out.append(([m if a + e == 0 else torch.cat([b[:a], m, b[n - e :]]) for b, m in zip(bands, mid)], mid))
            return out

        def loss_of(p):
            full, acts = [], []
            for (row, a, _, _, fixed), (bands, mid) in zip(shares, windowed(p)):
                act = self._extract_row(row, mid, layers) if mid is not None else None
                if fixed is not None:
                    act = fixed if act is None else {
                        l: [torch.cat([fx[:a], m, fx[a:]]) for fx, m in zip(fixed[l], act[l])] for l in layers}
                full.append(bands)
                acts.append(act)
            with trace.span("losses"):
                return evaluate_window_losses(full, acts, targets, self.loss_cfg, scale, self.shares)

        def assemble(p):
            return [b for bands, _ in windowed(p) for b in bands]

        moving = layout.moving(pieces, frozen)
        return moving, loss_of, assemble

    def _extract_row(self, row, bands, layers) -> dict[str, list]:
        """The activations ({layer: [band activations]}) of one row's bands
        (a share of an img_vid window), by the row's replica: band by band
        with halo rows on a row of several devices, its plain forward on a
        row of one."""
        if len(bands) == 1:
            return {l: [a] for l, a in self._replica(row[:1])._extract(bands[0], layers).items()}
        return self._replica(row)._extract_bands(bands, layers)

    def _iterate(self, p, opt, st, targets, scale, num_iters, done, after_chunk, *, save_iter, print_iter,
                 checkpoint_every, profile_dir, mask=None, frozen=None, window=None):
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
            kw = dict(mask=mask, frozen=frozen, window=window)
            # the chunk's steps and its log's copy, which waits for them
            with trace.span("engine.chunk", iters=this):
                if profile_dir is not None:
                    p, st, log = self._profiled_run(profile_dir, p, opt, st, targets, scale, this, **kw)
                    profile_dir = None
                else:
                    p, st, log = self._run(p, opt, st, targets, scale, this, **kw)
                logs.append(log.cpu().numpy())
            done += this
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
        chrome trace of the first chunk (``_profiled_run``).

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
        with trace.span("engine.optimize"):
            if transfer_type not in ("img_img", "vid_img", "img_vid"):
                raise ValueError(f"unknown transfer_type {transfer_type!r}")
            blend_weights = (list(blend_weights) if blend_weights is not None
                             else [1.0 / max(len(styles), 1)] * len(styles))
            loop = dict(save_iter=save_iter, print_iter=print_iter, checkpoint_every=checkpoint_every,
                        profile_dir=profile_dir)
            targets = {"content": self.content_targets(content)}
            weights = None if temporal_weights is None else to_nchw(temporal_weights, self.device)
            if temporal_warp is not None:
                src, wmap = temporal_warp
                warped = grid_sample(to_nchw(src, self.device), _on(np.asarray(wmap, np.float32), self.device))
                targets["temporal"] = self._temporal_targets(warped, weights)
            elif temporal_target is not None:
                targets["temporal"] = self._temporal_targets(to_nchw(temporal_target, self.device), weights)
            if transfer_type == "img_vid":
                if gram_frame_window is None:
                    raise ValueError("img_vid needs gram_frame_window")
                return self._optimize_windows(targets, styles, blend_weights, init, num_iters, int(gram_frame_window),
                                              avg_frame_window, save_callback, run_checkpoint, loop)

            targets["style"] = self.style_targets(styles, blend_weights)
            scale = dict(self._strength_scale(targets))
            pastiche = to_nchw(init, self.device)
            split, gather = self._band_layout(pastiche.shape)
            opt = self._make_optimizer()
            # the state's pastiche-sized entries, kept band by band on a "space"
            # mesh; run-states hold the single-device layout either way, so a
            # banded run and an unbanded one resume each other's state
            per_band = {k for k, v in opt.init([pastiche.to("meta")]).items() if isinstance(v, list)}
            opt_state, done = None, 0
            if run_checkpoint is not None:
                restored = load_state(run_checkpoint, pastiche, opt.init(pastiche.to("meta")))
                if restored is not None:
                    pastiche, whole_state, _, done = restored
                    opt_state = {k: split(v) if k in per_band else v for k, v in whole_state.items()}
            if opt_state is None:
                opt_state = opt.init(split(pastiche))

            def after_chunk(p, st, done):
                p = gather(p)
                if save_callback is not None:
                    save_callback(to_nhwc(p), done)
                if run_checkpoint is not None:
                    save_state(run_checkpoint, p, {k: gather(v) if k in per_band else v for k, v in st.items()}, 0,
                               done)

            pastiche, _, logs = self._iterate(split(pastiche), opt, opt_state, targets, scale, num_iters, done,
                                              after_chunk, **loop)
            if run_checkpoint is not None:
                shutil.rmtree(run_checkpoint, ignore_errors=True)  # run completed
            self.last_loss_log = np.concatenate(logs, axis=0) if logs else None
            return to_nhwc(gather(pastiche))

    def optimize_pyramid(
        self,
        contents_per_scale: Sequence,
        styles_per_scale: Sequence[Sequence],
        init,
        schedule: Sequence[tuple[tuple[int, int], int]],
        *,
        blend_weights: Sequence[float] | None = None,
        hist_stats: tuple | None = None,
    ) -> list[np.ndarray]:
        """img_img's whole pyramid in one device-resident run (``--fuse_scales``,
        JAX optimize.py:345-455): per scale ((h, w), num_iters) of
        ``schedule``, the init (``init`` at the first scale, else the
        previous output resized on the device and, with ``hist_stats``,
        recoloured by ``match_histogram_device``), the targets of
        ``contents_per_scale[s]`` and ``styles_per_scale[s]`` (both pre-scaled
        on the host, as the per-scale loop scales them), the strength scale
        from those targets, ``num_iters`` steps from a fresh optimiser state
        with no chunking, and the output recoloured with ``hist_stats``.  The
        previous output stays on the device; each scale's optimiser state and
        targets are freed before the next scale starts.  Returns each
        scale's output as a host array, all copied at the end;
        ``last_loss_log`` is the scales' logs one after another, (Σ
        num_iters, n_losses).

        On a mesh each scale's init is set up whole on the first device and
        cut with that scale's ``_band_layout`` (band heights change with the
        scale); the content targets are captured piece by piece and the
        output gathered before its recolouring."""
        with trace.span("engine.optimize_pyramid"):
            n_styles = len(styles_per_scale[0])
            blend = list(blend_weights) if blend_weights is not None else [1.0 / max(n_styles, 1)] * n_styles
            hist = None if hist_stats is None else [torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                                                    for a in hist_stats]
            opt = self._make_optimizer()
            outs, logs = [], []
            for s, ((h, w), num_iters) in enumerate(schedule):
                h, w = int(h), int(w)
                if s == 0:
                    p = to_nchw(init, self.device)
                else:
                    p = resize_bilinear(outs[-1], size=(h, w))
                    if hist is not None:
                        p = match_histogram_device(p, *hist)
                try:
                    split, gather = self._band_layout(p.shape)
                except ValueError as e:
                    raise ValueError(f"scale {s} ({h}x{w}) cannot be cut on mesh {self.mesh.axes}: {e}") from e
                targets = {"content": self.content_targets(contents_per_scale[s])}
                with trace.span("engine.capture", kind="style"):
                    targets["style"] = capture_style_targets(
                        self._extract, [to_nchw(x, self.device) for x in styles_per_scale[s]], blend, self.loss_cfg)
                scale = dict(self._strength_scale(targets))
                p = split(p)
                with trace.span("engine.chunk", iters=int(num_iters)):
                    p, state, log = self._run(p, opt, opt.init(p), targets, scale, int(num_iters))
                del state, targets  # one scale's L-BFGS history and activations at a time
                out = gather(p)
                outs.append(match_histogram_device(out, *hist) if hist is not None else out)
                logs.append(log)
            self.last_loss_log = torch.cat(logs).cpu().numpy()
            return [to_nhwc(o) for o in outs]

    def _band_layout(self, shape) -> tuple[Callable, Callable]:
        """(split, gather) of a (B, C, H, W) pastiche-sized tensor, or of a
        flat state entry, between the single-device layout and the row
        bands of a "space" mesh, or the (band, share) pieces of a "tensor"
        axis (``spatial.split_pieces``); both the identity without one."""
        if not self.grid:
            return _same, _same
        _, c, h, w = shape
        heights = self._band_heights(h)
        return (lambda x: spatial.split_pieces(x, heights, self.grid, c, w),
                lambda x: spatial.gather_pieces(x, heights, self.shares, self.device, c, w))

    def _band_heights(self, h: int) -> list[int]:
        """The bands' heights of an image of ``h`` rows on the grid."""
        return spatial.band_rows(h, len(self.grid), self.band_align, self.spec) if len(self.grid) > 1 else [h]

    def _optimize_windows(self, targets, styles, blend_weights, init, num_iters, gfw, avg_frame_window,
                          save_callback, run_checkpoint, loop) -> np.ndarray:
        """img_vid's window loop (JAX optimize.py:907-1069).  On a mesh each
        window is laid out in pieces (``_window_layout``), its targets are
        copied to the rows that read them (``_share_targets``), and the
        optimiser state is kept piece by piece, one problem over the
        window's pieces; snapshots, results and run-state checkpoints are
        gathered to the single-device layout, so a mesh run and a
        one-device run resume each other's state."""
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
        like = torch.empty((len(wrapping_indices(total, 0, gfw)), 3, *output.shape[1:3]), device=dev)
        # the state's window-sized entries, kept piece by piece on a mesh
        per_piece = {k for k, v in opt.init([like.to("meta")]).items() if isinstance(v, list)}
        if run_checkpoint is not None:
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
            layout = self._window_layout(t_w, output.shape[1:3])
            split, gather = (layout.split, lambda x, layout=layout: layout.gather(x, dev)) if layout else (_same, _same)
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
            pastiche = split(to_nchw(output[idx], dev))
            opt_state = opt.init(layout.moving(pastiche, frozen) if layout else
                                 pastiche if frozen is None else pastiche[frozen[0] : t_w - frozen[1]])
            done = 0
            if resume is not None:
                # a checkpoint from a window's end (done 0) starts this window
                # afresh from the saved output (JAX would resume it from the
                # previous window's pastiche and optimizer state)
                if resume[3] > 0:
                    pastiche, done = split(resume[0]["pastiche"]), resume[3]
                    opt_state = {k: split(v) if k in per_piece else v for k, v in resume[1].items()}
                resume = None

            def after_chunk(p, st, done, w=w, gather=gather):
                p = gather(p)
                if save_callback is not None:
                    save_callback(to_nhwc(p), w * num_iters + done)
                if run_checkpoint is not None:
                    save_state(run_checkpoint, blob(p), {k: gather(v) if k in per_piece else v for k, v in st.items()},
                               w, done)

            pastiche, opt_state, wlogs = self._iterate(
                pastiche, opt, opt_state, self._share_targets(targets, layout) if layout else targets, scale,
                num_iters, done, after_chunk, mask=mask, frozen=frozen, window=layout, **loop)
            loop["profile_dir"] = None  # the first window's first chunk only
            logs += wlogs
            pastiche = gather(pastiche)
            output[idx] = to_nhwc(pastiche)
            if run_checkpoint is not None and w + 1 < len(windows[0]):
                save_state(run_checkpoint, blob(pastiche),
                           {k: gather(v) if k in per_piece else v for k, v in opt_state.items()}, w + 1, 0)

        if run_checkpoint is not None:
            shutil.rmtree(run_checkpoint, ignore_errors=True)  # run completed
        self.last_loss_log = np.concatenate(logs, axis=0) if logs else None
        return output

    def _window_layout(self, t_w: int, hw) -> "spatial.WindowLayout | None":
        """A ``t_w``-frame window of (H, W) frames on the mesh: its frames
        in shares over the "frames" axis's rows (``parallel.window_shares``;
        an empty share's row sits idle), each share in row bands and channel
        shares on its row's (band, share) grid (``parallel.row_mesh``, never
        a row of bands where the row holds "tensor" devices); None on one
        device."""
        if self.sharding is None:
            return None
        h, w = (int(v) for v in hw)
        shares = [(row, part) for row, part in window_shares(self.sharding, t_w) if part.stop > part.start]
        grids = [mesh_grid(row_mesh(self.mesh, row)) for row, _ in shares]
        return spatial.WindowLayout(shares, self._band_heights(h) if self.grid else [h], 3, w, grids)

    def _share_targets(self, targets: dict, layout) -> list[dict]:
        """Each share's targets, on its row, for ``evaluate_window_losses``:
        the content (and temporal) targets (captured on the first row, in
        pieces on a "space" or "tensor" mesh) copied piece by piece to the
        row and expanded to the share's frames, the static style targets,
        and the blocks of the dynamic target (captured whole on the first
        device) that the block rows of the share's groups meet: a group is
        one channel share of a share's frames (the share itself without a
        "tensor" axis), its rows t·C + c of the whole window's Gram, so each
        block is the target with its rows and columns permuted into group
        order, once, here, and never the assembled Gram each iteration."""
        t_w = layout.frames
        devices = layout.devices()
        bands = len(layout.heights)
        out = []
        for i, ((row, part), devs) in enumerate(zip(layout.shares, devices)):
            n = part.stop - part.start

            def pieces(t):
                return [b.to(d).expand(n, *b.shape[1:]) for b, d in zip(t if isinstance(t, list) else [t], devs)]

            one = {"content": {l: pieces(t) for l, t in targets.get("content", {}).items()},
                   "style": {l: t.to(row[0]) for l, t in targets.get("style", {}).items()}}
            if targets.get("temporal") is not None:
                one["temporal"] = {k: pieces(v) for k, v in targets["temporal"].items()}
            dynamic = {}
            for l, t in targets.get("style_video", {}).items():
                c = targets["style"][l].shape[0]
                if t.shape[0] != t_w * c:  # a window shorter than the target's (loss.py:165-166)
                    continue
                # (frame share, its rows of the whole Gram, the group's device) per non-empty group, in group order
                groups = [(k, torch.tensor([f * c + ch for f in range(p.start, p.stop)
                                            for ch in range(cs.start, cs.stop)], device=t.device), devices[k][s * bands])
                          for k, (_, p) in enumerate(layout.shares)
                          for s, cs in enumerate(channel_shares(c, layout.tensor)) if cs.stop > cs.start]
                dynamic[l] = [[(t[rows][:, other].to(dev), t[other][:, rows].to(dev) if h > g else None)
                               for h, (_, other, _) in enumerate(groups) if h >= g]
                              for g, (k, rows, dev) in enumerate(groups) if k == i]
            if dynamic:
                one["style_video"] = dynamic
            out.append(one)
        return out

    def _profiled_run(self, profile_dir, *run_args, **run_kw):
        """``_run`` under ``torch.profiler``, its chrome trace written to a
        file of its own in ``profile_dir``: ``trace.json``, then
        ``trace_1.json``, ``trace_2.json``, ... (a pyramid keeps every
        scale's)."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            out = self._run(*run_args, **run_kw)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(profile_dir, exist_ok=True)
        path, n = os.path.join(profile_dir, "trace.json"), 0
        while os.path.exists(path):
            n += 1
            path = os.path.join(profile_dir, f"trace_{n}.json")
        prof.export_chrome_trace(path)
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
        """One vid_img frame on the (first) device (reference style.py:192-297):
        u8 preprocess and resize, histogram match, content target, the
        flow-warped temporal target, the init (``content``, ``random``,
        ``warp_prev`` or ``blend``), ``num_iters`` iterations, the output
        histogram match and the u8 display image.  On a "space" mesh (the
        first row's bands with a "frames" axis too) the set-up, the warp and
        the init run whole on the first device and are then cut into bands;
        the content target is captured band by band, the iterations run on
        the bands, and the result is gathered before the output histogram
        match.

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
                   "content": self._content_targets(c)}
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
            targets["temporal"] = self._temporal_targets(grid_sample(prev, wmap), wts)

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
        split, gather = self._band_layout(p0.shape)
        p0 = split(p0)
        p, _, log = self._run(p0, opt, opt.init(p0), targets, scale, int(num_iters))
        p = gather(p)
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
        (B, num_iters, n_losses).  On a "space" mesh each band holds all B
        frames' rows.  On a "frames" mesh each row of the mesh takes its
        share of the frames (``parallel.frame_shards``; a chunk the axis
        does not divide runs on the first row), and the results come back
        to the first device."""
        if init_mode not in ("content", "random"):
            raise ValueError(f"optimize_frames takes a chain-free init, not {init_mode!r}")
        contents_u8 = np.asarray(contents_u8)
        seeds = list(seeds) if seeds is not None else list(range(len(contents_u8)))
        blend_weights = list(blend_weights) if blend_weights is not None else [1.0 / max(len(styles), 1)] * len(styles)
        kw = dict(out_hw=tuple(int(v) for v in out_hw), content_scale=content_scale, blend_weights=blend_weights,
                  init_mode=init_mode, hist_stats=hist_stats)
        shards = frame_shards(self.sharding, len(contents_u8))
        if shards is None:  # no "frames" axis, or a chunk it does not divide
            pastiches, displays, log = _drain(self._frames_job(contents_u8, styles, num_iters, seeds, **kw))
        else:
            # each row's share with its own extractor copy and style targets
            # (captured once, here, and copied; the host copies of the styles
            # the cache compares with are shared); the host enqueues one
            # iteration of every row's step in turn
            self.style_targets(styles, blend_weights)
            entry = self._style_cache
            jobs = []
            for row, part in shards:
                replica = self._replica(row)
                if replica is not self:
                    replica._style_cache = entry._replace(
                        targets={l: t.to(replica.device) for l, t in entry.targets.items()})
                jobs.append(replica._frames_job(contents_u8[part], styles, num_iters, seeds[part], **kw))
            outs = _drain_all(jobs)
            pastiches, displays, log = (torch.cat([o[i].to(self.device) for o in outs]) for i in range(3))
        self.last_loss_log = log
        return pastiches, displays

    def _frames_job(self, contents_u8, styles, num_iters, seeds, *, out_hw, content_scale, blend_weights, init_mode,
                    hist_stats):
        """``optimize_frames``'s work on this engine's device (on a "space"
        mesh its bands), a generator that yields after each iteration;
        returns (pastiches, displays, log (B, num_iters, n_losses))."""
        u8 = _on(contents_u8, self.device)  # the chunk goes up at once
        c = torch.cat([self._frame_content(f, out_hw, content_scale, hist_stats) for f in u8])
        targets = {"style": self.style_targets(styles, blend_weights), "content": self._content_targets(c)}
        # one frame's unbanded shapes, as optimize_frame's scale sees them
        scale = dict(self._strength_scale({"style": targets["style"],
                                           "content": {l: frame_slice(t, 0) for l, t in targets["content"].items()}}))
        p0 = c if init_mode == "content" else torch.cat([self._noise(seed, out_hw) for seed in seeds])
        split, gather = self._band_layout(p0.shape)
        p0 = split(p0)
        opt = self._make_optimizer(frames=True)
        p, _, log = yield from self._steps(p0, opt, opt.init(p0), targets, scale, int(num_iters), frames=True)
        p = gather(p)
        outs = [match_histogram_device(f, *hist_stats) if hist_stats is not None else f for f in p.split(1)]
        return torch.stack(outs), torch.stack([deprocess_to_u8(o) for o in outs]), log.transpose(0, 1)

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


def _same(x):
    return x


def _whole_shape(t, shares: int = 1) -> tuple[int, ...]:
    """A target's shape, or for a banded one (a list; of ``shares`` channel
    shares, share-major) the whole image's."""
    if isinstance(t, list):
        cols = spatial.columns(t, shares)
        return (t[0].shape[0], sum(col[0].shape[1] for col in cols), sum(x.shape[2] for x in cols[0]), t[0].shape[3])
    return tuple(t.shape)


def _drain(gen):
    """Run a step generator to its end; its return value."""
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


def _drain_all(gens: list) -> list:
    """Run step generators side by side, one step of each in turn (each
    device's work enqueued every iteration); their return values."""
    out, live = [None] * len(gens), list(range(len(gens)))
    while live:
        for i in list(live):
            try:
                next(gens[i])
            except StopIteration as stop:
                out[i] = stop.value
                live.remove(i)
    return out


def _on(x, device) -> torch.Tensor:
    """A host array or a tensor, as a tensor on ``device`` (dtype kept)."""
    return x.to(device) if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x)).to(device)


def _nchw(x, device) -> torch.Tensor:
    """A (1, 3, H, W) tensor as it is, or a (1, H, W, 3) host array as NCHW."""
    return x.to(device).float() if isinstance(x, torch.Tensor) else to_nchw(x, device)


__all__ = ["StyleEngine", "to_nchw", "to_nhwc", "resolve_device", "apply_precision"]
