#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (maua_style_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught and passed over):

1. Device: the card's name and power limit (nvidia-smi), the torch and CUDA
   versions, and the seconds each kernel build took (one ``nvcc`` per
   source under ``csrc/``, all started at once, for sm_90a).
2. K1 check: the Gram kernel (csrc/gram.cu) against its plain PyTorch
   version on the card, f32 and bf16, at the VGG-19 style-layer shapes of a
   1024² image, at ragged shapes of the 724 and 1448 scales and at B = 2
   (bars: max|Δ| / max|G| <= 1e-4 against the plain version, <= 1e-5
   against an f64 Gram for f32, two launches bit-identical), and the
   backward of the Gram's autograd Function against autograd of the plain
   version.  Times of the kernel, the plain version and ``torch.bmm``, each
   per call and on the device, beside the tensor-core bound.  Then the same
   bars and times at every K1 input of phase 6's path: its windows' per-
   frame batches (gfw, C, H·W) and whole-window views (1, gfw·C, H·W) at
   its three scales, with the partial buffer's bytes, the peak memory of
   the largest view and the backward at C' = 9216 and at B = 18; and at
   the NCA trainer's ten inputs, VGG-16's five style layers of a batch of
   4 CA states of 128² and of the 128² style target, with the backward at
   (4, 64, 16384) and (4, 512, 64); at the similarity phase's ten,
   VGG-19's five style layers at 256² and 512²; and at every input phase
   5's two vid_img runs hand K1, f32: the stacked first pass's (B, C, N)
   at the chunk sizes the capacity model gives (512x288 and 1024x576),
   the per-frame passes' (1, C, N) and the style captures'.
3. K2 check: the cost-volume kernel (csrc/correlation.cu) against its plain
   version, f32, at the five PWC levels of a 1024x576 and a 1920x1088 frame
   pair at B = 1 and B = 8, at one d = 3 and one (d = 20, s = 2) shape, at
   the 1 x 1 level of a 64² input, at LiteFlowNet's five levels (d = 3) and
   UnFlow's one (d = 20, s = 2) for 8 pairs of 1024x576 frames (bars: max|Δ| / max|corr| <= 1e-5
   against the plain version, the same against an f64 cost volume, two
   launches bit-identical).  Times (K1 and K2): CUDA events, median of 7
   after warm-up, around one call ("call", host launch work included) or
   around the replay of a CUDA graph of 10 calls (the device time), beside
   the plain version's and the bound; K2's share of its bound per shape
   and summed over the main path's five levels.  K2 is built in one
   library per (d, s) family (its register blocking is fixed at compile
   time); phase 1 prints what ``ptxas -v`` says of each.
4. img_img main path: ``maua_style_tpu_torch.style.main`` on synthetic
   images through the default 256..1448 pyramid with L-BFGS (history 100),
   VGG-19 at full width with seeded random weights, f32, --precision
   highest.  Checks the PNGs, the loss logs and the K1 launch count; then a
   small input on the GPU and on the CPU, and a torch.profiler window of 5
   iterations at 1024² (report only).
5. vid_img main path: ``style.main --transfer_type vid_img`` on a synthetic
   8-frame 1024x576 video whose pattern moves a few pixels per frame, a 768²
   style, SPyNet + PWC flow, sizes 512 and 1024 with 80 and 40 iterations
   over 4 passes, --init random, VGG-19 f32 --precision highest, seeded
   random weights.  The first pass of the first scale runs stacked
   (``optimize_frames``) in the chunks ``frame_loop._auto_frame_batch``
   gives (no --frame_batch); the chunk sizes at 512 and 1024, the first
   pass's seconds and the later passes' s per frame are printed.  Checks
   every artifact of the schema, finite .flo files and loss logs, the
   chunks, every K1 input against phase 2's, and the K1 and K2 launch
   counts (K1: 5 per iteration per chunk of the stacked pass, 5 per
   iteration per frame of every other pass, 5 per style capture); then
   SPyNet + PWC on the GPU and on the CPU (TF32 off), a torch.profiler
   window over one later-pass 1024x576 frame (report only), and one chunk
   of 4 frames at 1024x576, 5 iterations, TF32 off, stacked against
   per-frame under ``cudnn.deterministic`` (Adam from the content init,
   L-BFGS from the random init; bar: loss logs within rtol 1e-2, mean|Δ| of
   the pastiches within 1e-2 of mean|p|) and the seconds of both.  Then
   the same clip with
   ``--flow_models unflow,liteflownet`` at size 1024 only, 20 iterations
   over 2 passes (the same checks; K2 launches 1 a forward for UnFlow and
   5 for LiteFlowNet), and each of the two nets on the GPU against the
   CPU.
6. img_vid main path: ``style.main --transfer_type img_vid`` on a synthetic
   1024x576 content image and a 24-frame 768x432 style video whose pattern
   moves a few pixels per frame, with the defaults' window structure
   (--gram_frame_window 18,9,7, --avg_frame_window 18, --video_style_factor
   100, --temporal_blend 0.5, L-BFGS history 100), --init random, VGG-19
   f32 --precision highest, cut to 24 frames, sizes 256/512/724 and 4
   iterations a window.  Checks the per-scale and final stacks, finite
   outputs and loss logs, a non-zero dynamic term at every scale, every
   K1 input shape (per-frame and whole-window) against phase 2's, and K1's
   launch count against the schedule's formula (the dynamic term is read
   by the plain version after each scale's timed run, from a copy of its
   first activations); a torch.profiler window over one img_vid window
   at 256 and at 724 (report only); then a 6-frame window run on the GPU
   and on the CPU (TF32 off).
6b. Neural CA: ``pipelines.nca_train.train`` at the JAX defaults (12
   channels, hidden 96, a pool of 1024 states of 128² on the card, batch 4,
   32-96 CA steps, VGG-16 f32 with seeded random weights), cut to 40 steps
   with a checkpoint every 5: finite losses, a learned w2, the artifacts,
   K1's inputs against phase 2's and its launches (5 + 5 a step); the
   median ms per step and the peak memory.  Then ``nca_gen.main`` on the
   last checkpoint, 90 frames of each video (evolution, a 4-checkpoint
   grid, ``--text``), seconds per frame; and one training step on the GPU
   and on the CPU from the same draws (losses within rtol 1e-3).
6c. CLIP-guided VQGAN: ``pipelines.clip_vqgan.main`` at the JAX defaults
   (ViT-B/32, imagenet_16384, 64 cutouts, Adam 0.05; seeded random
   weights, f32, TF32 off) on the main path's images fitted to 256² and a
   style text, cut to 100 iterations with a save every 50: the artifact,
   the log lines, a finite loss log, no K1/K2 launch; ms per iteration,
   the CLI's wall, the targets' seconds and the peak memory; a
   torch.profiler window of 5 iterations and ms per iteration with
   ``cudnn.benchmark`` off and on, in turns (report only); then the models
   on the GPU against the CPU (CLIP embeddings and a decode within 1e-4,
   one iteration's loss terms within rtol 1e-3 with z fixed to codes, the
   share of agreeing quantize indices printed).
6d. clip_vqgan with ``--clip_backbone RN50`` (widths 64..2048, 3/4/6/3
   bottlenecks, 224 input), the other settings 6c's, cut to 50 iterations:
   the same checks and numbers, a profile with the RN tower's forward and
   backward ms; then RN50, RN101 and RN50x4 image and text embeddings on
   the GPU against the CPU (1e-4), each tower's forward GFLOP and layer
   outputs from its shapes, and one RN50 iteration's loss terms (rtol
   1e-3, z fixed to codes as in 6c).
6e. clip_video_style: ``pipelines.clip_video_style.main`` with ViT-B/32
   and SPyNet + PWC on a 6-frame 1024x576 clip (phase 5's pattern), 256,
   2 passes of 10 iterations a frame, ``--init prev_warp``: the frames,
   .flo files and pass artifacts, K2's launches against the pre-pass's
   formula with each input among phase 3's, K1 0; s per frame, wall s.
6f. similarity: ``pipelines.similarity.main`` on 3 synthetic 512² images,
   ``--image_sizes 256,512 --num_iters 20,10 --grids``: 9 img_img jobs,
   the caches, grids and artifacts, K1's launches against img_img's
   formula summed over the jobs with each input among phase 2's (which
   holds K1 at its ten shapes), K2 0; wall s per job.
7. Paths no other phase drives (report only; a failure fails the run):
   img_img at 512² with --compute_dtype bfloat16, --precision high,
   --optimizer adam and --original_colors, and a short vid_img with --init
   prev_warp --original_colors; then the 1024² img_img step twice from one
   seed, with and without ``torch.backends.cudnn.deterministic``, printing
   the first activation, Gram, loss or gradient that differs.
7b. The capacity tuner (``tuning/max_sizes.py``), last because its probes
   fill the card: measured peaks of VGG-19 (L-BFGS compact and two-loop,
   Adam; f32 and bf16) and prune (Adam, f32) at 512², 1024² and 2048²
   beside the estimate and its error, the constants fitted to them, the
   measured search for VGG-19 (L-BFGS and Adam, f32) written to
   chiprun_out/chip_smoke/, ``hbm_bytes()`` and the frame sizing; fails if
   the allocator's count does not return to its start.
8. A ``kernels`` JSON line, the card line, and last the ``ok`` line.

Exits non-zero without an ``ok`` line when there is no CUDA device, when
the package is not beside this script, or when any phase fails.  Details
go to chiprun_out/chip_smoke/results.json; the video runs' artifacts are
deleted once checked.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# H100 SXM data sheet (dense): FP32 SIMT, TF32 and bf16 tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

SIZES = (256, 512, 724, 1024, 1448)
ITERS = (20, 20, 20, 20, 10)
STYLE_LAYERS = 5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def hw_style_shapes(h: int, w: int) -> list[tuple[int, int]]:
    """(C, N) of relu1_1..relu5_1 for an h x w image (floor pools)."""
    out = []
    for c in (64, 128, 256, 512, 512):
        out.append((c, h * w))
        h, w = h // 2, w // 2
    return out


def vgg_style_shapes(side: int) -> list[tuple[int, int]]:
    """(C, N) of relu1_1..relu5_1 for a side x side image."""
    return hw_style_shapes(side, side)


def time_ms(fn, reps: int = 7, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, launches: int = 10) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured in a
    CUDA graph, its replay timed by ``time_ms``.  Unlike events around one
    call, this leaves out the host's launch work, which is longer than a
    small kernel."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # first use outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms = time_ms(graph.replay) / launches
    del graph
    return ms


def gram_bound_ms(b: int, c: int, n: int, dtype, simt: bool = False) -> tuple[float, str]:
    """max(operations / peak, bytes / bandwidth).  G = F Fᵀ is symmetric, so
    the function needs the C(C+1)/2 entries on and above the diagonal:
    2·N·C(C+1)/2 = N·C·(C+1) operations per frame.  On the tensor cores an
    f32-accurate product takes three TF32 products (3xTF32), 3·N·C·(C+1)
    operations at the TF32 rate; bf16 products are exact, N·C·(C+1) at the
    bf16 rate.  ``simt``: f32 and bf16 alike at the FP32 SIMT rate, the
    bound of the SIMT kernel this one replaced.  Each input element is read
    once, each f32 output written once."""
    import torch

    f32 = dtype == torch.float32
    elt = 4 if f32 else 2
    work = 1.0 * b * n * c * (c + 1)
    ops = work / PEAK_FP32 if simt else (3 * work / PEAK_TF32 if f32 else work / PEAK_BF16)
    byt = (elt * b * c * n + 4.0 * b * c * c) / PEAK_BYTES
    return max(ops, byt) * 1e3, ("operations" if ops >= byt else "bytes")


def measure_gram(f) -> dict:
    """K1 on one (B, C, N) input: the bars (max|Δ| / max|G| <= 1e-4 against
    the plain version, <= 1e-5 against an f64 Gram for f32, two launches
    bit-identical) and the times of the kernel, the plain version and
    ``torch.bmm``, per call by events (host launch work included) and on
    the device alone by a CUDA graph of 10 calls, beside the bound."""
    import torch

    from maua_style_tpu_torch.ops import gram as G

    b, c, n = f.shape
    got = G.gram(f)
    torch.cuda.synchronize()
    want = G.gram_reference(f)
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    # both against an f64 Gram: which of the two sums is nearer exact
    f64 = f.double()
    exact = torch.bmm(f64, f64.transpose(1, 2))
    scale = float(exact.abs().max())
    rel64 = (float((got - exact).abs().max()) / scale, float((want - exact).abs().max()) / scale)
    del f64, exact, want
    what = f"gram {tuple(f.shape)} {f.dtype}"
    if not rel <= 1e-4:
        fail(f"{what}: max|d|/max|G| = {rel:.3e} > 1e-4")
    if f.dtype == torch.float32 and not rel64[0] <= 1e-5:
        fail(f"{what}: max|d|/max|G| = {rel64[0]:.3e} > 1e-5 against an f64 Gram")
    if not torch.equal(G.gram(f), got):
        fail(f"{what}: two launches differ (must be deterministic)")
    del got
    row = {"max_abs_err": err, "rel_err": rel, "kernel_rel_err_f64": rel64[0], "plain_rel_err_f64": rel64[1]}
    ft = f.transpose(1, 2)
    for key, fn in (("kernel", lambda: G.gram(f)), ("plain", lambda: G.gram_reference(f)),
                    ("library", lambda: torch.bmm(f, ft))):
        row[f"{key}_call_ms"] = time_ms(fn)
        row[f"{key}_ms"] = graph_ms(fn)
    row["bound_ms"], row["bound_by"] = gram_bound_ms(b, c, n, f.dtype)
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    return row


def check_gram_backward(shape, gen) -> float:
    """The backward of the Gram's autograd Function against autograd of
    the plain version, f32: max|Δ| / max|g| <= 1e-4."""
    import torch

    from maua_style_tpu_torch.ops import gram as G

    f = torch.randn(shape, device=gen.device, generator=gen).requires_grad_(True)
    w = torch.randn((shape[0], shape[1], shape[1]), device=gen.device, generator=gen)
    (gk,) = torch.autograd.grad((G._GramFn.apply(f) * w).sum(), f)
    (gp,) = torch.autograd.grad((G.gram_reference(f) * w).sum(), f)
    rel = float((gk - gp).abs().max() / gp.abs().max())
    print(f"gram backward {tuple(shape)} float32: max|d|/max|g| = {rel:.3e}")
    if not rel <= 1e-4:
        fail(f"gram backward {tuple(shape)}: {rel:.3e} > 1e-4")
    return rel


def check_gram(results: dict) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    main = [(1, c, n) for c, n in vgg_style_shapes(1024)]
    ragged = [(1, c, n) for c, n in vgg_style_shapes(724)] + [(1, c, n) for c, n in vgg_style_shapes(1448)[:2]]
    ragged += [(2, 128, 362 * 362), (2, 256, 181 * 181)]
    rows = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in main + ragged:
            b, c, n = shape
            f = torch.relu(torch.randn(shape, device=dev, generator=gen)).to(dtype)
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1], "main_path_1024": shape in main,
                   **measure_gram(f)}
            row["bound_simt_ms"] = gram_bound_ms(b, c, n, dtype, simt=True)[0]
            rows.append(row)
            print("gram", json.dumps(row))

    check_gram_backward((1, 128, 65536), gen)
    results["gram"] = rows
    f32_main = [r for r in rows if r["main_path_1024"] and r["dtype"] == "float32"]
    return {
        "name": "gram",
        "route": "cuda",
        "source": "maua_style_tpu_torch/csrc/gram.cu",
        "replaces": "maua_style_tpu/ops/pallas_gram.py:22",
        "max_abs_err": max(r["max_abs_err"] for r in f32_main),
        "max_rel_err_f64": max(r["kernel_rel_err_f64"] for r in f32_main),
        # one iteration's forward Grams at 1024², f32: the five style layers,
        # on the device (graphs) and per call (events)
        "ms": sum(r["kernel_ms"] for r in f32_main),
        "call_ms": sum(r["kernel_call_ms"] for r in f32_main),
        "plain_ms": sum(r["plain_ms"] for r in f32_main),
        "plain_call_ms": sum(r["plain_call_ms"] for r in f32_main),
        "bound_ms": sum(r["bound_ms"] for r in f32_main),
        # the term that accounts for more of the summed bound
        "bound_by": max(("operations", "bytes"), key=lambda k: sum(r["bound_ms"] for r in f32_main if r["bound_by"] == k)),
        "bound_simt_ms": sum(r["bound_simt_ms"] for r in f32_main),
        "library_ms": sum(r["library_ms"] for r in f32_main),
        "library_call_ms": sum(r["library_call_ms"] for r in f32_main),
        # device time below torch.bmm's at every one of those shapes
        "faster_than_library": all(r["kernel_ms"] < r["library_ms"] for r in f32_main),
        "checked": True,
    }


IV_HW, IV_STYLE_HW, IV_FRAMES, IV_STYLE_FRAMES = (576, 1024), (432, 768), 24, 24
IV_SIZES, IV_ITERS, IV_GFW, IV_AFW = (256, 512, 724), (4, 4, 4), (18, 9, 7), 18


def img_vid_gram_shapes() -> list[tuple[int, int, int, int]]:
    """(size, gfw, C, N) of the style layers that the img_vid phase's Grams
    see: relu1_1..relu5_1 of a gfw-frame window at each scale, of the
    1024x576 pastiche and of the style video, which ``scale_styles``
    resizes to about the content's area (VGG-19's 2x2 pools round down).
    K1 gets each as a batch of per-frame Grams, (gfw, C, N), and as the
    whole-window view, (1, gfw·C, N)."""
    import math

    from maua_style_tpu_torch.ops.resize import scale_shape

    out = set()
    for size, gfw in zip(IV_SIZES, IV_GFW):
        hw = scale_shape(IV_HW, size / max(IV_HW))
        style_hw = scale_shape(IV_STYLE_HW, math.sqrt(hw[0] * hw[1] / (IV_STYLE_HW[0] * IV_STYLE_HW[1])))
        for h, w in (hw, style_hw):
            for c in (64, 128, 256, 512, 512):
                out.add((size, gfw, c, h * w))
                h, w = h // 2, w // 2
    return sorted(out)


def img_vid_gram_inputs() -> dict[str, set[tuple[int, int, int]]]:
    """The (B, C, N) inputs K1 gets on the img_vid phase's path: the
    per-frame batches ("frames") and the whole-window views ("window")."""
    shapes = img_vid_gram_shapes()
    return {"frames": {(gfw, c, n) for _, gfw, c, n in shapes},
            "window": {(1, gfw * c, n) for _, gfw, c, n in shapes}}


def check_video_gram(results: dict) -> dict:
    """K1 at every img_vid shape: the whole-window views, (1, C', N) from
    (1, 1152, 36864) to (1, 9216, 144), and the per-frame batches, (gfw, C,
    N) from (18, 64, 36864) to (7, 512, 1125).  The same bars as phase 2's,
    the times beside the bound, the partial buffer's bytes, the peak memory
    of the largest whole-window shape, and the backward at C' = 9216 and at
    the largest batch."""
    import torch

    from maua_style_tpu_torch.ops import gram as G

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for size, gfw, c0, n in img_vid_gram_shapes():
        for kind, (b, c) in (("window", (1, gfw * c0)), ("frames", (gfw, c0))):
            f = torch.relu(torch.randn((b, c, n), device=dev, generator=gen))
            sp = G.gram_splits(b, c, n, sms)
            row = {"size": size, "gfw": gfw, "kind": kind, "shape": [b, c, n], "tile": sp.tile, "pairs": sp.pairs,
                   "splits": [sp.splits_diag, sp.splits_off],
                   "partial_bytes": 4 * max(sp.splits_diag, sp.splits_off) * b * sp.pairs * sp.tile * sp.tile,
                   "output_bytes": 4 * b * c * c, **measure_gram(f)}
            rows.append(row)
            print("img_vid gram", json.dumps(row))
            del f
    # peak memory of one launch at the largest output and N
    c, n = max(((r["shape"][1], r["shape"][2]) for r in rows if r["kind"] == "window"), key=lambda t: (t[0], t[1]))
    f = torch.relu(torch.randn((1, c, n), device=dev, generator=gen))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = G.gram(f)
    torch.cuda.synchronize()
    peak = {"shape": [1, c, n], "input_bytes": 4 * c * n, "peak_bytes_above_input": torch.cuda.max_memory_allocated() - base}
    print("video gram peak memory", json.dumps(peak))
    del f, out
    brel = [check_gram_backward(shape, gen) for shape in ((1, 9216, 144), (18, 64, 36864))]
    torch.cuda.empty_cache()
    results["gram_img_vid"] = {"rows": rows, "peak_memory": peak, "backward_rel": brel}
    out = {}
    for kind in ("window", "frames"):
        kr = [r for r in rows if r["kind"] == kind]
        out[kind] = {"ms": sum(r["kernel_ms"] for r in kr), "library_ms": sum(r["library_ms"] for r in kr),
                     "plain_ms": sum(r["plain_ms"] for r in kr), "bound_ms": sum(r["bound_ms"] for r in kr),
                     "max_rel_err_f64": max(r["kernel_rel_err_f64"] for r in kr), "shapes": len(kr)}
    return out


NCA_GRID, NCA_BATCH = 128, 4


def nca_gram_shapes() -> list[tuple[int, int, int]]:
    """(B, C, N) of K1's inputs on the NCA phase's path: VGG-16's relu1_1 ..
    relu5_1 of a training batch of 4 CA states of 128² and of the 128²
    style thumbnail (B = 1)."""
    return [(b, c, n) for b in (NCA_BATCH, 1) for c, n in vgg_style_shapes(NCA_GRID)]


def check_nca_gram(results: dict) -> dict:
    """K1 at the NCA trainer's ten input shapes, with phase 2's bars and
    times, and the backward at the largest and the smallest batch shape."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for shape in nca_gram_shapes():
        f = torch.relu(torch.randn(shape, device=dev, generator=gen))
        row = {"shape": list(shape), "kind": "batch" if shape[0] == NCA_BATCH else "target", **measure_gram(f)}
        rows.append(row)
        print("nca gram", json.dumps(row))
        del f
    brel = [check_gram_backward(shape, gen) for shape in ((NCA_BATCH, 64, 16384), (NCA_BATCH, 512, 64))]
    results["gram_nca"] = {"rows": rows, "backward_rel": brel}
    step = [r for r in rows if r["kind"] == "batch"]  # one training step's forward Grams
    return {"ms": sum(r["kernel_ms"] for r in step), "call_ms": sum(r["kernel_call_ms"] for r in step),
            "plain_ms": sum(r["plain_ms"] for r in step), "library_ms": sum(r["library_ms"] for r in step),
            "bound_ms": sum(r["bound_ms"] for r in step),
            "max_rel_err_f64": max(r["kernel_rel_err_f64"] for r in rows), "shapes": len(rows)}


def corr_bound_ms(b: int, c: int, h: int, w: int, k: int) -> tuple[float, str]:
    """max(operations / peak, bytes / bandwidth): 2·C operations for each of
    the B·H·W·K outputs; f1 and f2 read once (4·B·H·W·C bytes each) and the
    f32 output written once (4·B·H·W·K bytes)."""
    ops = 2.0 * b * h * w * k * c / PEAK_FP32
    byt = 4.0 * b * h * w * (2 * c + k) / PEAK_BYTES
    return max(ops, byt) * 1e3, ("operations" if ops >= byt else "bytes")


def pwc_levels(height: int, width: int) -> list[tuple[int, int, int]]:
    """(C, H, W) of PWC's five correlation levels (6..2) for a frame, after
    the flow module's resize to multiples of 64."""
    h64, w64 = -(-height // 64) * 64, -(-width // 64) * 64
    return [(c, h64 >> lvl, w64 >> lvl) for lvl, c in ((6, 196), (5, 128), (4, 96), (3, 64), (2, 32))]


def liteflownet_levels(height: int, width: int) -> list[tuple[int, int, int]]:
    """(C, H, W) of LiteFlowNet's five correlation levels (6..2, d = 3)."""
    h64, w64 = -(-height // 64) * 64, -(-width // 64) * 64
    return [(c, h64 >> lvl, w64 >> lvl) for lvl, c in ((6, 192), (5, 128), (4, 96), (3, 64), (2, 32))]


def unflow_level(height: int, width: int) -> tuple[int, int, int]:
    """(C, H, W) of UnFlow's one correlation (d = 20, s = 2) at 1/8."""
    return 256, -(-height // 64) * 8, -(-width // 64) * 8


def check_correlation(results: dict) -> dict:
    import torch

    from maua_style_tpu_torch.ops import correlation as K

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = []  # (tag, b, c, h, w, d, s)
    for frame in ((576, 1024), (1088, 1920)):
        for b in (1, 8):
            shapes += [(f"pwc {frame[1]}x{frame[0]}", b, c, h, w, 4, 1) for c, h, w in pwc_levels(*frame)]
    shapes += [("d3", 1, 128, 68, 120, 3, 1), ("d20s2", 1, 256, 48, 64, 20, 2), ("pwc 64x64", 1, 196, 1, 1, 4, 1)]
    # the vid_img phase with UnFlow + LiteFlowNet: 8 pairs of 1024x576 frames
    shapes += [("liteflownet 1024x576", 8, c, h, w, 3, 1) for c, h, w in liteflownet_levels(*VID_HW)]
    shapes += [("unflow 1024x576", 8, *unflow_level(*VID_HW), 20, 2)]
    rows = []
    for tag, b, c, h, w, d, s in shapes:
        f1 = torch.randn((b, c, h, w), device=dev, generator=gen)
        f2 = torch.randn((b, c, h, w), device=dev, generator=gen)
        got = K.correlation(f1, f2, d, s)
        torch.cuda.synchronize()
        want = K.correlation_reference(f1, f2, d, s)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        exact = K.correlation_reference(f1.double(), f2.double(), d, s)
        scale = float(exact.abs().max())
        rel64 = (float((got - exact).abs().max()) / scale, float((want - exact).abs().max()) / scale)
        del exact
        if not rel <= 1e-5:
            fail(f"correlation {tag} {(b, c, h, w, d, s)}: max|d|/max|corr| = {rel:.3e} > 1e-5")
        if not rel64[0] <= 1e-5:
            fail(f"correlation {tag} {(b, c, h, w, d, s)}: max|d|/max|corr| = {rel64[0]:.3e} > 1e-5 against f64")
        if not torch.equal(K.correlation(f1, f2, d, s), got):
            fail(f"correlation {tag} {(b, c, h, w, d, s)}: two launches differ (must be deterministic)")
        k = got.shape[1]
        row = {"tag": tag, "shape": [b, c, h, w], "max_disp": d, "stride": s, "K": k,
               "main_path_1024x576_b8": tag == "pwc 1024x576" and b == 8,
               "max_abs_err": err, "rel_err": rel, "kernel_rel_err_f64": rel64[0], "plain_rel_err_f64": rel64[1]}
        # per call by events (host launch work included) and on the device
        # alone by a CUDA graph of 10 calls
        row["kernel_call_ms"] = time_ms(lambda: K.correlation(f1, f2, d, s))
        row["plain_call_ms"] = time_ms(lambda: K.correlation_reference(f1, f2, d, s))
        row["kernel_ms"] = graph_ms(lambda: K.correlation(f1, f2, d, s))
        row["plain_ms"] = graph_ms(lambda: K.correlation_reference(f1, f2, d, s))
        row["bound_ms"], row["bound_by"] = corr_bound_ms(b, c, h, w, k)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        row["plan"] = K.launch_plan(b, c, h, w, d, s, torch.cuda.get_device_properties(dev).multi_processor_count)._asdict()
        rows.append(row)
        print("correlation", json.dumps(row))
        del f1, f2, got, want
    results["correlation"] = rows
    main = [r for r in rows if r["main_path_1024x576_b8"]]
    return {
        "name": "correlation",
        "route": "cuda",
        "source": "maua_style_tpu_torch/csrc/correlation.cu",
        "replaces": "maua_style_tpu/ops/correlation.py:47",
        "max_abs_err": max(r["max_abs_err"] for r in main),
        # one PWC forward's five cost volumes on the main path's pair chunk
        # (8 pairs of 1024x576 frames)
        "ms": sum(r["kernel_ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "call_ms": sum(r["kernel_call_ms"] for r in main),
        "plain_call_ms": sum(r["plain_call_ms"] for r in main),
        "bound_ms": sum(r["bound_ms"] for r in main),
        "bound_by": max(("operations", "bytes"), key=lambda k: sum(r["bound_ms"] for r in main if r["bound_by"] == k)),
        "bound_share": sum(r["bound_ms"] for r in main) / sum(r["kernel_ms"] for r in main),
        "bound_share_by_level": [r["bound_share"] for r in main],
        "library_ms": None,  # no single PyTorch call computes a cost volume
        # one forward of each net added by the UnFlow + LiteFlowNet phase
        "by_net": {tag.split()[0]: {k: sum(r[f"{k}_ms"] for r in rows if r["tag"] == tag)
                                    for k in ("kernel", "kernel_call", "plain", "bound")}
                   for tag in ("liteflownet 1024x576", "unflow 1024x576")},
        "checked": True,
    }


@contextlib.contextmanager
def patched(*targets):
    """While inside, ``obj.name`` calls ``wrapper(original, *args,
    **kwargs)`` for each (obj, name, wrapper) in ``targets``; the originals
    come back on exit.  The replacement is a plain function, so a method
    patched on a class still gets its ``self``."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
    for (obj, name, fn), (_, _, wrapper) in zip(saved, targets):
        def call(*a, _fn=fn, _wrapper=wrapper, **kw):
            return _wrapper(_fn, *a, **kw)

        setattr(obj, name, call)
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def seconds_into(spans: dict, name: str):
    """A ``patched`` wrapper that adds each call's wall seconds to
    ``spans[name]``."""
    def wrapper(fn, *a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0

    return wrapper


def reset_counts() -> None:
    from maua_style_tpu_torch.ops import correlation as K
    from maua_style_tpu_torch.ops import gram as G

    G.gram.launches = 0
    K.correlation.launches = 0


def read_counts() -> dict[str, int]:
    from maua_style_tpu_torch.ops import correlation as K
    from maua_style_tpu_torch.ops import gram as G

    return {"gram": G.gram.launches, "correlation": K.correlation.launches}


def write_inputs(d: str) -> tuple[str, str]:
    import numpy as np
    from PIL import Image

    yy, xx = np.mgrid[0:1024, 0:1024].astype(np.float32)
    content = np.stack([
        (np.sin(xx / 37.0) * 0.5 + 0.5) * 255,
        (yy / 1023.0) * 255,
        (((xx - 512) ** 2 + (yy - 400) ** 2) < 250 ** 2) * 200 + 30,
    ], -1)
    sy, sx = np.mgrid[0:768, 0:768].astype(np.float32)
    s = np.sin(sx / 9.0) * np.cos(sy / 13.0) * 127 + 128
    style = np.stack([s, 255 - s, np.roll(s, 40, 0)], -1)
    c_path, s_path = os.path.join(d, "content.png"), os.path.join(d, "style.png")
    Image.fromarray(content.astype(np.uint8)).save(c_path)
    Image.fromarray(style.astype(np.uint8)).save(s_path)
    return c_path, s_path


def run_main_path(results: dict) -> dict[str, int]:
    import numpy as np
    import torch
    from PIL import Image

    from maua_style_tpu_torch import style
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.ops.resize import scale_shape

    run_dir = os.path.join(OUT, "img_img")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    c_path, s_path = write_inputs(run_dir)

    # per-scale timing: each engine's optimize(), and each chunk of iterations
    scales = []
    orig_optimize, orig_run = StyleEngine.optimize, StyleEngine._run

    def timed_optimize(self, content, styles, init, num_iters, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_optimize(self, content, styles, init, num_iters, **kw)
        torch.cuda.synchronize()
        scales.append({"hw": list(np.shape(init)[1:3]), "iters": num_iters,
                       "wall_s": time.perf_counter() - t0, "chunks": self.__dict__.pop("_chunk_ms", []),
                       "log": self.last_loss_log})
        return out

    def timed_run(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_run(self, *a, **kw)
        torch.cuda.synchronize()
        self.__dict__.setdefault("_chunk_ms", []).append(((time.perf_counter() - t0) * 1e3, a[-1]))
        return out

    argv = [
        "--content", c_path, "--style", s_path, "--output_dir", run_dir,
        "--image_sizes", ",".join(map(str, SIZES)), "--num_iters", ",".join(map(str, ITERS)),
        "--optimizer", "lbfgs", "--lbfgs_num_correction", "100", "--model_file", "vgg19",
        "--allow_random_weights", "--precision", "highest", "--compute_dtype", "float32",
        "--seed", "0", "--gpu", "0", "--verbose", "--print_iter", "10",
    ]
    StyleEngine.optimize, StyleEngine._run = timed_optimize, timed_run
    try:
        reset_counts()
        t0 = time.perf_counter()
        style.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        StyleEngine.optimize, StyleEngine._run = orig_optimize, orig_run
    launches = counts["gram"]

    expected = sum(STYLE_LAYERS * (it + 1) for it in ITERS)  # per iteration + one style capture per scale
    print(f"main path: {wall:.1f} s, gram launches {launches} (expected {expected})")
    if launches != expected:
        fail(f"gram launches {launches} != expected {expected}")
    if len(scales) != len(SIZES):
        fail(f"{len(scales)} scales optimised, expected {len(SIZES)}")

    rows = []
    for size, iters, sc in zip(SIZES, ITERS, scales):
        png = os.path.join(run_dir, f"content_style_{size}.png")
        if not os.path.exists(png):
            fail(f"missing {png}")
        want_hw = scale_shape((1024, 1024), size / 1024)
        with Image.open(png) as img:
            got_hw = (img.height, img.width)
        if got_hw != tuple(want_hw) or tuple(sc["hw"]) != tuple(want_hw):
            fail(f"{png}: shape {got_hw}, engine {sc['hw']}, expected {want_hw}")
        log = sc["log"]
        if log is None or log.shape[0] != iters or not np.isfinite(log).all():
            fail(f"scale {size}: loss log {None if log is None else log.shape} not finite / wrong length")
        first, last = float(log[0].sum()), float(log[-1].sum())
        if not last < first:
            fail(f"scale {size}: last total loss {last:g} not below first {first:g}")
        steady_ms, steady_n = sc["chunks"][-1]
        row = {"size": size, "hw": list(want_hw), "iters": iters, "wall_s": sc["wall_s"],
               "ms_per_iter_wall": sc["wall_s"] * 1e3 / iters, "ms_per_iter_last_chunk": steady_ms / steady_n,
               "first_total": first, "last_total": last}
        rows.append(row)
        print("scale", json.dumps(row))
    results["main_path"] = {"wall_s": wall, "launches": counts, "scales": rows, "argv": argv}
    return counts


def check_small_against_cpu(results: dict) -> None:
    """A small input through the engine on the GPU and on the CPU: the same
    losses within rtol 1e-3 (f32, TF32 off; sums in another order)."""
    import numpy as np
    import torch

    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.losses import LossConfig
    from maua_style_tpu_torch.models import init_params, select_model

    spec = select_model("vgg19")
    params = init_params(spec, seed=0)
    rng = np.random.default_rng(0)
    content = rng.normal(0, 50, (1, 64, 96, 3)).astype(np.float32)
    style_img = rng.normal(0, 50, (1, 80, 80, 3)).astype(np.float32)
    init = rng.normal(0, 1, (1, 64, 96, 3)).astype(np.float32)
    logs, outs = [], []
    for device in ("cuda", "cpu"):
        eng = StyleEngine(spec, params, LossConfig(), optimizer="adam", device=device, precision="highest")
        outs.append(eng.optimize(content, [style_img], init, 4))
        logs.append(eng.last_loss_log)
    worst = float(np.max(np.abs(logs[0] - logs[1]) / np.maximum(np.abs(logs[1]), 1e-6)))
    print(f"small input GPU vs CPU: max rel loss diff {worst:.3e}, max |d pixel| {float(np.abs(outs[0] - outs[1]).max()):.3e}")
    if not (np.isfinite(outs[0]).all() and worst <= 1e-3):
        fail(f"GPU and CPU runs disagree: {worst:.3e}")
    results["small_vs_cpu_rel"] = worst


def device_profile(prof, wall_ms: float) -> dict:
    """Device busy time (the union of kernel intervals), device time by
    kernel and by launching aten operator, from a torch.profiler run."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == cuda)
    busy_us, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            busy_us += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy_us += 0.0 if cur_e is None else cur_e - cur_s
    window_us = (spans[-1][1] - spans[0][0]) if spans else 0.0

    def dev_ms(e, total=False):
        return (e.device_time_total if total else e.self_device_time_total) / 1e3

    avgs = prof.key_averages()
    kernels = sorted(((dev_ms(e), e.count, e.key[:90]) for e in avgs if e.device_type == cuda and dev_ms(e) > 0), reverse=True)
    # device time under the aten operators that launch it (nested ops overlap)
    ops = sorted(((dev_ms(e, True), e.count, e.key) for e in avgs
                  if e.device_type != cuda and e.key.startswith("aten::") and dev_ms(e, True) > 0), reverse=True)
    out = {
        "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3, "kernel_window_ms": window_us / 1e3,
        "busy_share_of_wall": busy_us / 1e3 / wall_ms,
        "gram_kernel_ms": sum(ms for ms, _, n in kernels if "gram_partial" in n or "gram_reduce" in n),
        "correlation_kernel_ms": sum(ms for ms, _, n in kernels if "correlation_blocked" in n or "correlation_reduce" in n),
        "top_kernels": kernels[:12], "top_aten_ops": ops[:15],
    }
    if not spans:
        out["note"] = "the profiler saw no device time (not measured)"
    return out


def profile_step(results: dict) -> None:
    """torch.profiler over 5 iterations at 1024² (after a warm-up run).
    Report only: the numbers feed PERF.md's breakdown."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.losses import LossConfig
    from maua_style_tpu_torch.models import init_params, select_model

    spec = select_model("vgg19")
    eng = StyleEngine(spec, init_params(spec), LossConfig(), device="cuda", precision="highest", lbfgs_history=100)
    rng = np.random.default_rng(1)
    content = rng.normal(0, 50, (1, 1024, 1024, 3)).astype(np.float32)
    style_img = rng.normal(0, 50, (1, 1024, 1024, 3)).astype(np.float32)
    init = rng.normal(0, 1, (1, 1024, 1024, 3)).astype(np.float32)
    eng.optimize(content, [style_img], init, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.optimize(content, [style_img], init, 5)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    summary = {"iters": 5, **device_profile(prof, wall_ms),
               "what": "5 iterations at 1024^2 f32, TF32 off, L-BFGS history 100, including content/style capture"}
    print("profile", json.dumps(summary))
    results["profile_1024"] = summary


VID_FRAMES, VID_HW = 8, (576, 1024)
VID_SIZES, VID_ITERS, VID_PASSES = (512, 1024), (80, 40), 4
VID_STYLE_SIDE = 768


def write_video(d: str, n_frames: int = VID_FRAMES) -> tuple[str, str]:
    """A 1024x576 video of ``n_frames`` whose pattern moves (3, 2) px per
    frame, and a 768² style image."""
    import numpy as np
    from PIL import Image

    h, w = VID_HW
    yy, xx = np.mgrid[0 : h + 64, 0 : w + 64].astype(np.float32)
    canvas = np.stack([
        (np.sin(xx / 23.0) * np.cos(yy / 31.0) * 0.5 + 0.5) * 255,
        (np.sin((xx + yy) / 57.0) * 0.5 + 0.5) * 255,
        (((xx - 500) ** 2 + (yy - 300) ** 2) < 180 ** 2) * 180 + 40,
    ], -1)
    frames = np.stack([canvas[2 * t : 2 * t + h, 3 * t : 3 * t + w] for t in range(n_frames)]).astype(np.uint8)
    v_path = os.path.join(d, "vid.npy")
    np.save(v_path, frames)
    sy, sx = np.mgrid[0:768, 0:768].astype(np.float32)
    st = np.sin(sx / 9.0) * np.cos(sy / 13.0) * 127 + 128
    s_path = os.path.join(d, "style.png")
    Image.fromarray(np.stack([st, 255 - st, np.roll(st, 40, 0)], -1).astype(np.uint8)).save(s_path)
    return v_path, s_path


# the UnFlow + LiteFlowNet vid_img phase: phase 5's clip at 1024 only
VD_FLOW, VD_SIZES, VD_ITERS, VD_PASSES = "unflow,liteflownet", (1024,), (20,), 2
# K2 launches per forward of each flow net
K2_PER_FORWARD = {"spynet": 0, "pwc": 5, "unflow": 1, "liteflownet": 5}


def vid_hw(size: int) -> tuple[int, int]:
    """The clip's (h, w) at a scale, as the frame loop sizes it."""
    from maua_style_tpu_torch.ops.resize import scale_shape

    return tuple(scale_shape(VID_HW, size / max(VID_HW)))


def vid_capacity_args():
    """Phase 5's run args (VGG-19, L-BFGS history 100, f32, the card), for
    the frame loop's capacity helpers."""
    from maua_style_tpu_torch import config

    return config.get_args(vid_argv("vid.npy", "style.png", OUT))


def first_pass_chunks(size: int, args) -> list[int]:
    """The stacked first pass's chunk sizes for the clip's frames at
    ``size``: the frame loop's rule (the capacity model's batch, each chunk
    rounded down to a power of two)."""
    from maua_style_tpu_torch.pipelines.frame_loop import _auto_frame_batch

    batch, left, chunks = _auto_frame_batch(vid_hw(size), 0, args), VID_FRAMES, []
    while left:
        chunks.append(1 << (min(batch, left).bit_length() - 1))
        left -= chunks[-1]
    return chunks


def vid_gram_inputs(args, sizes, passes: int) -> set[tuple[int, int, int]]:
    """The (B, C, N) inputs K1 gets on a vid_img run: each scale's style
    capture (the 768² style scaled to the frame's area), the stacked first
    pass's chunks at the first scale, and the per-frame later passes."""
    import math

    from maua_style_tpu_torch.ops.resize import scale_shape

    out = set()
    for si, size in enumerate(sizes):
        h, w = vid_hw(size)
        factor = math.sqrt(h * w / (VID_STYLE_SIDE * VID_STYLE_SIDE))
        out |= {(1, c, n) for c, n in hw_style_shapes(*scale_shape((VID_STYLE_SIDE, VID_STYLE_SIDE), factor))}
        if si == 0:
            out |= {(b, c, n) for b in set(first_pass_chunks(size, args)) for c, n in hw_style_shapes(h, w)}
        if si > 0 or passes > 1:
            out |= {(1, c, n) for c, n in hw_style_shapes(h, w)}
    return out


def vid_runs_gram_inputs() -> set[tuple[int, int, int]]:
    """K1's inputs on phase 5's two vid_img runs."""
    args = vid_capacity_args()
    return vid_gram_inputs(args, VID_SIZES, VID_PASSES) | vid_gram_inputs(args, VD_SIZES, VD_PASSES)


def check_vid_gram(results: dict) -> dict:
    """K1 at every input phase 5's vid_img runs hand it (the stacked first
    pass's (B, C, N), the per-frame passes' and the style captures'), f32,
    with phase 2's bars and times."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for shape in sorted(vid_runs_gram_inputs()):
        f = torch.relu(torch.randn(shape, device="cuda", generator=gen))
        row = {"shape": list(shape), "stacked": shape[0] > 1, **measure_gram(f)}
        rows.append(row)
        print("vid_img gram", json.dumps(row))
        del f
    results["gram_vid_img"] = rows
    stacked = [r for r in rows if r["stacked"]]
    return {"ms": sum(r["kernel_ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "library_ms": sum(r["library_ms"] for r in rows), "bound_ms": sum(r["bound_ms"] for r in rows),
            "stacked_ms": sum(r["kernel_ms"] for r in stacked), "stacked_library_ms": sum(r["library_ms"] for r in stacked),
            "stacked_bound_ms": sum(r["bound_ms"] for r in stacked),
            "stacked_slower_than_library": [r["shape"] for r in stacked if r["kernel_ms"] >= r["library_ms"]],
            "max_rel_err_f64": max(r["kernel_rel_err_f64"] for r in rows), "shapes": len(rows)}


def vid_argv(v_path: str, s_path: str, run_dir: str, flow_models: str = "spynet,pwc", sizes=VID_SIZES,
             iters=VID_ITERS, passes: int = VID_PASSES) -> list[str]:
    return [
        "--transfer_type", "vid_img", "--content", v_path, "--style", s_path, "--output_dir", run_dir,
        "--flow_models", flow_models, "--image_sizes", ",".join(map(str, sizes)),
        "--num_iters", ",".join(map(str, iters)), "--passes_per_scale", str(passes),
        "--init", "random", "--model_file", "vgg19", "--allow_random_weights", "--precision", "highest",
        "--compute_dtype", "float32", "--seed", "0", "--gpu", "0", "--verbose",
    ]


def run_vid_img(results: dict, key: str = "vid_img", flow_models: str = "spynet,pwc", sizes=VID_SIZES,
                iters=VID_ITERS, passes: int = VID_PASSES) -> dict[str, int]:
    """``style.main --transfer_type vid_img`` on the 8-frame 1024x576 clip
    (phase 5 with SPyNet + PWC, and the UnFlow + LiteFlowNet phase), its
    artifacts, finite flows and losses, and both kernels' launches against
    the schedule's formula.  The run's files stay in OUT/``key``."""
    import numpy as np
    import torch
    from PIL import Image

    from maua_style_tpu_torch import losses, style
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.io.flo import read_flo
    from maua_style_tpu_torch.pipelines import flow_prepass, frame_loop

    run_dir = os.path.join(OUT, key)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    v_path, s_path = write_video(run_dir)
    argv = vid_argv(v_path, s_path, run_dir, flow_models, sizes, iters, passes)

    frames, chunks, prepass, seen = [], [], [], set()

    def timed_frame(fn, self, content_u8, styles, num_iters, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(self, content_u8, styles, num_iters, **kw)
        torch.cuda.synchronize()
        log = self.last_loss_log.cpu().numpy()
        frames.append({"hw": list(kw["out_hw"]), "mode": kw.get("init_mode"), "iters": num_iters,
                       "s": time.perf_counter() - t0, "finite": bool(np.isfinite(log).all()),
                       "first_total": float(log[0].sum()), "last_total": float(log[-1].sum())})
        return out

    def timed_chunk(fn, self, contents_u8, styles, num_iters, **kw):
        # the stacked first pass: one record per frame, each the chunk's
        # seconds shared out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(self, contents_u8, styles, num_iters, **kw)
        torch.cuda.synchronize()
        secs, logs = time.perf_counter() - t0, self.last_loss_log.cpu().numpy()
        chunks.append({"frames": len(logs), "s": secs})
        for log in logs:
            frames.append({"hw": list(kw["out_hw"]), "mode": kw.get("init_mode"), "iters": num_iters,
                           "s": secs / len(logs), "finite": bool(np.isfinite(log).all()),
                           "first_total": float(log[0].sum()), "last_total": float(log[-1].sum()), "stacked": True})
        return out

    def timed_pairs(fn, model, missing, flow_dir, args):
        t0 = time.perf_counter()
        fn(model, missing, flow_dir, args)
        torch.cuda.synchronize()
        prepass.append({"pairs": len(missing), "wall_s": time.perf_counter() - t0})

    def recording(fn, x, use_covariance=False):
        seen.add((x.shape[0], x.shape[1], x.shape[2] * x.shape[3]))
        return fn(x, use_covariance)

    with patched((StyleEngine, "optimize_frame", timed_frame), (StyleEngine, "optimize_frames", timed_chunk),
                 (flow_prepass, "_compute_flow_pairs", timed_pairs), (losses, "batch_gram", recording)):
        reset_counts()
        t0 = time.perf_counter()
        style.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()

    # K1: one style capture per scale (one style image, 5 layers); 5 Grams
    # per iteration of each chunk of the first scale's stacked first pass,
    # and of every frame of every other pass
    cap_args = vid_capacity_args()
    first_chunks = first_pass_chunks(sizes[0], cap_args)
    per_frame = [it // passes for it in iters]
    want_gram = sum(5 + 5 * VID_FRAMES * passes * it for it in per_frame)
    want_gram -= 5 * per_frame[0] * (VID_FRAMES - len(first_chunks))
    for size in sizes:
        hw = vid_hw(size)
        print(f"{key} chunks at {size} ({hw[0]}x{hw[1]}): stacked first pass {first_pass_chunks(size, cap_args)}, "
              f"chained {frame_loop._auto_chain_k(hw, cap_args)}")
    if [c["frames"] for c in chunks] != first_chunks:
        fail(f"{key}: first-pass chunks {[c['frames'] for c in chunks]} != the frame loop's rule {first_chunks}")
    checked = vid_gram_inputs(cap_args, sizes, passes)
    if seen != checked:
        fail(f"{key}'s Gram inputs {sorted(seen)} != phase 2's {sorted(checked)}")
    # K2: each net's launches per forward (PWC and LiteFlowNet 5 levels,
    # UnFlow 1), forward and backward flow per chunk of 8 pairs; the pairs
    # are the frames' successors plus the wrap-around
    per_forward = sum(K2_PER_FORWARD[n] for n in flow_models.split(","))
    want_corr = per_forward * 2 * -(-VID_FRAMES // flow_prepass.PAIR_CHUNK)
    print(f"{key} path: {wall:.1f} s, launches {counts} (expected gram {want_gram}, correlation {want_corr})")
    if counts != {"gram": want_gram, "correlation": want_corr}:
        fail(f"{key} launches {counts} != gram {want_gram}, correlation {want_corr}")

    work = os.path.join(run_dir, "vid_style")
    names = [f"{i + 1:05d}" for i in range(VID_FRAMES)]

    def png_hw(path):
        if not os.path.exists(path):
            fail(f"missing {path}")
        with Image.open(path) as img:
            return img.height, img.width

    for n in names:
        if png_hw(os.path.join(work, "frames", f"{n}.png")) != VID_HW:
            fail(f"frame {n}: wrong shape")
    max_flow = 0.0
    for a, b in zip(names, names[1:] + names[:1]):
        for stem in (f"forward_{a}_{b}", f"backward_{b}_{a}"):
            flo = read_flo(os.path.join(work, "flow", stem + ".flo"))
            if flo.shape != (*VID_HW, 2) or not np.isfinite(flo).all():
                fail(f"{stem}.flo: shape {flo.shape} or not finite")
            max_flow = max(max_flow, float(np.abs(flo).max()))
            if png_hw(os.path.join(work, "flow", stem + ".png")) != VID_HW:
                fail(f"{stem}.png: wrong shape")
    scale_rows = []
    per_scale = VID_FRAMES * passes
    if len(frames) != per_scale * len(sizes) or not all(f["finite"] for f in frames):
        fail(f"{len(frames)} frames optimised (expected {per_scale * len(sizes)}) or a loss log not finite")
    for si, (size, it) in enumerate(zip(sizes, per_frame)):
        hw = vid_hw(size)
        for p in range(1, passes + 1):
            for n in names:
                if png_hw(os.path.join(work, str(size), f"{p}_{n}.png")) != hw:
                    fail(f"{size}/{p}_{n}.png: wrong shape")
            recs = frames[si * per_scale + (p - 1) * VID_FRAMES : si * per_scale + p * VID_FRAMES]
            if any(tuple(r["hw"]) != hw for r in recs):
                fail(f"scale {size} pass {p}: engine shapes {[r['hw'] for r in recs]}")
            secs = sum(r["s"] for r in recs)
            row = {"size": size, "hw": list(hw), "pass": p, "mode": recs[0]["mode"], "iters_per_frame": it,
                   "stacked": bool(recs[0].get("stacked")), "pass_s": secs,
                   "s_per_frame": secs / len(recs), "ms_per_iter": secs * 1e3 / (it * len(recs)),
                   "first_total_frame1": recs[0]["first_total"], "last_total_frame1": recs[0]["last_total"]}
            scale_rows.append(row)
            print(key, json.dumps(row))
        mp4, npy = (os.path.join(work, f"vid_style_{size}.{ext}") for ext in ("mp4", "npy"))
        if not os.path.exists(mp4) and not (os.path.exists(npy) and np.load(npy).shape == (VID_FRAMES, *hw, 3)):
            fail(f"no muxed video for {size}")
    pre = prepass[0] if prepass else None
    if pre is None or pre["pairs"] != VID_FRAMES:
        fail(f"pre-pass record {prepass}")
    first = scale_rows[0]
    later = [r for r in scale_rows if not r["stacked"]]
    print(f"{key}: stacked first pass at {first['size']}: {first['pass_s']:.3f} s for {VID_FRAMES} frames "
          f"({first['s_per_frame']:.4f} s a frame); later passes: "
          + ", ".join(f"{r['size']} pass {r['pass']} {r['s_per_frame']:.4f} s a frame" for r in later))
    summary = {"wall_s": wall, "launches": counts, "first_pass_chunks": chunks, "prepass_wall_s": pre["wall_s"],
               "prepass_s_per_pair": pre["wall_s"] / pre["pairs"], "max_abs_flow": max_flow,
               "s_per_frame_all": sum(f["s"] for f in frames) / len(frames), "passes": scale_rows, "argv": argv}
    print(f"{key} summary", json.dumps({k: v for k, v in summary.items() if k not in ("passes", "argv")}))
    results[key] = summary
    return counts


def write_img_vid_inputs(d: str) -> tuple[str, str]:
    """A 1024x576 content image and a 24-frame 768x432 style video whose
    pattern moves (2, 3) px per frame, a .npy stack."""
    import numpy as np
    from PIL import Image

    h, w = IV_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    content = np.stack([
        (np.sin(xx / 37.0) * 0.5 + 0.5) * 255,
        (yy / (h - 1)) * 255,
        (((xx - 500) ** 2 + (yy - 290) ** 2) < 200 ** 2) * 200 + 30,
    ], -1)
    c_path = os.path.join(d, "content.png")
    Image.fromarray(content.astype(np.uint8)).save(c_path)
    sh, sw = IV_STYLE_HW
    sy, sx = np.mgrid[0 : sh + 80, 0 : sw + 80].astype(np.float32)
    st = np.sin(sx / 9.0) * np.cos(sy / 13.0) * 127 + 128
    canvas = np.stack([st, 255 - st, np.roll(st, 40, 0)], -1)
    frames = np.stack([canvas[2 * t : 2 * t + sh, 3 * t : 3 * t + sw] for t in range(IV_STYLE_FRAMES)])
    s_path = os.path.join(d, "stylevid.npy")
    np.save(s_path, frames.astype(np.uint8))
    return c_path, s_path


def img_vid_expected_launches() -> int:
    """K1 launches of the img_vid phase, from the code's schedule: each
    scale runs ceil(T / gfw) + 1 windows (engine/windows.py); each window
    first captures its targets from an --avg_frame_window-frame stretch of
    the style video, max(afw - gfw + 1, 1) style windows of 5 static and 5
    whole-window Grams each, then runs its iterations, 5 static Grams plus
    5 whole-window Grams each (a window holds gfw frames, as the target)."""
    import math

    total = 0
    for gfw, it in zip(IV_GFW, IV_ITERS):
        windows = math.ceil(IV_FRAMES / gfw) + 1
        total += windows * (10 * max(IV_AFW - gfw + 1, 1) + 10 * it)
    return total


def run_img_vid(results: dict) -> dict[str, int]:
    """``style.main --transfer_type img_vid`` with the defaults' window
    structure (gfw 18,9,7, afw 18, video_style_factor 100, temporal blend
    0.5, L-BFGS history 100), VGG-19 f32 --precision highest, --init random,
    cut to 24 frames, sizes 256/512/724 and 4 iterations a window."""
    import numpy as np
    import scipy.ndimage
    import torch

    from maua_style_tpu_torch import io as mio
    from maua_style_tpu_torch import losses, style
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.engine import optimize as engine_optimize
    from maua_style_tpu_torch.ops import gram as G
    from maua_style_tpu_torch.ops.resize import scale_shape
    from maua_style_tpu_torch.pipelines import img_vid as img_vid_pipeline

    run_dir = os.path.join(OUT, "img_vid")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    c_path, s_path = write_img_vid_inputs(run_dir)
    argv = [
        "--transfer_type", "img_vid", "--content", c_path, "--style", s_path, "--output_dir", run_dir,
        "--image_sizes", ",".join(map(str, IV_SIZES)), "--num_iters", ",".join(map(str, IV_ITERS)),
        "--num_frames", str(IV_FRAMES), "--gram_frame_window", ",".join(map(str, IV_GFW)),
        "--avg_frame_window", str(IV_AFW), "--video_style_factor", "100", "--temporal_blend", "0.5",
        "--optimizer", "lbfgs", "--lbfgs_num_correction", "100", "--init", "random", "--model_file", "vgg19",
        "--allow_random_weights", "--precision", "highest", "--compute_dtype", "float32", "--seed", "0", "--gpu", "0",
    ]
    scales = []
    seen = {"frames": set(), "window": set()}  # the (B, C, N) inputs K1 got
    cur = {}

    def timed_optimize(fn, self, content, styles, init, num_iters, **kw):
        cur.clear()
        cur.update(run_ms=[], capture_s=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(self, content, styles, init, num_iters, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        # the dynamic term's value at the scale's first iteration, by the
        # plain version (no kernel launch), outside the timed run
        dynamic = {}
        with torch.no_grad():
            for l, (a, t) in cur.pop("probe", {}).items():
                vg = G.gram_reference(a.reshape(1, -1, a.shape[2] * a.shape[3]))[0] / a.numel()
                dynamic[l] = float(torch.mean((vg - t) ** 2)) if t.shape == vg.shape else None
        scales.append({"hw": list(np.shape(init)[1:3]), "frames": int(np.shape(init)[0]), "iters": num_iters,
                       "gfw": kw.get("gram_frame_window"), "wall_s": wall_s, "log": self.last_loss_log,
                       "out_finite": bool(np.isfinite(out).all()), "dynamic": dynamic, **cur})
        return out

    def timed_run(fn, self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(self, *a, **kw)
        torch.cuda.synchronize()
        cur["run_ms"].append(((time.perf_counter() - t0) * 1e3, a[-1], kw.get("frozen")))
        return out

    def timed_capture(fn, self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(self, *a, **kw)
        torch.cuda.synchronize()
        cur["capture_s"] += time.perf_counter() - t0
        return out

    def dynamic_probe(fn, pastiche, acts, targets, cfg, scale=None):
        # a copy of the scale's first activations and dynamic targets, for
        # timed_optimize to read the dynamic term from
        vt = targets.get("style_video", {})
        if vt and "probe" not in cur:
            cur["probe"] = {l: (acts[l].detach().float().clone(), t) for l, t in vt.items()}
        return fn(pastiche, acts, targets, cfg, scale)

    def recording(kind, view):
        def wrapper(fn, x, use_covariance=False):
            seen[kind].add(view(x.shape))
            return fn(x, use_covariance)

        return wrapper

    host = {}  # the pipeline's host steps, seconds
    with patched((StyleEngine, "optimize", timed_optimize), (StyleEngine, "_run", timed_run),
                 (StyleEngine, "style_video_targets", timed_capture),
                 (engine_optimize, "evaluate_losses", dynamic_probe),
                 (losses, "batch_gram", recording("frames", lambda s: (s[0], s[1], s[2] * s[3]))),
                 (losses, "video_gram", recording("window", lambda s: (1, s[0] * s[1], s[2] * s[3]))),
                 *((obj, name, seconds_into(host, name)) for obj, name in (
                     (scipy.ndimage, "gaussian_filter"), (img_vid_pipeline, "match_histogram"),
                     (img_vid_pipeline, "resize_bilinear_np"), (mio, "save_tensor_to_file"),
                     (mio, "process_style_videos"), (img_vid_pipeline, "build_engine")))):
        reset_counts()
        t0 = time.perf_counter()
        style.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()

    want = img_vid_expected_launches()
    print(f"img_vid main path: {wall:.1f} s, launches {counts} (expected gram {want}, correlation 0)")
    if counts != {"gram": want, "correlation": 0}:
        fail(f"img_vid launches {counts} != gram {want}, correlation 0")
    for kind, checked in img_vid_gram_inputs().items():
        if seen[kind] != checked:
            fail(f"img_vid's {kind} Gram inputs {sorted(seen[kind])} != phase 2's {sorted(checked)}")
    if len(scales) != len(IV_SIZES):
        fail(f"{len(scales)} scales optimised, expected {len(IV_SIZES)}")

    stem = os.path.join(run_dir, "content_stylevid")
    rows = []
    for size, gfw, it, sc in zip(IV_SIZES, IV_GFW, IV_ITERS, scales):
        hw = tuple(scale_shape(IV_HW, size / max(IV_HW)))
        n_windows = -(-IV_FRAMES // gfw) + 1
        log = sc["log"]
        if tuple(sc["hw"]) != hw or sc["frames"] != IV_FRAMES or sc["gfw"] != gfw or not sc["out_finite"]:
            fail(f"scale {size}: engine saw {sc['frames']} frames of {sc['hw']} at gfw {sc['gfw']} (expected {hw}, {gfw})")
        if log is None or log.shape[0] != n_windows * it or not np.isfinite(log).all():
            fail(f"scale {size}: loss log {None if log is None else log.shape} not finite / wrong length")
        dyn = sc["dynamic"]
        if len(dyn) != 5 or not all(v is not None and np.isfinite(v) and v > 0 for v in dyn.values()):
            fail(f"scale {size}: dynamic term {dyn} not non-zero and finite at every style layer")
        for art in (f"{stem}_{size}",) + ((stem,) if size == IV_SIZES[-1] else ()):
            arr = np.load(art + ".npy") if os.path.exists(art + ".npy") else None
            if not os.path.exists(art + ".mp4") and (arr is None or arr.shape != (IV_FRAMES, *hw, 3)):
                fail(f"{art}: no .mp4 and no ({IV_FRAMES}, {hw}, 3) .npy stack ({None if arr is None else arr.shape})")
        run_s = sum(ms for ms, _, _ in sc["run_ms"]) / 1e3
        row = {"size": size, "hw": list(hw), "gfw": gfw, "windows": n_windows, "iters_per_window": it,
               "wall_s": sc["wall_s"], "capture_s": sc["capture_s"], "iterations_s": run_s,
               "ms_per_iter": run_s * 1e3 / (n_windows * it),
               "ms_per_iter_window0": sc["run_ms"][0][0] / sc["run_ms"][0][1],
               "frozen": [f for _, _, f in sc["run_ms"]], "dynamic_mse_first_iter": dyn,
               "first_total": float(log[0].sum()), "last_total": float(log[-1].sum())}
        rows.append(row)
        print("img_vid", json.dumps(row))
    summary = {"wall_s": wall, "launches": counts, "expected_gram": want,
               "optimize_s": sum(r["wall_s"] for r in rows), "capture_s": sum(r["capture_s"] for r in rows),
               "host_s": wall - sum(r["wall_s"] for r in rows), "host_steps_s": host, "scales": rows, "argv": argv}
    print("img_vid summary", json.dumps({k: v for k, v in summary.items() if k not in ("scales", "argv")}))
    results["img_vid"] = summary
    shutil.rmtree(run_dir)  # the stacks and frames, checked above
    return counts


def profile_img_vid_window(results: dict) -> None:
    """torch.profiler over 3 iterations of img_vid's first window (all gfw
    frames move, L-BFGS history 100, f32, TF32 off) at the 256 and the 724
    scale of the phase's run, after a warm-up window; the style targets
    come from the style video's first gfw frames.  Report only: the split
    of the device time between the convolutions, K1, the whole-window
    Gram's backward and the elementwise passes over its matrices."""
    import math

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.losses import LossConfig
    from maua_style_tpu_torch.models import init_params, select_model
    from maua_style_tpu_torch.ops.resize import scale_shape

    spec = select_model("vgg19")
    eng = StyleEngine(spec, init_params(spec), LossConfig(video_style_factor=100.0), device="cuda",
                      precision="highest", lbfgs_history=100)
    rng = np.random.default_rng(5)
    out = {}
    for size, gfw in ((IV_SIZES[0], IV_GFW[0]), (IV_SIZES[-1], IV_GFW[-1])):
        hw = scale_shape(IV_HW, size / max(IV_HW))
        shw = scale_shape(IV_STYLE_HW, math.sqrt(hw[0] * hw[1] / (IV_STYLE_HW[0] * IV_STYLE_HW[1])))
        content = rng.normal(0, 50, (1, *hw, 3)).astype(np.float32)
        video = rng.normal(0, 50, (gfw, *shw, 3)).astype(np.float32)
        init = rng.normal(0, 20, (gfw, *hw, 3)).astype(np.float32)
        kw = dict(transfer_type="img_vid", gram_frame_window=gfw)
        eng.optimize(content, [video], init, 2, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.optimize(content, [video], init, 3, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        summary = {"size": size, "gfw": gfw, "iters": 3, **device_profile(prof, wall_ms),
                   "what": f"one {gfw}-frame window at {hw[1]}x{hw[0]}: the target capture, then 3 L-BFGS iterations"}
        print("profile img_vid window", json.dumps(summary))
        out[str(size)] = summary
    results["profile_img_vid_window"] = out


def check_img_vid_against_cpu(results: dict) -> None:
    """A small img_vid window run (6 frames of 64x96, gfw 3, a 6-frame
    style video, Adam, 3 iterations a window) on the GPU and on the CPU,
    TF32 off: the same losses within rtol 1e-3, as phase 4's image check."""
    import numpy as np

    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.losses import LossConfig
    from maua_style_tpu_torch.models import init_params, select_model

    spec = select_model("vgg19")
    params = init_params(spec, seed=0)
    rng = np.random.default_rng(3)
    content = rng.normal(0, 50, (1, 64, 96, 3)).astype(np.float32)
    video = rng.normal(0, 50, (6, 64, 64, 3)).astype(np.float32)
    init = rng.normal(0, 20, (6, 64, 96, 3)).astype(np.float32)
    logs, outs = [], []
    for device in ("cuda", "cpu"):
        eng = StyleEngine(spec, params, LossConfig(video_style_factor=100.0), optimizer="adam", device=device,
                          precision="highest")
        outs.append(eng.optimize(content, [video], init, 3, transfer_type="img_vid", gram_frame_window=3))
        logs.append(eng.last_loss_log)
    worst = float(np.max(np.abs(logs[0] - logs[1]) / np.maximum(np.abs(logs[1]), 1e-6)))
    pix = float(np.abs(outs[0] - outs[1]).max())
    print(f"img_vid window GPU vs CPU: max rel loss diff {worst:.3e}, max |d pixel| {pix:.3e}")
    if not (np.isfinite(outs[0]).all() and worst <= 1e-3):
        fail(f"img_vid GPU and CPU runs disagree: {worst:.3e}")
    results["img_vid_vs_cpu"] = {"max_rel_loss": worst, "max_abs_pixel": pix}


def check_flow_against_cpu(results: dict, flow_models: str = "spynet,pwc") -> None:
    """A flow ensemble (the same seeded weights) on a 64x128 pair on the
    GPU, through K2, and on the CPU, through the plain version the CPU
    tests hold to the JAX package: max|Δ| / max|flow| <= 1e-3, TF32 off."""
    import argparse

    import numpy as np
    import torch

    from maua_style_tpu_torch import flow

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    ims1 = rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8)
    ims2 = np.roll(ims1, (2, 3), axis=(1, 2))
    outs = {}
    for dev in ("cuda", "cpu"):
        ns = argparse.Namespace(flow_models=flow_models, allow_random_weights=True, device=dev)
        outs[dev] = flow.get_flow_pair_model(ns).batched(ims1, ims2)
    rels = [float(np.abs(g - c).max() / np.abs(c).max()) for g, c in zip(outs["cuda"][:2], outs["cpu"][:2])]
    rel_maps = [float(np.abs(g - c).max()) for g, c in zip(outs["cuda"][2:], outs["cpu"][2:])]
    print(f"flow {flow_models} GPU vs CPU: max|d|/max|flow| fwd {rels[0]:.3e} bwd {rels[1]:.3e}; "
          f"reliability max|d| {rel_maps}")
    if not max(rels) <= 1e-3:
        fail(f"flow {flow_models} GPU vs CPU: {rels} > 1e-3")
    results.setdefault("flow_vs_cpu", {})[flow_models] = {"rel": rels, "reliability_max_abs": rel_maps}


STACK_B, STACK_ITERS = 4, 5


def check_stacked_against_per_frame(results: dict) -> None:
    """One chunk of B = 4 frames of the 1024x576 clip through the stacked
    step (``optimize_frames``) and through ``optimize_frame`` one frame at a
    time, 5 iterations, TF32 off, phase 5's engine (VGG-19 f32, seeded
    random weights, the style's histogram matching), with Adam (lr 1) from
    the content init and L-BFGS from phase 5's random init.  The
    comparison runs under ``cudnn.deterministic`` (without it two runs of
    one frame differ, ROADMAP Queue 3).  Bar, for both: every loss of
    every frame and iteration within rtol 1e-2, and mean|Δ| of the
    pastiches within 1e-2 of mean|p|.  Not max|Δ|, which is printed:
    batched and batch-1 convolutions sum in other orders, and where a
    gradient entry is float noise Adam's step is sign(g), a whole step at
    lr 1 (phase-5-sized runs on the card: 12.9 at max|p| 266 after 5
    iterations).  Then, with cuDNN's default algorithms and both shapes
    warmed up, the seconds of the stacked chunk and of the 4 frames one by
    one."""
    import numpy as np
    import torch

    from maua_style_tpu_torch import config
    from maua_style_tpu_torch import io as mio
    from maua_style_tpu_torch.ops.frame_ops import style_hist_stats
    from maua_style_tpu_torch.pipelines.common import build_engine, scale_styles

    run_dir = os.path.join(OUT, "stacked")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    v_path, s_path = write_video(run_dir, STACK_B)
    contents = np.load(v_path)
    args = config.get_args(vid_argv(v_path, s_path, run_dir))
    size = VID_SIZES[-1]
    hw, content_scale = vid_hw(size), size / max(VID_HW)
    style_big = mio.process_style_images(args)
    styles = scale_styles(style_big, (1, *hw), args.style_scale)
    kw = dict(out_hw=hw, content_scale=content_scale, blend_weights=args.style_blend_weights,
              hist_stats=style_hist_stats(style_big[0], rng=np.random.default_rng(0)))
    seeds = list(range(STACK_B))
    rows = {}
    for optimizer, init in (("adam", "content"), ("lbfgs", "random")):
        args.optimizer = optimizer
        engine = build_engine(args, size)

        def stacked(iters):
            out, _ = engine.optimize_frames(contents, styles, iters, init_mode=init, seeds=seeds, **kw)
            return out, engine.last_loss_log.cpu().numpy()

        def one_by_one(iters):
            outs, logs = [], []
            for i in seeds:
                out, _ = engine.optimize_frame(contents[i], styles, iters, init_mode=init, seed=i, **kw)
                outs.append(out)
                logs.append(engine.last_loss_log.cpu().numpy())
            return torch.stack(outs), np.stack(logs)

        torch.backends.cudnn.deterministic = True
        try:
            (p_s, log_s), (p_f, log_f) = stacked(STACK_ITERS), one_by_one(STACK_ITERS)
        finally:
            torch.backends.cudnn.deterministic = False
        d = (p_s - p_f).abs()
        row = {"init": init, "max_abs_pastiche": float(d.max()), "max_abs_p": float(p_f.abs().max()),
               "mean_abs_rel_pastiche": float(d.mean() / p_f.abs().mean()),
               "log_rtol": float(np.max(np.abs(log_s - log_f) / np.maximum(np.abs(log_f), 1e-30)))}
        secs = {}
        for name, fn in (("stacked_s", stacked), ("per_frame_s", one_by_one)):
            fn(1)  # warm-up: cuDNN's algorithms for these shapes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(STACK_ITERS)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        rows[optimizer] = {**row, **secs}
        print(f"stacked vs per-frame, {optimizer} from {init}, B = {STACK_B}, {hw[0]}x{hw[1]}, {STACK_ITERS} iterations:",
              json.dumps(rows[optimizer]))
        del engine, p_s, p_f
    shutil.rmtree(run_dir)
    results["stacked_vs_per_frame"] = rows
    for optimizer, row in rows.items():
        if not (row["log_rtol"] <= 1e-2 and row["mean_abs_rel_pastiche"] <= 1e-2):
            fail(f"stacked vs per-frame ({optimizer}): {row} past 1e-2")


TUNER_SIZES = (512, 1024, 2048)


def run_tuner(results: dict) -> None:
    """The capacity tuner on the card: VGG-19's measured peaks (L-BFGS
    compact and two-loop, Adam; f32 and bf16) and prune's (Adam, f32) at
    512², 1024² and 2048², each beside ``estimate_step_bytes`` with the
    module's constants and its relative error, and the constants
    ``fit_constants`` fits to these peaks with their own error; then
    ``probe_max_sizes`` for VGG-19 (L-BFGS and Adam, f32, the card's whole
    memory as the budget), written to OUT, with its probes and seconds;
    ``hbm_bytes()`` and the frame sizing at 1024x576 and 512x288.  Fails if
    ``torch.cuda.memory_allocated()`` does not come back to its start (read
    after a warm-up probe: a process's first cuBLAS call keeps its
    workspace, 64 MiB on the card, for the process's life)."""
    import torch

    from maua_style_tpu_torch.tuning import max_sizes as ms

    ms.measure_step_bytes("vgg19", "adam", 64)  # warm-up: the process's cuBLAS and cuDNN workspaces
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    cases = [("vgg19", opt, method, dtype) for dtype in ("float32", "bfloat16")
             for opt, method in (("lbfgs", "compact"), ("lbfgs", "two_loop"), ("adam", "compact"))]
    rows = []
    for model, opt, method, dtype in [*cases, ("prune", "adam", "compact", "float32")]:
        for size in TUNER_SIZES:
            t0 = time.perf_counter()
            got = ms.measure_step_bytes(model, opt, size, compute_dtype=dtype, lbfgs_method=method)
            if got is None:
                fail(f"tuner: {model} {opt} {dtype} at {size}² ran out of memory")
            est = ms.estimate_step_bytes(model, opt, size, lbfgs_method=method, compute_dtype=dtype)
            row = {"model": model, "optimizer": opt, "method": method, "dtype": dtype, "size": size, "measured": got,
                   "estimate": est, "rel_err": (est - got) / got, "s": time.perf_counter() - t0}
            rows.append(row)
            print("tuner peak", json.dumps(row))
    fitted = ms.fit_constants([(r["model"], r["optimizer"], r["method"], r["dtype"], r["size"], r["measured"])
                               for r in rows])
    table_constants = ms.CONSTANTS
    ms.CONSTANTS = fitted
    try:
        fit_err = [(ms.estimate_step_bytes(r["model"], r["optimizer"], r["size"], lbfgs_method=r["method"],
                                           compute_dtype=r["dtype"]) - r["measured"]) / r["measured"] for r in rows]
    finally:
        ms.CONSTANTS = table_constants
    err = {"table_max_abs_rel_err": max(abs(r["rel_err"]) for r in rows),
           "fitted_max_abs_rel_err": max(abs(e) for e in fit_err)}
    print("tuner constants: table", json.dumps(table_constants), "fitted here", json.dumps(fitted), json.dumps(err))

    probes = []

    def counted(fn, *a, **kw):
        probes.append(a[2])
        return fn(*a, **kw)

    t0 = time.perf_counter()
    with patched((ms, "measure_step_bytes", counted)):
        table = ms.probe_max_sizes(models=("vgg19",), optimizers=("lbfgs", "adam"), method="analysis",
                                   compute_dtype="float32")
    search = {"table": table, "probes": probes, "s": time.perf_counter() - t0}
    with open(os.path.join(OUT, "max-sizes-vgg19-float32.json"), "w") as f:
        json.dump(table, f, indent=2)
    print("tuner search", json.dumps(search))
    hbm = ms.hbm_bytes()
    sizing = {f"{h}x{w} {opt}": {"frames_per_program": ms.frames_per_program("vgg19", opt, (h, w), hbm=hbm),
                                 "chain_frames_per_program": ms.chain_frames_per_program("vgg19", opt, (h, w), hbm=hbm)}
              for h, w in ((576, 1024), (288, 512)) for opt in ("lbfgs", "adam")}
    print(f"tuner hbm_bytes() {hbm}, sizing (f32)", json.dumps(sizing))
    torch.cuda.synchronize()
    end = torch.cuda.memory_allocated()
    results["tuner"] = {"peaks": rows, "constants": table_constants, "fitted": fitted, **err, "search": search,
                        "hbm_bytes": hbm, "sizing": sizing, "allocated_start": start, "allocated_end": end}
    if end != start:
        fail(f"tuner: memory_allocated {end} after the probes, {start} before")


def profile_vid_frame(results: dict) -> None:
    """torch.profiler over one later-pass frame at 1024x576 (blend init,
    warped temporal target, 10 L-BFGS iterations), after a warm-up frame,
    with the main path's artifacts as inputs.  Report only."""
    import numpy as np
    import torch
    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from maua_style_tpu_torch import config
    from maua_style_tpu_torch import io as mio
    from maua_style_tpu_torch.io.flo import read_flo
    from maua_style_tpu_torch.ops.frame_ops import style_hist_stats
    from maua_style_tpu_torch.ops.resize import resize_bilinear_np, scale_shape
    from maua_style_tpu_torch.pipelines.common import build_engine, scale_styles

    run_dir = os.path.join(OUT, "vid_img")
    work = os.path.join(run_dir, "vid_style")
    args = config.get_args(vid_argv(os.path.join(run_dir, "vid.npy"), os.path.join(run_dir, "style.png"), run_dir))
    size = VID_SIZES[-1]
    content_scale = size / max(VID_HW)
    hw = tuple(scale_shape(VID_HW, content_scale))
    engine = build_engine(args, size)
    style_big = mio.process_style_images(args)
    styles = scale_styles(style_big, (1, *hw), args.style_scale)
    with Image.open(os.path.join(work, "flow", "forward_00001_00002.png")) as img:
        weights = np.asarray(img.convert("L"))
    kw = dict(out_hw=hw, content_scale=content_scale, blend_weights=args.style_blend_weights, init_mode="blend",
              prev=resize_bilinear_np(mio.preprocess(os.path.join(work, str(size), "1_00001.png")), size=hw),
              blend=mio.load_u8(os.path.join(work, str(size), "1_00002.png")), temporal_blend=0.5,
              flow=read_flo(os.path.join(work, "flow", "forward_00001_00002.flo")), weights_u8=weights,
              use_temporal=True, hist_stats=style_hist_stats(style_big[0], rng=np.random.default_rng(0)))
    u8 = mio.load_u8(os.path.join(work, "frames", "00002.png"))
    iters = VID_ITERS[-1] // VID_PASSES
    engine.optimize_frame(u8, styles, iters, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.optimize_frame(u8, styles, iters, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    summary = {"iters": iters, **device_profile(prof, wall_ms),
               "what": "one pass-2 style frame at 1024x576: blend init, warped temporal target, L-BFGS history 100, f32, TF32 off"}
    print("profile vid_img frame", json.dumps(summary))
    results["profile_vid_frame"] = summary


FLAG_SIZE, FLAG_ITERS = 512, 6
DET_SIDE = 1024


def drive_flags(results: dict) -> None:
    """Paths no earlier phase drives, once each, briefly (report only; a
    failure still fails the run): img_img at 512² with --compute_dtype
    bfloat16, --precision high, --optimizer adam and --original_colors,
    FLAG_ITERS iterations; and vid_img on a 3-frame 256x144 clip with
    --init prev_warp --original_colors (the host frame path), 2 passes.
    Checks the artifacts, finite loss logs and both kernels' launches."""
    import numpy as np
    import torch
    from PIL import Image

    from maua_style_tpu_torch import style
    from maua_style_tpu_torch.engine import StyleEngine

    run_dir = os.path.join(OUT, "flags")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    c_path, s_path = write_inputs(run_dir)
    base = ["--content", c_path, "--style", s_path, "--image_sizes", str(FLAG_SIZE), "--num_iters", str(FLAG_ITERS),
            "--model_file", "vgg19", "--allow_random_weights", "--seed", "0", "--gpu", "0"]
    logs = []
    orig_optimize, orig_frame = StyleEngine.optimize, StyleEngine.optimize_frame

    def logged(self, *a, **kw):
        out = orig_optimize(self, *a, **kw)
        logs.append(self.last_loss_log)
        return out

    rows = []
    StyleEngine.optimize = logged
    try:
        for flag in (["--compute_dtype", "bfloat16"], ["--precision", "high"], ["--optimizer", "adam"],
                     ["--original_colors"]):
            out_dir = os.path.join(run_dir, flag[-1].lstrip("-"))
            logs.clear()
            reset_counts()
            t0 = time.perf_counter()
            style.main(base + ["--output_dir", out_dir] + flag)
            wall = time.perf_counter() - t0
            counts = read_counts()
            png = os.path.join(out_dir, f"content_style_{FLAG_SIZE}.png")
            want = {"gram": STYLE_LAYERS * (FLAG_ITERS + 1), "correlation": 0}
            finite = len(logs) == 1 and logs[0].shape[0] == FLAG_ITERS and bool(np.isfinite(logs[0]).all())
            with Image.open(png) as img:
                img_ok = img.size == (FLAG_SIZE, FLAG_SIZE)
            row = {"flags": flag, "wall_s": wall, "launches": counts, "expected": want, "finite": finite,
                   "first_total": float(logs[0][0].sum()), "last_total": float(logs[0][-1].sum())}
            rows.append(row)
            print("flag", json.dumps(row))
            if counts != want or not finite or not img_ok:
                fail(f"img_img {flag}: launches {counts} (expected {want}), finite log {finite}, png {img_ok}")

        # vid_img: --init prev_warp through the host frame path
        frames_dir = os.path.join(run_dir, "clip")
        os.makedirs(frames_dir)
        yy, xx = np.mgrid[0:144 + 16, 0:256 + 16].astype(np.float32)
        canvas = np.stack([(np.sin(xx / 11.0) * 0.5 + 0.5) * 255, (np.cos(yy / 7.0) * 0.5 + 0.5) * 255,
                           ((xx - 120) ** 2 + (yy - 70) ** 2 < 40 ** 2) * 200 + 30], -1)
        clip = np.stack([canvas[2 * t : 2 * t + 144, 3 * t : 3 * t + 256] for t in range(3)]).astype(np.uint8)
        np.save(os.path.join(frames_dir, "clip.npy"), clip)
        frame_logs = []

        def frame_logged(self, *a, **kw):
            out = orig_frame(self, *a, **kw)
            frame_logs.append(self.last_loss_log.cpu().numpy())
            return out

        StyleEngine.optimize_frame = frame_logged
        logs.clear()
        reset_counts()
        t0 = time.perf_counter()
        style.main(["--transfer_type", "vid_img", "--content", os.path.join(frames_dir, "clip.npy"), "--style", s_path,
                    "--output_dir", os.path.join(run_dir, "vid"), "--flow_models", "spynet,pwc", "--image_sizes", "256",
                    "--num_iters", "8", "--passes_per_scale", "2", "--init", "prev_warp", "--original_colors",
                    "--model_file", "vgg19", "--allow_random_weights", "--seed", "0", "--gpu", "0"])
        wall = time.perf_counter() - t0
        counts = read_counts()
        all_logs = logs + frame_logs
        want = {"gram": STYLE_LAYERS + STYLE_LAYERS * 3 * 2 * 4, "correlation": 5 * 2}
        finite = len(all_logs) == 6 and all(np.isfinite(l).all() for l in all_logs)
        pngs = sorted(os.listdir(os.path.join(run_dir, "vid", "clip_style", "256")))
        row = {"flags": ["--transfer_type", "vid_img", "--init", "prev_warp", "--original_colors"], "wall_s": wall,
               "launches": counts, "expected": want, "finite": finite, "frames_optimised": len(all_logs),
               "pngs": len(pngs), "host_path": len(logs), "device_path": len(frame_logs)}
        rows.append(row)
        print("flag", json.dumps(row))
        if counts != want or not finite or len(pngs) != 6:
            fail(f"vid_img prev_warp/original_colors: launches {counts} (expected {want}), finite {finite}, {len(pngs)} PNGs")
    finally:
        StyleEngine.optimize, StyleEngine.optimize_frame = orig_optimize, orig_frame
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    results["flags"] = rows
    shutil.rmtree(run_dir)


def check_determinism(results: dict) -> None:
    """The 1024² img_img step twice from one seed, with cuDNN's default
    algorithms and with ``torch.backends.cudnn.deterministic``: every
    activation of the forward, the Grams and losses, the gradient at each
    activation (in backward order) and at the pastiche, and the pastiche
    after 5 L-BFGS iterations.  Report only: prints the first tensor of
    that order that differs between the two runs."""
    import numpy as np
    import torch

    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.engine.optimize import to_nchw
    from maua_style_tpu_torch.losses import LossConfig, evaluate_losses
    from maua_style_tpu_torch.models import init_params, select_model
    from maua_style_tpu_torch.ops.gram import batch_gram

    spec = select_model("vgg19")
    params = init_params(spec, seed=0)
    rng = np.random.default_rng(4)
    content = rng.normal(0, 50, (1, DET_SIDE, DET_SIDE, 3)).astype(np.float32)
    style_img = rng.normal(0, 50, (1, DET_SIDE, DET_SIDE, 3)).astype(np.float32)
    init = rng.normal(0, 1, (1, DET_SIDE, DET_SIDE, 3)).astype(np.float32)

    def trace() -> list[tuple[str, "torch.Tensor"]]:
        eng = StyleEngine(spec, params, LossConfig(), device="cuda", precision="highest", lbfgs_history=100)
        cfg = eng.loss_cfg
        names = [l.name for l in eng.spec.layers if l.kind == "relu"]
        targets = {"content": eng.content_targets(content), "style": eng.style_targets([style_img], [1.0])}
        p = to_nchw(init, eng.device).requires_grad_(True)
        acts = eng.extractor(p, names)
        total, per = evaluate_losses(p, acts, targets, cfg, {})
        grads = torch.autograd.grad(total, [acts[n] for n in reversed(names)] + [p])
        out = [(f"act {n}", acts[n].detach()) for n in names]
        out += [(f"gram {l}", batch_gram(acts[l].detach())) for l in cfg.style_layers]
        out += [("losses", per.detach())]
        out += [(f"grad {n}", g) for n, g in zip(list(reversed(names)) + ["pastiche"], grads)]
        opt = eng._make_optimizer()
        p5, _, _ = eng._run(p.detach(), opt, opt.init(p.detach()), targets, {}, 5)
        out.append(("pastiche after 5 iterations", p5))
        return [(n, t.detach().cpu()) for n, t in out]

    report = {}
    try:
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            a, b = trace(), trace()
            differ = [(n, float((x.double() - y.double()).abs().max()), float(y.abs().max()))
                      for (n, x), (_, y) in zip(a, b) if not torch.equal(x, y)]
            key = "deterministic" if det else "default"
            report[key] = {"tensors": len(a), "differ": len(differ), "first": differ[0] if differ else None,
                           "pastiche_max_abs_diff": float((a[-1][1] - b[-1][1]).abs().max())}
            print(f"determinism ({key} cuDNN): {len(differ)} of {len(a)} tensors differ between two runs; "
                  f"first: {differ[0] if differ else None}")
    finally:
        torch.backends.cudnn.deterministic = False
    results["determinism_1024"] = report


NCA_STEPS, NCA_SAVE, NCA_FRAMES = 40, 5, 90


def run_nca(results: dict) -> tuple[dict[str, int], dict[str, int]]:
    """The neural-CA trainer at the JAX defaults (12 channels, hidden 96,
    a pool of 1024 states of 128², batch 4, 32-96 CA steps, VGG-16 with
    its five style layers, seeded random weights, f32) for NCA_STEPS steps,
    a checkpoint every NCA_SAVE; then generation from the last checkpoint:
    NCA_FRAMES frames of each of the three videos.  Checks finite losses,
    a learned w2, the artifacts, K1's input shapes against phase 2's and
    its launches (5 for the style target + 5 a step); prints ms per train
    step, peak memory and seconds per generated frame."""
    import numpy as np
    import torch

    from maua_style_tpu_torch.models import nca
    from maua_style_tpu_torch.pipelines import nca_gen, nca_train

    run_dir = os.path.join(OUT, "nca")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    _, s_path = write_inputs(run_dir)  # the 768² style; its 128² thumbnail is the target
    step_ms, rollouts, pools, seen = [], [], [], set()

    def timed_step(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def counted_rollout(fn, params, x, draws, n_steps, *a, **kw):
        rollouts.append(n_steps)
        return fn(params, x, draws, n_steps, *a, **kw)

    def recorded_pool(fn, *a, **kw):
        pool = fn(*a, **kw)
        pools.append({"shape": list(pool.shape), "bytes": pool.numel() * pool.element_size(), "device": str(pool.device)})
        return pool

    gram_fn = nca_train._GramFn

    class RecordingGram:
        @staticmethod
        def apply(f):
            seen.add(tuple(f.shape))
            return gram_fn.apply(f)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    nca_train._GramFn = RecordingGram
    try:
        with patched((nca_train, "train_step", timed_step), (nca, "rollout", counted_rollout),
                     (nca, "seed_state", recorded_pool)):
            reset_counts()
            t0 = time.perf_counter()
            params, log = nca_train.train(s_path, run_dir, n_steps=NCA_STEPS, save_every=NCA_SAVE, log_every=10,
                                          allow_random_weights=True, seed=0, device="cuda:0")
            train_wall = time.perf_counter() - t0
            train_counts = read_counts()
    finally:
        nca_train._GramFn = gram_fn
    peak = torch.cuda.max_memory_allocated() - base
    want = {"gram": 5 + 5 * NCA_STEPS, "correlation": 0}
    print(f"nca_train: {train_wall:.1f} s, launches {train_counts} (expected {want}), pool {pools}")
    if train_counts != want:
        fail(f"nca_train launches {train_counts} != {want}")
    if seen != set(nca_gram_shapes()):
        fail(f"nca_train's Gram inputs {sorted(seen)} != phase 2's {sorted(nca_gram_shapes())}")
    if len(log) != NCA_STEPS or not np.isfinite(log).all():
        fail(f"nca_train: {len(log)} losses, finite {bool(np.isfinite(log).all())}")
    if not bool(torch.any(params["w2"] != 0)) or params["w2"].device.type != "cuda":
        fail("nca_train: w2 still zero or not on the card")
    if pools != [{"shape": [1024, 12, NCA_GRID, NCA_GRID], "bytes": 1024 * 12 * NCA_GRID**2 * 4, "device": "cuda:0"}]:
        fail(f"nca_train: pool {pools}")
    for n in range(NCA_SAVE, NCA_STEPS + 1, NCA_SAVE):
        for ext in ("npz", "png"):
            if not os.path.exists(os.path.join(run_dir, f"style_{n}.{ext}")):
                fail(f"nca_train: missing style_{n}.{ext}")
    if len(rollouts) != NCA_STEPS or not all(32 <= n < 96 for n in rollouts):
        fail(f"nca_train: rollout lengths {rollouts}")
    train = {"wall_s": train_wall, "launches": train_counts, "steps": NCA_STEPS,
             "ms_per_step_median": statistics.median(step_ms), "ms_per_step_first": step_ms[0],
             "ms_per_ca_step": sum(step_ms[1:]) / sum(rollouts[1:]), "rollout_mean": statistics.mean(rollouts),
             "peak_bytes": peak, "pool": pools[0], "first_loss": log[0], "last_loss": log[-1],
             "loss_min": min(log), "loss_max": max(log)}
    print("nca_train", json.dumps(train))

    gen_s = {}
    ckpt = os.path.join(run_dir, f"style_{NCA_STEPS}.npz")
    with patched(*((nca_gen, f, seconds_into(gen_s, f)) for f in ("evolution_video", "checkpoint_grid_video",
                                                                    "text_video"))):
        reset_counts()
        t0 = time.perf_counter()
        nca_gen.main([s_path, run_dir, "--num_frames", str(NCA_FRAMES), "--checkpoint", ckpt, "--text", "NCA"])
        gen_wall = time.perf_counter() - t0
        gen_counts = read_counts()
    tag = str(NCA_STEPS)
    for stem, hw in ((f"style_{tag}", (512, 512)), ("style_checkgrid", (1024, 2 * (4 * 128 + 2))),
                     (f"style-{tag}-wav", None)):
        art = os.path.join(run_dir, stem)
        arr = np.load(art + ".npy", mmap_mode="r") if os.path.exists(art + ".npy") else None
        ok = os.path.exists(art + ".mp4") or (arr is not None and arr.shape[0] == NCA_FRAMES
                                              and (hw is None or tuple(arr.shape[1:3]) == hw))
        if not ok:
            fail(f"nca_gen: no {stem}.mp4 and no {NCA_FRAMES}-frame .npy ({None if arr is None else arr.shape})")
    if gen_counts != {"gram": 0, "correlation": 0} or len(gen_s) != 3:
        fail(f"nca_gen: launches {gen_counts}, videos timed {sorted(gen_s)}")
    gen = {"wall_s": gen_wall, "launches": gen_counts, "frames": NCA_FRAMES,
           "s_per_frame": {k: v / NCA_FRAMES for k, v in gen_s.items()}}
    print("nca_gen", json.dumps(gen))
    results["nca"] = {"train": train, "gen": gen}
    shutil.rmtree(run_dir)  # hundreds of MB of frames, checked above
    return train_counts, gen_counts


class FixedDraws:
    """One training step's draws, made once from a CPU generator and handed
    out on ``device``: two runs on two devices see the same numbers."""

    def __init__(self, seed: int, pool_size: int, batch_size: int, n_steps: int, hw: tuple[int, int], device):
        import torch

        g = torch.Generator().manual_seed(seed)
        self.idx = torch.randperm(pool_size, generator=g)[:batch_size]
        self.n = n_steps
        self.masks = [torch.rand((batch_size, 1, *hw), generator=g) for _ in range(n_steps)]
        self.device = device

    def batch(self, pool_size, batch_size):
        return self.idx.to(self.device)

    def steps(self, low, high):
        return self.n

    def uniform(self, shape):
        return self.masks.pop(0).to(self.device)


def check_nca_against_cpu(results: dict) -> None:
    """One NCA training step at the defaults' widths (128², batch 4, VGG-16's
    five layers, 32 CA steps, a small random w2, a pool of 8 random states)
    on the GPU and on the CPU, from the same draws, TF32 off: losses within
    rtol 1e-3."""
    import torch

    from maua_style_tpu_torch.models import nca
    from maua_style_tpu_torch.pipelines import nca_train

    g = torch.Generator().manual_seed(5)
    style = torch.rand((1, 3, NCA_GRID, NCA_GRID), generator=g)
    pool0 = torch.rand((8, 12, NCA_GRID, NCA_GRID), generator=g) * 0.1
    w2 = torch.randn((12, 96, 1, 1), generator=g) * 0.01
    losses, updated = {}, {}
    for dev in ("cuda", "cpu"):
        calc = nca_train._build_style_fn("vgg16", True, dev)
        with torch.no_grad():
            target = [t[0] for t in calc(style.to(dev))]
        params = {**nca.init_ca_params(seed=0, device=dev), "w2": w2.to(dev)}
        adam = nca_train.Adam(1.0)
        opt_state = {k: adam.init(v) for k, v in params.items()}
        draws = FixedDraws(6, 8, NCA_BATCH, 32, (NCA_GRID, NCA_GRID), dev)
        p, loss, _ = nca_train.train_step(params, adam, opt_state, pool0.to(dev), draws, 1, calc, target,
                                          batch_size=NCA_BATCH, min_rollout=32, max_rollout=96)
        losses[dev], updated[dev] = float(loss), {k: v.cpu() for k, v in p.items()}
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    dw = {k: float((updated["cuda"][k] - updated["cpu"][k]).abs().max()) for k in updated["cpu"]}
    print(f"nca train step GPU vs CPU: losses {losses}, rel {rel:.3e}; max |d param| {dw}")
    if not rel <= 1e-3:
        fail(f"nca train step GPU vs CPU: loss rel {rel:.3e} > 1e-3")
    results["nca_vs_cpu"] = {"losses": losses, "rel": rel, "max_abs_param": dw}


CV_ITERS, CV_PROFILE_ITERS = 100, 5  # the CLI saves every 50
CV_TEXT = "an oil painting of a lighthouse at dusk"


class _Tee:
    """A stdout that also keeps what it is sent."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_clip_vqgan(results: dict, key: str = "clip_vqgan", backbone: str = "ViT-B/32", iters: int = CV_ITERS):
    """CLIP-guided VQGAN synthesis through ``pipelines.clip_vqgan.main`` at
    the JAX defaults: ViT-B/32 (width 768, 12 + 12 layers, 224 input; or
    ``backbone``), imagenet_16384 (ch 128, ch_mult 1,1,2,2,4, 16384 codes
    of 256), the main path's content and style images fitted to 256² and a
    style text, 64 cutouts, Adam 0.05, seeded random weights, f32 with
    TF32 off, iterations cut from 500 to ``iters`` with a save every 50.
    Checks the artifact, the log lines, a finite (iters, 4) loss log and no
    K1/K2 launch; prints ms per iteration (CUDA events at each iteration's
    start, the median after the first), the CLI's wall seconds, the engine's
    set-up, the seconds from optimize's start to its first iteration (the
    targets' embeddings and z's encoding) and the peak memory.  Returns
    (launch counts, the run's engine)."""
    import numpy as np
    import torch
    from PIL import Image

    from maua_style_tpu_torch.pipelines import clip_vqgan as cv

    run_dir = os.path.join(OUT, key)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    c_path, s_path = write_inputs(run_dir)  # fitted to 256² by the CLI (--image_size 256)
    events, engines, spans = [], [], {}

    def timed_step(fn, *a, **kw):
        if not events:  # the first iteration ends optimize's prologue
            torch.cuda.synchronize()
            spans["prologue_s"] = time.perf_counter() - spans["t0"]
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return fn(*a, **kw)

    def recorded_optimize(fn, self, *a, **kw):
        engines.append(self)
        torch.cuda.synchronize()
        spans["t0"] = time.perf_counter()
        return fn(self, *a, **kw)

    argv = ["--content", c_path, "--style", s_path, "--style_text", CV_TEXT, "--iterations", str(iters),
            "--clip_backbone", backbone, "--out_dir", run_dir, "--seed", "0", "--allow_random_weights"]
    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with patched((cv.ClipVQGANEngine, "step", timed_step), (cv.ClipVQGANEngine, "optimize", recorded_optimize),
                 (cv.ClipVQGANEngine, "__init__", seconds_into(spans, "engine_init_s"))), \
            contextlib.redirect_stdout(tee):
        reset_counts()
        t0 = time.perf_counter()
        cv.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    engine = engines[0]
    log = engine.last_loss_log
    name = "-".join(["content", "style", *CV_TEXT.split(), "imagenet_16384"]).lower() + ".jpg"
    printed = [ln for ln in "".join(tee.parts).splitlines() if ln.startswith(("i: ", "saved "))]
    with Image.open(os.path.join(run_dir, name)) as img:
        size = img.size
    print(f"{key}: {wall:.1f} s, launches {counts}, log {log.shape}, printed {printed}")
    if counts != {"gram": 0, "correlation": 0}:
        fail(f"{key} launched K1/K2: {counts}")
    if log.shape != (iters, 4) or not np.isfinite(log).all() or log[:, 2].any():
        fail(f"{key}: loss log {log.shape}, finite {bool(np.isfinite(log).all())}, from term {log[:, 2].any()}")
    if size != (256, 256) or len(events) != iters or engine.device.type != "cuda":
        fail(f"{key}: image {size}, {len(events)} iterations timed, device {engine.device}")
    if type(engine.clip).__name__ != ("CLIP" if backbone == "ViT-B/32" else "CLIPResNet"):
        fail(f"{key}: the engine holds a {type(engine.clip).__name__} for {backbone}")
    if [ln.split(",")[0] for ln in printed] != [f"i: {iters}", f"i: {iters}", f"saved {run_dir}/{name}"]:
        fail(f"{key}: printed lines {printed}")
    gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    summary = {"backbone": backbone, "wall_s": wall, "launches": counts, "iterations": iters,
               "ms_per_iter_median": statistics.median(gaps[1:]),
               "ms_first_iter": gaps[0], "ms_per_iter_max": max(gaps[1:]),
               "engine_init_s": spans["engine_init_s"], "prologue_s": spans["prologue_s"], "peak_bytes": peak,
               "first_terms": log[0].tolist(), "last_terms": log[-1].tolist(), "what": "ms between iteration starts "
               "(CUDA events), median of iterations 2..; prologue = content/style/text embeddings + z encode"}
    print(key, json.dumps(summary))
    results[key] = summary
    shutil.rmtree(run_dir)
    return counts, engine


def profile_clip_vqgan(results: dict, engine, key: str = "profile_clip_vqgan") -> None:
    """torch.profiler over CV_PROFILE_ITERS iterations of the main path's
    engine (warm), from a 256² image's z with a style image and the style
    text, after two warm-up iterations: device busy share, top kernels and
    operators, launches per iteration, and the device time under the
    forward's layers (VQGAN synth, cutouts, CLIP image tower; the
    remainder of a step is backward and Adam); the CLIP image tower alone
    on 64 normalised cutouts, its forward and its input gradient (CUDA
    events, median of 10 after 3); then ms per iteration (median of 20
    after 3 warm-up steps) with ``torch.backends.cudnn.benchmark`` off,
    on, on, off.  Report only."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from maua_style_tpu_torch.engine.lbfgs import Adam
    from maua_style_tpu_torch.pipelines import clip_vqgan as cv

    def labelled(label):
        def wrapper(fn, *a, **kw):
            with record_function(label):
                return fn(*a, **kw)

        return wrapper

    g = torch.Generator().manual_seed(3)
    img, style = (torch.rand((1, 3, 256, 256), generator=g).cuda() for _ in range(2))
    with torch.no_grad():
        targets = (engine.embed_cutouts(img), None, engine.embed_text(CV_TEXT), [engine.embed_cutouts(style)])
    z = engine.encode_z(img)
    adam = Adam(engine.learning_rate)
    state = adam.init(z)
    for _ in range(2):
        z, state, _ = engine.step(z, adam, state, None, targets, (1.0, 1.0, 1.0))
    torch.cuda.synchronize()
    with patched((engine, "loss_terms", labelled("clip_vqgan.forward")), (engine, "synth", labelled("clip_vqgan.synth")),
                 (cv, "make_cutouts", labelled("clip_vqgan.cutouts")),
                 (engine.clip, "encode_image", labelled("clip_vqgan.clip_image"))), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CV_PROFILE_ITERS):
            z, state, terms = engine.step(z, adam, state, None, targets, (1.0, 1.0, 1.0))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    avgs = prof.key_averages()
    # device time of the kernels each labelled range's operators launched (the CPU-side events; the backward's
    # run on autograd's device thread, outside the ranges: they are the step's remainder)
    layers = {e.key: e.device_time_total / 1e3 / CV_PROFILE_ITERS for e in avgs
              if e.key.startswith("clip_vqgan.") and e.device_type != cuda}
    with torch.no_grad():
        cuts = (cv.make_cutouts(img, engine.cut_size, engine.cutn, engine.draws) - engine.mean) / engine.std
    cuts.requires_grad_(True)
    cot = torch.randn((engine.cutn, engine.clip.cfg.embed_dim), device=cuts.device, generator=torch.Generator(
        device=cuts.device).manual_seed(4))

    def tower_forward():
        with torch.no_grad():
            engine.clip.encode_image(cuts)

    def tower_backward():
        out = engine.clip.encode_image(cuts)
        torch.autograd.grad((out * cot).sum(), cuts)

    tower = {"forward_ms": time_ms(tower_forward, reps=10), "forward_backward_ms": time_ms(tower_backward, reps=10)}
    tower["backward_ms"] = tower["forward_backward_ms"] - tower["forward_ms"]
    del cuts, cot
    bench_ms, saved = {}, torch.backends.cudnn.benchmark
    try:
        for bench in (False, True, True, False):  # in turns: cuDNN's heuristics against its autotuner
            torch.backends.cudnn.benchmark = bench
            for _ in range(3):
                z, state, _ = engine.step(z, adam, state, None, targets, (1.0, 1.0, 1.0))
            events = [torch.cuda.Event(enable_timing=True) for _ in range(21)]
            for ev in events[:-1]:
                ev.record()
                z, state, _ = engine.step(z, adam, state, None, targets, (1.0, 1.0, 1.0))
            events[-1].record()
            torch.cuda.synchronize()
            gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            bench_ms.setdefault(f"benchmark={bench}", []).append(statistics.median(gaps))
    finally:
        torch.backends.cudnn.benchmark = saved
    summary = {"iters": CV_PROFILE_ITERS, **device_profile(prof, wall_ms),
               "launches_per_iter": sum(e.count for e in avgs if e.device_type == cuda) / CV_PROFILE_ITERS,
               "layer_device_ms_per_iter": layers, "clip_tower_ms": tower, "cudnn_benchmark_ms_per_iter": bench_ms,
               "what": f"5 iterations at 256² ({type(engine.clip).__name__} {engine.cut_size}², imagenet_16384, "
                       "64 cutouts), f32, TF32 off"}
    print(key, json.dumps(summary))
    results[key] = summary


class _ListDraws:
    """Cutout draws handed out in order from a list: two engines on two
    devices see the same phases and offsets."""

    def __init__(self, items):
        self.items = list(items)

    def cutouts(self, cutn, phases):
        return self.items.pop(0)


def check_clip_vqgan_against_cpu(results: dict, backbone: str = "ViT-B/32", key: str = "clip_vqgan_vs_cpu") -> None:
    """The full-width models (ViT-B/32 or ``backbone``) on the GPU and on
    the CPU from the same seeded weights and cutout draws, TF32 off: CLIP
    image embeddings of 8 images and text embeddings of 3 texts, and a
    decode from fixed indices, each within max|Δ| / max|·| <= 1e-4; one
    iteration's loss terms within rtol 1e-3 with z fixed to codes (the
    CPU's indices of an encoded 256² image, so both devices quantize
    alike); and the share of that encode's quantize indices on which the
    devices agree (printed: with 16384 random codes, near-ties can pick
    another code)."""
    import numpy as np
    import torch

    from maua_style_tpu_torch.engine.lbfgs import Adam
    from maua_style_tpu_torch.models.clip import tokenize
    from maua_style_tpu_torch.pipelines import clip_vqgan as cv

    os.environ["MAUA_ALLOW_RANDOM_WEIGHTS"] = "1"  # seeded random weights, as the main path's --allow_random_weights
    g = torch.Generator().manual_seed(7)
    img, style = (torch.rand((1, 3, 256, 256), generator=g) for _ in range(2))
    toks = tokenize(["a lighthouse", CV_TEXT, "noise, static and snow"])
    codes = torch.randint(0, 16384, (1, 16, 16), generator=g)
    src = cv.CutoutDraws(11)
    draws = [src.cutouts(64, 4) for _ in range(3)]  # content, style, one iteration
    engines = {dev: cv.ClipVQGANEngine(clip_backbone=backbone, seed=0, device=dev, draws=_ListDraws(draws))
               for dev in ("cuda", "cpu")}
    res_side = engines["cpu"].cut_size
    batch = (torch.rand((8, 3, res_side, res_side), generator=g) - 0.45) / 0.27
    res = {}
    for dev, eng in engines.items():
        with torch.no_grad():
            res[dev] = {"image": eng.clip.encode_image(batch.to(dev)).cpu(), "text": eng.clip.encode_text(toks).cpu(),
                        "decode": eng.vqgan.decode(eng.vqgan.lookup(codes.to(dev))).cpu(),
                        "indices": eng.vqgan.code_indices(eng.vqgan.encode(img.to(dev) * 2 - 1)).cpu()}
    for dev, eng in engines.items():
        z = eng.vqgan.lookup(res["cpu"]["indices"].to(dev))
        with torch.no_grad():
            targets = (eng.embed_cutouts(img.to(dev)), None, eng.embed_text(CV_TEXT), [eng.embed_cutouts(style.to(dev))])
        adam = Adam(eng.learning_rate)
        _, _, terms = eng.step(z, adam, adam.init(z), None, targets, (1.0, 1.0, 1.0))
        res[dev]["terms"] = terms.cpu().numpy()
    del engines
    torch.cuda.empty_cache()

    def rel(key):
        a, b = res["cuda"][key].double(), res["cpu"][key].double()
        return float((a - b).abs().max() / b.abs().max())

    rels = {k: rel(k) for k in ("image", "text", "decode")}
    tg, tc = res["cuda"]["terms"], res["cpu"]["terms"]
    terms_rel = float(np.max(np.abs(tg - tc) / np.where(tc == 0, 1.0, np.abs(tc))))  # the from term is 0 on both
    agree = float((res["cuda"]["indices"] == res["cpu"]["indices"]).double().mean())
    print(f"{key} ({backbone}) GPU vs CPU: {rels}, terms cuda {tg.tolist()} cpu {tc.tolist()} (rel {terms_rel:.3e}), "
          f"quantize indices agree on {agree:.4f} of {res['cpu']['indices'].numel()}")
    results[key] = {"backbone": backbone, **rels, "terms_rel": terms_rel, "terms_cuda": tg.tolist(),
                    "terms_cpu": tc.tolist(), "indices_agree": agree}
    if not (max(rels.values()) <= 1e-4 and terms_rel <= 1e-3):
        fail(f"{key} ({backbone}) GPU vs CPU: {rels}, terms rel {terms_rel:.3e}")


RN_BACKBONES = ("RN50", "RN101", "RN50x4")
RN_ITERS = 50


def tower_cost(backbone: str) -> dict:
    """A CLIP image tower's forward GFLOP and its layers' output MB for one
    image at its input resolution, counted from shapes: the tower built on
    the meta device, torch's FlopCounterMode over its convolutions and
    products, forward hooks over its leaf modules' outputs (f32)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from maua_style_tpu_torch.models.clip import model, resnet

    with torch.device("meta"):
        if backbone == "ViT-B/32":
            tower, res = model.VisionTransformer(model.VIT_B32), model.VIT_B32.image_resolution
        else:
            tower, res = resnet.ModifiedResNet(resnet.RESNET_CONFIGS[backbone]), resnet.RESNET_CONFIGS[backbone].image_resolution
    outs = []
    hooks = [m.register_forward_hook(lambda m, i, o: outs.append(o.numel())) for m in tower.modules()
             if not list(m.children())]
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        tower(torch.empty((1, 3, res, res), device="meta"))
    for h in hooks:
        h.remove()
    return {"resolution": res, "forward_gflop": counter.get_total_flops() / 1e9, "layer_outputs_mb": 4 * sum(outs) / 1e6}


def check_clip_embeddings_against_cpu(results: dict) -> None:
    """RN50, RN101 and RN50x4 with seeded random weights (``_load_clip``'s)
    on the GPU and on the CPU, TF32 off: image embeddings of 4 normalised
    images at each tower's resolution and text embeddings of 3 texts,
    within max|Δ| / max|·| <= 1e-4; with each tower's cost from its shapes."""
    import copy

    import torch

    from maua_style_tpu_torch.models.clip import tokenize
    from maua_style_tpu_torch.pipelines import clip_vqgan as cv

    os.environ["MAUA_ALLOW_RANDOM_WEIGHTS"] = "1"
    toks = tokenize(["a lighthouse", CV_TEXT, "noise, static and snow"])
    rows = {}
    for backbone in RN_BACKBONES:
        cpu = cv._load_clip(backbone).eval().requires_grad_(False)
        gpu = copy.deepcopy(cpu).cuda()
        side = cpu.input_resolution
        batch = (torch.rand((4, 3, side, side), generator=torch.Generator().manual_seed(13)) - 0.45) / 0.27
        with torch.no_grad():
            got = {"image": gpu.encode_image(batch.cuda()).cpu(), "text": gpu.encode_text(toks).cpu()}
            want = {"image": cpu.encode_image(batch), "text": cpu.encode_text(toks)}
        rel = {k: float((got[k].double() - want[k].double()).abs().max() / want[k].double().abs().max()) for k in got}
        rows[backbone] = {**rel, "embed_dim": int(want["image"].shape[1]), **tower_cost(backbone)}
        print(f"{backbone} GPU vs CPU:", json.dumps(rows[backbone]))
        del cpu, gpu
        torch.cuda.empty_cache()
        if not max(rel.values()) <= 1e-4:
            fail(f"{backbone} GPU vs CPU: {rel}")
    rows["ViT-B/32"] = tower_cost("ViT-B/32")
    results["clip_resnet_vs_cpu"] = rows


CVS_FRAMES, CVS_SIZE, CVS_ITERS, CVS_PASSES = 6, 256, 10, 2


def run_clip_video_style(results: dict) -> dict[str, int]:
    """``pipelines.clip_video_style.main`` on a synthetic 6-frame 1024x576
    clip (phase 5's pattern) and a 768² style with a style text: ViT-B/32
    and imagenet_16384 (seeded random weights, f32, TF32 off), SPyNet + PWC
    at the clip's size, ``--image_sizes 256``, 2 passes of 10 iterations a
    frame, ``--init prev_warp`` (the first pass warps by the flow).  Checks
    the frames, every .flo (finite, the clip's shape) and its preview, each
    pass's frames at 256x144 and the muxed video; K1 0 and K2 launches
    against the pre-pass's formula, each K2 input among phase 3's shapes;
    one ``update_styles`` for the scale.  Reports s per frame and the wall."""
    import numpy as np
    import torch
    from PIL import Image

    from maua_style_tpu_torch.io.flo import read_flo
    from maua_style_tpu_torch.models.flownets import pwc
    from maua_style_tpu_torch.ops.resize import scale_shape
    from maua_style_tpu_torch.pipelines import clip_video_style as cvs
    from maua_style_tpu_torch.pipelines import clip_vqgan as cv
    from maua_style_tpu_torch.pipelines import flow_prepass

    run_dir = os.path.join(OUT, "clip_video_style")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    v_path, s_path = write_video(run_dir, CVS_FRAMES)
    argv = ["--content", v_path, "--style", s_path, "--style_text", CV_TEXT, "--output_dir", run_dir,
            "--image_sizes", str(CVS_SIZE), "--num_iters", str(CVS_ITERS * CVS_PASSES),
            "--passes_per_scale", str(CVS_PASSES), "--init", "prev_warp", "--flow_models", "spynet,pwc",
            "--clip_backbone", "ViT-B/32", "--allow_random_weights", "--seed", "0", "--gpu", "0"]
    frames, styles, corr_inputs = [], [], set()

    def timed_frame(fn, self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(self, *a, **kw)
        frames.append({"s": time.perf_counter() - t0, "iters": kw["iterations"], "hw": list(np.shape(out)[1:3]),
                       "finite": bool(np.isfinite(self.last_loss_log).all())})
        return out

    def recording_corr(fn, f1, f2, d=4, s=1):
        corr_inputs.add((*f1.shape, d, s))
        return fn(f1, f2, d, s)

    cv._ENGINE = None  # one engine per process: this phase builds its own
    with patched((cv.ClipVQGANEngine, "optimize_cached", timed_frame),
                 (cv.ClipVQGANEngine, "update_styles", lambda fn, self, *a: styles.append(len(a[0])) or fn(self, *a)),
                 (pwc, "correlation", recording_corr)):
        reset_counts()
        t0 = time.perf_counter()
        cvs.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
    engine, cv._ENGINE = cv._ENGINE, None
    want_corr = K2_PER_FORWARD["pwc"] * 2 * -(-CVS_FRAMES // flow_prepass.PAIR_CHUNK)
    print(f"clip_video_style: {wall:.1f} s, launches {counts} (expected gram 0, correlation {want_corr})")
    if counts != {"gram": 0, "correlation": want_corr}:
        fail(f"clip_video_style launches {counts} != gram 0, correlation {want_corr}")
    checked = {(flow_prepass.PAIR_CHUNK, c, h, w, 4, 1) for c, h, w in pwc_levels(*VID_HW)}  # phase 3's B = 8 rows
    if corr_inputs != checked:
        fail(f"clip_video_style's K2 inputs {sorted(corr_inputs)} != phase 3's {sorted(checked)}")
    if engine is None or engine.device.type != "cuda" or styles != [1]:
        fail(f"clip_video_style: engine {engine}, update_styles calls {styles}")

    work = os.path.join(run_dir, "vid_style")
    names = [f"{i + 1:05d}" for i in range(CVS_FRAMES)]
    hw = tuple(scale_shape(VID_HW, CVS_SIZE / max(VID_HW)))

    def png_hw(path):
        if not os.path.exists(path):
            fail(f"missing {path}")
        with Image.open(path) as img:
            return img.height, img.width

    for n in names:
        if png_hw(os.path.join(work, "frames", f"{n}.png")) != VID_HW:
            fail(f"frame {n}: wrong shape")
        for p in range(1, CVS_PASSES + 1):
            if png_hw(os.path.join(work, str(CVS_SIZE), f"{p}_{n}.png")) != hw:
                fail(f"{CVS_SIZE}/{p}_{n}.png: wrong shape")
    for a, b in zip(names, names[1:] + names[:1]):
        for stem in (f"forward_{a}_{b}", f"backward_{b}_{a}"):
            flo = read_flo(os.path.join(work, "flow", stem + ".flo"))
            if flo.shape != (*VID_HW, 2) or not np.isfinite(flo).all():
                fail(f"{stem}.flo: shape {flo.shape} or not finite")
            if png_hw(os.path.join(work, "flow", stem + ".png")) != VID_HW:
                fail(f"{stem}.png: wrong shape")
    mp4, npy = (os.path.join(work, f"vid_style_{CVS_SIZE}.{ext}") for ext in ("mp4", "npy"))
    if not os.path.exists(mp4) and not (os.path.exists(npy) and np.load(npy).shape == (CVS_FRAMES, *hw, 3)):
        fail(f"no muxed video for {CVS_SIZE}")
    if len(frames) != CVS_FRAMES * CVS_PASSES or any(f["iters"] != CVS_ITERS or tuple(f["hw"]) != hw or not f["finite"]
                                                     for f in frames):
        fail(f"clip_video_style frames: {frames}")
    per_pass = [statistics.median(f["s"] for f in frames[p * CVS_FRAMES:(p + 1) * CVS_FRAMES]) for p in range(CVS_PASSES)]
    summary = {"wall_s": wall, "launches": counts, "s_per_frame_median_by_pass": per_pass,
               "s_per_frame_mean": sum(f["s"] for f in frames) / len(frames), "frames": len(frames),
               "k2_inputs": sorted(corr_inputs), "argv": argv}
    print("clip_video_style", json.dumps({k: v for k, v in summary.items() if k != "argv"}))
    results["clip_video_style"] = summary
    del engine
    torch.cuda.empty_cache()
    return counts


SIM_SIDE, SIM_SIZES, SIM_ITERS = 512, (256, 512), (20, 10)


def similarity_gram_shapes() -> list[tuple[int, int, int]]:
    """(B, C, N) of K1's inputs on the similarity phase's path: VGG-19's
    five style layers of a square image at each of its two sizes."""
    return [(1, c, n) for size in SIM_SIZES for c, n in vgg_style_shapes(size)]


def check_similarity_gram(results: dict) -> dict:
    """K1 at the similarity phase's ten input shapes, f32, with phase 2's
    bars and times."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for shape in similarity_gram_shapes():
        f = torch.relu(torch.randn(shape, device="cuda", generator=gen))
        row = {"shape": list(shape), **measure_gram(f)}
        rows.append(row)
        print("similarity gram", json.dumps(row))
        del f
    results["gram_similarity"] = rows
    return {"ms": sum(r["kernel_ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "library_ms": sum(r["library_ms"] for r in rows), "bound_ms": sum(r["bound_ms"] for r in rows),
            "max_rel_err_f64": max(r["kernel_rel_err_f64"] for r in rows), "shapes": len(rows)}


def write_similarity_dataset(d: str) -> list[str]:
    """Three 512² images with distinct colour distributions: warm
    gradients, cool stripes, green and magenta rings."""
    import numpy as np
    from PIL import Image

    yy, xx = np.mgrid[0:SIM_SIDE, 0:SIM_SIDE].astype(np.float32) / (SIM_SIDE - 1)
    r = np.hypot(xx - 0.5, yy - 0.5)
    images = {
        "warm": np.stack([200 + 55 * xx, 80 + 120 * yy, 30 + 40 * xx * yy], -1),
        "cool": np.stack([30 + 40 * yy, 90 + 60 * (np.sin(xx * 40) > 0), 160 + 95 * xx], -1),
        "rings": np.stack([120 + 120 * np.sin(r * 60), 200 - 150 * r, 140 + 110 * np.cos(r * 60)], -1),
    }
    paths = []
    for stem, img in images.items():
        paths.append(os.path.join(d, f"{stem}.png"))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(paths[-1])
    return paths


def run_similarity(results: dict) -> dict[str, int]:
    """``pipelines.similarity.main`` on three synthetic 512² images:
    ``--image_sizes 256,512 --num_iters 20,10 --grids``, the CLI's other
    defaults (VGG-19 with seeded random weights, L-BFGS, f32), 9 img_img
    jobs (each image with each of its two neighbours, and with both).
    Checks hists.npy, dists.npy (inf on the diagonal), the grids, each
    job's artifacts; K1 launches against img_img's formula summed over the
    jobs (5 an iteration, 5 per style image per scale), every K1 input
    among phase 2's shapes, K2 0.  Reports the wall s of each job."""
    import numpy as np
    from PIL import Image

    from maua_style_tpu_torch import losses
    from maua_style_tpu_torch.pipelines import img_img as img_img_module
    from maua_style_tpu_torch.pipelines import similarity as sim
    from maua_style_tpu_torch.utils import name

    run_dir = os.path.join(OUT, "similarity")
    shutil.rmtree(run_dir, ignore_errors=True)
    data, out = os.path.join(run_dir, "data"), os.path.join(run_dir, "out")
    os.makedirs(data)
    images = write_similarity_dataset(data)
    os.environ["MAUA_ALLOW_RANDOM_WEIGHTS"] = "1"  # the CLI has no --allow_random_weights; its img_img reads this
    jobs, seen = [], set()

    def timed_job(fn, args):
        t0 = time.perf_counter()
        fn(args)
        jobs.append({"output": args.output, "styles": len(args.style), "s": time.perf_counter() - t0})

    def recording(fn, x, use_covariance=False):
        seen.add((x.shape[0], x.shape[1], x.shape[2] * x.shape[3]))
        return fn(x, use_covariance)

    argv = [data, "--output_dir", out, "--image_sizes", ",".join(map(str, SIM_SIZES)),
            "--num_iters", ",".join(map(str, SIM_ITERS)), "--grids", "--gpu", "0"]
    with patched((img_img_module, "img_img", timed_job), (losses, "batch_gram", recording)):
        reset_counts()
        t0 = time.perf_counter()
        sim.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
    want_gram = sum(5 * (it + j["styles"]) for j in jobs for it in SIM_ITERS)
    print(f"similarity: {wall:.1f} s, {len(jobs)} jobs, launches {counts} (expected gram {want_gram}, correlation 0)")
    if len(jobs) != 9 or sorted(j["styles"] for j in jobs) != [2] * 6 + [3] * 3:
        fail(f"similarity jobs {jobs}")
    if counts != {"gram": want_gram, "correlation": 0}:
        fail(f"similarity launches {counts} != gram {want_gram}, correlation 0")
    if seen != set(similarity_gram_shapes()):
        fail(f"similarity's Gram inputs {sorted(seen)} != phase 2's {sorted(similarity_gram_shapes())}")
    hists, dists = np.load(os.path.join(data, "hists.npy")), np.load(os.path.join(data, "dists.npy"))
    if hists.shape != (3, 3, 64) or dists.shape != (3, 3) or not np.isinf(np.diag(dists)).all() \
            or not np.isfinite(dists[~np.eye(3, dtype=bool)]).all():
        fail(f"similarity caches: hists {hists.shape}, dists {dists.tolist()}")
    for img in images:
        with Image.open(os.path.join(data, "grids", f"{name(img)}.png")) as g:
            if g.size != (900, 900):
                fail(f"grid of {img}: {g.size}")
    for j in jobs:
        for size in SIM_SIZES:
            with Image.open(f"{j['output']}_{size}.png") as img:
                arr = np.asarray(img)
            if arr.shape != (size, size, 3) or not arr.std() > 0:
                fail(f"{j['output']}_{size}.png: shape {arr.shape}, std {arr.std()}")
    summary = {"wall_s": wall, "launches": counts, "jobs": len(jobs), "s_per_job": [j["s"] for j in jobs],
               "s_per_job_median": statistics.median(j["s"] for j in jobs), "argv": argv}
    print("similarity", json.dumps({k: v for k, v in summary.items() if k != "argv"}))
    results["similarity"] = summary
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from maua_style_tpu_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    from maua_style_tpu_torch.ops.correlation import launch_plan

    # K2's libraries for phase 3's (d, s) families: PWC's d = 4, d = 3, (d = 20, s = 2)
    corr_libs = [("correlation", launch_plan(1, 8, 16, 32, d, s).defines) for d, s in ((4, 1), (3, 1), (20, 2))]
    t0 = time.perf_counter()
    build_s = build.build(["gram", *corr_libs])  # nvcc for sm_90a, from the sources in this checkout, in parallel
    print(f"kernel builds (parallel): {json.dumps(build_s)}, {time.perf_counter() - t0:.1f} s in all")
    ptxas = {" ".join(defines): build.ptxas_report(name, defines) for name, defines in corr_libs}
    for key, log in ptxas.items():
        print(f"ptxas -v, correlation.cu {key}:")
        print("\n".join(line for line in log.splitlines() if "Function properties" in line or "registers" in line
                        or "spill" in line or "Compiling entry" in line))

    os.makedirs(OUT, exist_ok=True)
    results = {"card": smi, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
               "cuda": torch.version.cuda, "build_s": build_s, "ptxas_correlation": ptxas}
    try:
        gram, corr = run_phases(results)
    finally:
        # the video runs' artifacts (hundreds of MB) go even when a phase fails
        for d in ("vid_img", "vid_img_unflow_liteflownet", "stacked", "img_vid", "flags", "nca", "clip_vqgan",
                  "clip_vqgan_rn50", "clip_video_style", "similarity"):
            shutil.rmtree(os.path.join(OUT, d), ignore_errors=True)
        with open(os.path.join(OUT, "results.json"), "w") as f:
            json.dump(results, f, indent=1)

    print(json.dumps({"kernels": [gram, corr]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def run_phases(results: dict) -> tuple[dict, dict]:
    """Phases 2 to 7; returns the kernels line's K1 and K2 entries."""
    gram = check_gram(results)
    gram["img_vid_shapes"] = check_video_gram(results)
    gram["nca_shapes"] = check_nca_gram(results)
    gram["similarity_shapes"] = check_similarity_gram(results)
    gram["vid_img_shapes"] = check_vid_gram(results)
    corr = check_correlation(results)
    img = run_main_path(results)
    check_small_against_cpu(results)
    profile_step(results)
    vid = run_vid_img(results)
    check_flow_against_cpu(results)
    profile_vid_frame(results)
    shutil.rmtree(os.path.join(OUT, "vid_img"))  # ~200 MB of frames and flow, checked above
    check_stacked_against_per_frame(results)
    vid_d = run_vid_img(results, "vid_img_unflow_liteflownet", VD_FLOW, VD_SIZES, VD_ITERS, VD_PASSES)
    shutil.rmtree(os.path.join(OUT, "vid_img_unflow_liteflownet"))
    for nets in VD_FLOW.split(","):
        check_flow_against_cpu(results, nets)
    ivid = run_img_vid(results)
    profile_img_vid_window(results)
    check_img_vid_against_cpu(results)
    nca_train_counts, nca_gen_counts = run_nca(results)
    check_nca_against_cpu(results)
    cv_counts, cv_engine = run_clip_vqgan(results)
    profile_clip_vqgan(results, cv_engine)
    del cv_engine
    check_clip_vqgan_against_cpu(results)
    rn_counts, rn_engine = run_clip_vqgan(results, "clip_vqgan_rn50", "RN50", RN_ITERS)
    profile_clip_vqgan(results, rn_engine, "profile_clip_vqgan_rn50")
    del rn_engine
    check_clip_vqgan_against_cpu(results, "RN50", "clip_vqgan_rn50_vs_cpu")
    check_clip_embeddings_against_cpu(results)
    cvs_counts = run_clip_video_style(results)
    shutil.rmtree(os.path.join(OUT, "clip_video_style"))
    sim_counts = run_similarity(results)
    shutil.rmtree(os.path.join(OUT, "similarity"))
    drive_flags(results)
    check_determinism(results)
    run_tuner(results)  # last: its probes take the card's memory to its limit
    # launches: each path's own count, read right after it ran from zero
    paths = {"img_img": img, "vid_img": vid, "vid_img_unflow_liteflownet": vid_d, "img_vid": ivid,
             "nca_train": nca_train_counts, "nca_gen": nca_gen_counts, "clip_vqgan": cv_counts,
             "clip_vqgan_rn50": rn_counts, "clip_video_style": cvs_counts, "similarity": sim_counts}
    gram["launches"] = img["gram"]
    gram["launches_by_path"] = {k: v["gram"] for k, v in paths.items()}
    corr["launches"] = vid["correlation"]
    corr["launches_by_path"] = {k: v["correlation"] for k, v in paths.items()}
    results["kernels"] = [gram, corr]
    return gram, corr


if __name__ == "__main__":
    sys.exit(main())
