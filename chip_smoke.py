#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (maua_style_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only check_fused_gram,run_main_path,run_fused   # those phases alone

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
   the per-frame passes' (1, C, N) and the style captures'; and at the
   mesh phases' new inputs, the two bands of a 1024² pastiche, (1, C, N/2),
   a frames:2 half of the frames phase's chunk, (4, C, N) at 512x288, and
   phase 6j's bands: of 512x288 stacks of 8 and 4 frames and of one frame,
   and of one 1024x576 frame, (B, C, N/2); and at phase 6k's: the row
   bands of img_vid's windows, (gfw, C, N_j) and (1, gfw·C, N_j), and the
   "frames" shares, (T_i, C, N) and (1, T_i·C, N), whole and banded (9 + 9
   frames at 256, 5 + 4 at 512, 4 + 3 at 724); and at phase 6l's: NIN's
   six style layers (relu1 … relu11) of a 9088² image whole and in its two
   row bands, (1, 96, 5152900) … (1, 1024, 39903), and of the CLI's 256²
   and 512² whole and banded; and at phase 6n's: the channel shares of
   VGG-19's five style layers at 1024² on tensor:2, (1, 32, 1048576) …
   (1, 256, 4096), and on space:2,tensor:3, (1, 22, 524288) … (1, 170,
   2048), and of the CLI's 256² and 512² on tensor:3; and at phases 6n's
   tensor:4 step's, 6o's and 6p's: tensor:4's shares at 256², (1, 16,
   65536) … (1, 128, 256), the channel shares of vid_img's stacks, (8, 32,
   147456) … (8, 256, 576) at 512x288 and (4, C_t, N) on
   frames:2,tensor:2, and of one 1024x576 frame, (1, 32, 589824) … (1,
   256, 2304), and img_vid's groups: the static Grams (T_i, C_t, N) and
   whole-window diagonal blocks (1, T_i·C_t, N) of the 724 window (7
   frames, or 4 + 3) and of the 256 CLI's 18-frame windows; and at phase
   6q's: the bands of space:2 and the channel shares of tensor:2 at 256²
   and 512², and VGG-19's style layers at 64² and 96².
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
   highest.  Checks the PNGs, the loss logs and the K1 launch count, and
   records the peak memory, the host seconds between scales and the
   synchronising calls (phase 6q's run sets them beside its own); then a
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
   iteration per frame of every other pass, 5 per style capture), the wall
   and the peak memory; then
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
   first activations), s per window, the wall and the peak memory; a
   torch.profiler window over one img_vid window
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
6g. Fidelity: ``maua_style_tpu_torch.fidelity`` on a 256→512 img_img (20
   and 10 L-BFGS iterations, VGG-19 f32 with seeded random weights, TF32
   off, ``cudnn.deterministic``) against the same run on the CPU (``--gpu
   c``), at ``--learning_rate 1`` (the CLI's) and 0.1: fails when the lr
   0.1 pair scores below the tool's 0.98; the lr 1 pair's SSIM is report
   only (it scored 0.3637: at lr 1 L-BFGS turns float noise into another
   image, PERF.md); both pairs' largest relative loss-log difference per
   iteration; K1's launches and inputs.
6h. The "space" mesh: img_img's ``StyleEngine.optimize`` at 1024² (VGG-19
   f32, L-BFGS history 100) unsharded and on a space:2 mesh of ``[cuda:0,
   cuda:0]``: under ``cudnn.deterministic`` one step's loss terms (rtol
   1e-5) and gradient (1e-4), and 10 iterations from the content init at
   lr 0.1 (the first two iterations' total losses within rtol 1e-5, every
   iteration's within rtol 1e-4, mean|Δ| within 1e-2 of mean|p|), K1's
   launches (10 an iteration on two bands, 5 unsharded) and inputs; then
   ms/iter and peak memory of both in turns at lr 1.  With
   two or more cards also the CLI with ``--gpu 0,1`` at 2048² and each
   card's peak; on one card it prints that this part did not run and why.
6i. The "frames" mesh: ``optimize_frames`` on 8 frames at 512x288 (phase
   5's engine, L-BFGS from its random init) unsharded and on a frames:2
   mesh of ``[cuda:0, cuda:0]``: over 5 iterations phase 5's stacked bars
   (loss logs within rtol 1e-2, mean|Δ| within 1e-2 of mean|p|), K1's
   launches and inputs; the same readings over the pass's 20 iterations,
   report only (L-BFGS drifts further); the seconds of both at 20
   iterations in turns.
6j. vid_img on meshes, one card standing in for several: phase 5's CLI
   run with ``--gpu 0,0 --mesh space:2`` (every frame in two row bands)
   and with ``--gpu 0,0,0,0 --mesh frames:2,space:2`` (the stacked first
   pass's chunk shared out to two rows of two bands, the chained passes on
   the first row's bands): phase 5's checks, K1's launches (5 per band per
   share per iteration, plus captures) and K2's (phase 5's), s per frame,
   wall s and peak memory beside phase 5's unsharded run.  Between them,
   under ``cudnn.deterministic``, ``optimize_frame`` at 1024x576 (the
   temporal term from the space:2 run's flow and reliability) unsharded
   and on space:2: one step's loss terms (rtol 1e-5) and gradient (1e-4);
   10 iterations at lr 0.1 from the ``warp_prev`` init (the first two
   totals within rtol 1e-5, mean|Δ| within 1e-2 of mean|p|, the later
   totals within twice the unsharded run's own drift from an init one f32
   spacing off: ``check_vid_frame_parity`` says why) and from the random
   init (also every total within rtol 1e-4), with each run's peak
   memory.  Then 6i's check of
   ``optimize_frames`` on space:2 and on frames:2,space:2 (``[cuda:0] *
   4``), with its bars and its 20-iteration reading, report only, and the
   seconds of each.
6k. img_vid on meshes, one card standing in for several: phase 6's CLI
   run at its first two scales (256 and 512) with ``--gpu 0,0 --mesh
   space:2`` (every window's frames in two row bands) and with ``--gpu
   0,0,0,0 --mesh frames:2,space:2`` (each window's frames shared out to
   two rows of two bands, 9 + 9 at gfw 18, 5 + 4 at gfw 9): phase 6's
   checks, K1's launches (10 per band per share per iteration, plus the
   captures', whole on the first device) and the whole-window Gram's
   off-diagonal products (plain ``torch.matmul``, 5 per band per pair of
   shares an iteration), s per window, wall s and peak memory beside
   phase 6's run.  Between them, under ``cudnn.deterministic``, one 724
   window (7 frames, gfw 7) unsharded against space:2, frames:2 and
   frames:2,space:2, at w = 0 and under w = 1's frozen split: one step's
   loss terms (rtol 1e-5) and gradient (1e-4), 4 L-BFGS iterations at lr
   0.1 (6h's and 6j's) from the random init (the first two totals within
   rtol 1e-5, mean|Δ| within 1e-2 of mean|p|), ms per iteration and
   peaks; at the CLI's lr 1 (w = 0) the first two totals within rtol 1e-5
   and mean|Δ| within twice the unsharded run's own from an init one f32
   spacing off; and the off-diagonal products' device ms an iteration and
   their share of a window's.
6l. NIN on "space", one card standing in for two (configs/scaling-img.json's
   "9088" row: NIN, style relu1,3,5,7,9,11, content relu8, Adam, lr 1, on
   space:2; seeded random weights, f32, TF32 off): ``StyleEngine.optimize``
   at 9088², one scale, unbanded and on a space:2 mesh of ``[cuda:0,
   cuda:0]`` (two bands of 4544 rows).  Under ``cudnn.deterministic`` one
   step from the content init: every loss term within rtol 1e-5 and the
   gradient within 1e-4 of its max (6h's bars, ``run_nin_space`` says
   why).  Then, warmed up, 3 iterations of each: ms/iter, each run's peak
   memory, the loss logs' relative difference and mean|Δ| (report only:
   Adam's steps are sign(g) where g is float noise), K1's launches (6 a
   capture, 6 an iteration unsharded, 12 on two bands) and inputs (among
   phase 2's).  Then the img_img CLI with ``--model_file nin --gpu 0,0
   --mesh space:2`` and the table's layers and optimiser at 256 and 512
   (10 and 5 iterations): the PNGs, finite loss logs, every engine banded,
   K1's launches and inputs.
6m. The VQGAN decoder on "space": ``spatial.banded_decode`` of
   imagenet_16384 at full width (seeded random weights, f32, TF32 off,
   ``cudnn.deterministic``) on a space:2 mesh of ``[cuda:0, cuda:0]``
   against the whole decode, at z of 16×16 (256² out, the clip_vqgan
   CLI's default) and 64×64 (1024²): the output and the gradient of a
   random projection with respect to z within 1e-4 of their max
   (``run_vqgan_space`` says why), ms of the forward and of forward plus
   gradient, and each one's peak memory; K1 and K2 0.
6n. The "tensor" mesh axis, one card standing in for two and six:
   img_img's ``StyleEngine.optimize`` at 1024² (VGG-19 f32, L-BFGS history
   100, TF32 off) unsharded, on tensor:2 over ``[cuda:0] * 2`` and on
   space:2,tensor:3 over ``[cuda:0] * 6``: under ``cudnn.deterministic``
   one step's loss terms (rtol 1e-5) and gradient, and 10 iterations from
   the content init at lr 0.1 (6h's bars, or twice the unsharded run's own
   difference at an input one f32 spacing off where that is larger:
   ``run_tensor`` says why); K1's launches (5 per share per
   band an iteration, plus the capture's) and inputs, the off-diagonal
   Gram blocks' plain products; ms/iter, peak memory and the products'
   device ms at lr 1; then the style CLI with ``--gpu 0,0,0 --mesh
   tensor:3`` at 256 and 512: the PNGs, finite loss logs, launches; and
   one step at 256² on tensor:4 over ``[cuda:0] * 4`` (the colour channels
   1 + 1 + 1 + 0): the terms within rtol 1e-5 of unsharded, no convolution
   or K1 launch on the empty share.
6o. vid_img on "tensor", one card standing in for two and four: phase 5's
   CLI run with ``--gpu 0,0 --mesh tensor:2`` cut to its 512 scale (phase
   5's checks, K1's launches: 5 per channel share per band per iteration
   plus captures, K2's as phase 5's; s per frame, wall s and peak beside
   phase 5's unsharded run); under ``cudnn.deterministic``
   ``optimize_frame`` at 1024x576 (the temporal term from that run's flow
   and reliability) unsharded and on tensor:2: one step's terms (rtol
   1e-5) and gradient (twice the unsharded gradient's own difference at an
   input one f32 spacing off), 10 iterations at lr 0.1 from the
   ``warp_prev`` init (the first two totals within rtol 1e-5, later ones
   and mean|Δ| within twice the unsharded run's own from eight inits one
   f32 spacing off, at least 1e-4 and 1e-2 of mean|p|) and from the random
   init (6j's bars: every total within rtol 1e-4, mean|Δ| within 1e-2);
   then 6i's check of ``optimize_frames`` on tensor:2 and
   frames:2,tensor:2.
6p. img_vid on "tensor", one card standing in for two and four: 6k's 724
   window (7 frames, gfw 7) unsharded against tensor:2 and
   frames:2,tensor:2, at w = 0 and under w = 1's frozen split, one step
   and 4 L-BFGS iterations at lr 0.1 (the terms and the first two totals
   within rtol 1e-5, the gradient within twice the unsharded one's own
   from 6o's eight inits one f32 spacing off, every total within rtol
   1e-4, mean|Δ| within 1e-2 of mean|p|), the off-diagonal
   products an iteration and their device ms; then phase 6's CLI with
   ``--gpu 0,0 --mesh tensor:2`` cut to its 256 scale (phase 6's checks,
   K1's launches and the products against the schedule's formula; s per
   window beside phase 6's run).
6q. img_img's pyramid with ``--fuse_scales`` (``StyleEngine.optimize_pyramid``,
   every scale's tail on the device): phase 4's CLI run fused (five PNGs of
   its shapes, each scale's loss falling, K1 475 launches; the wall, each
   scale's ms/iter, the host seconds between scales, the peak memory and
   the synchronising calls under ``torch.cuda.set_sync_debug_mode("warn")``
   beside phase 4's); fused against the per-scale loop at 256/512/724, the
   loop's later inits resized on the card as the fused run's (bit for bit),
   and on space:2 and tensor:2 at 256/512 (rtol 1e-4, mean|Δ| 1e-2); and
   the fused pyramid with histogram matching on at 64 and 96 px on the
   card against ``--gpu c`` with one draw of the colour statistics (loss
   logs within rtol 1e-3, aggregate u8 bars).
7. Paths no other phase drives (report only; a failure fails the run):
   img_img at 512² with --compute_dtype bfloat16, --precision high,
   --optimizer adam and --original_colors, and a short vid_img with --init
   prev_warp --original_colors; then the 1024² img_img step twice from one
   seed, with and without ``torch.backends.cudnn.deterministic``, printing
   the first activation, Gram, loss or gradient that differs.
7b. The capacity tuner (``tuning/max_sizes.py``), last because its probes
   fill the card: measured peaks of VGG-19 (L-BFGS compact and two-loop,
   Adam; f32 and bf16) and prune (Adam, f32) at 512², 1024² and 2048²
   beside the estimate and its error, with the allocator's reserved peak
   and the free memory, the constants fitted to them, the measured search
   for VGG-19 (L-BFGS and Adam, f32; its budget the free memory at its
   start) written to chiprun_out/chip_smoke/, with each probe's reserved
   and allocated peaks and seconds and each search's probes and seconds,
   one img_img scale at the L-BFGS safe size in this process (beside the
   fresh-process table's), the estimate's VGG-19 tables at 2, 4 and 8
   devices (the measured 2-device probe needs two distinct cards: on one
   it prints that it did not run), ``hbm_bytes()`` and the frame sizing;
   fails if that scale runs out of memory or the allocator's count does
   not return to its start.
8. The script's seconds (and each phase's, as it ends), a ``kernels``
   JSON line, the card line, and last the ``ok`` line.

Exits non-zero without an ``ok`` line when there is no CUDA device, when
the package is not beside this script, or when any phase fails.  Details
go to chiprun_out/chip_smoke/results.json; the video runs' artifacts are
deleted once checked.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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


# VGG-19's style layers: (C, name)
VGG_STYLE = ((64, "relu1_1"), (128, "relu2_1"), (256, "relu3_1"), (512, "relu4_1"), (512, "relu5_1"))


def vgg19_spec():
    """VGG-19's spec (``spatial.level_heights`` reads its layers)."""
    from maua_style_tpu_torch.models import select_model

    return select_model("vgg19")


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


# a call at least this long is timed in a graph of 4 calls, 3 replays after 1
# (its launch work is under 1% of it): the plain versions at the largest inputs
SLOW_CALL_MS = 1.0


def graph_ms(fn, launches: int = 10) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured in a
    CUDA graph, its replay timed by ``time_ms``.  Unlike events around one
    call, this leaves out the host's launch work, which is longer than a
    small kernel.  A call of ``SLOW_CALL_MS`` or more (read by events
    around its first use) is timed in a graph of at most 4 calls, 3
    replays after one warm-up: where each call takes milliseconds, the
    launch work the graph leaves out is under 1% of it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        a.record()
        fn()  # first use outside the capture
        b.record()
    torch.cuda.current_stream().wait_stream(side)
    b.synchronize()
    slow = a.elapsed_time(b) >= SLOW_CALL_MS
    launches = min(launches, 4) if slow else launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms = (time_ms(graph.replay, reps=3, warmup=1) if slow else time_ms(graph.replay)) / launches
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
# phase 6k: phase 6's CLI on meshes of one card standing in for several, cut
# in depth to its first scale; then one 724 window
# (gfw 7) unsharded against each mesh, at w = 0 and under the frozen split of w = 1
IV_MESH = (("space2", "0,0", "space:2"), ("frames2_space2", "0,0,0,0", "frames:2,space:2"))
IV_MESH_SCALES = 2
IV_PARITY_SIZE, IV_PARITY_GFW, IV_PARITY_ITERS, IV_PARITY_FROZEN = 724, 7, 4, (3, 1)
# the gated iterations' lr, as 6h's and 6j's; the CLI's lr 1 is read too
IV_PARITY_LR, IV_CLI_LR = 0.1, 1.0
IV_PARITY_MESHES = (("space2", "space:2"), ("frames2", "frames:2"), ("frames2_space2", "frames:2,space:2"))
# phase 6p: img_vid on "tensor": phase 6's CLI cut to its 256 scale, and the 724 window
IV_TENSOR_CLI, IV_TENSOR_SIZES = ("tensor2", "0,0", "tensor:2"), IV_SIZES[:1]
IV_TENSOR_MESHES = (("tensor2", "tensor:2"), ("frames2_tensor2", "frames:2,tensor:2"))


def iv_hw(size: int) -> tuple[int, int]:
    """The img_vid phase's pastiche (H, W) at ``size``."""
    from maua_style_tpu_torch.ops.resize import scale_shape

    return tuple(scale_shape(IV_HW, size / max(IV_HW)))


def iv_style_hw(size: int) -> tuple[int, int]:
    """The style video's (H, W) at ``size``: ``scale_styles`` resizes it to
    about the pastiche's area."""
    import math

    from maua_style_tpu_torch.ops.resize import scale_shape

    hw = iv_hw(size)
    return tuple(scale_shape(IV_STYLE_HW, math.sqrt(hw[0] * hw[1] / (IV_STYLE_HW[0] * IV_STYLE_HW[1]))))


def img_vid_gram_shapes() -> list[tuple[int, int, int, int]]:
    """(size, gfw, C, N) of the style layers that the img_vid phase's Grams
    see: relu1_1..relu5_1 of a gfw-frame window at each scale, of the
    1024x576 pastiche and of the style video, which ``scale_styles``
    resizes to about the content's area (VGG-19's 2x2 pools round down).
    K1 gets each as a batch of per-frame Grams, (gfw, C, N), and as the
    whole-window view, (1, gfw·C, N)."""
    out = set()
    for size, gfw in zip(IV_SIZES, IV_GFW):
        for h, w in (iv_hw(size), iv_style_hw(size)):
            for c in (64, 128, 256, 512, 512):
                out.add((size, gfw, c, h * w))
                h, w = h // 2, w // 2
    return sorted(out)


def iv_window_gram_inputs(hw, t_w: int, shares: int = 1, bands: int = 1, tensor: int = 1) -> set[tuple[int, int, int]]:
    """K1's inputs in one iteration of a ``t_w``-frame img_vid window of hw
    frames (or in one target capture) on a mesh of ``shares`` "frames" rows
    of ``bands`` "space" bands (``parallel.window_shares``: as even as
    possible) and ``tensor`` channel shares: per share, band and channel
    share, the static Grams' (T_i, C_t, N_j) and the whole-window Gram's
    diagonal block of the group, (1, T_i·C_t, N_j)."""
    per, extra = divmod(t_w, shares)
    frames = {per + (i < extra) for i in range(shares)} - {0}
    return {s for t in frames for c, n in band_style_shapes(*hw, bands, tensor) for s in ((t, c, n), (1, t * c, n))}


def img_vid_run_gram_inputs(sizes, gfws, shares: int = 1, bands: int = 1, tensor: int = 1) -> set[tuple[int, int, int]]:
    """K1's inputs on an img_vid CLI run: each scale's style target
    captures (whole, on the first device) and its windows' iterations."""
    out = set()
    for size, gfw in zip(sizes, gfws):
        out |= iv_window_gram_inputs(iv_style_hw(size), gfw) | iv_window_gram_inputs(iv_hw(size), gfw, shares, bands,
                                                                                     tensor)
    return out


def img_vid_mesh_gram_inputs() -> set[tuple[int, int, int]]:
    """K1's inputs on phase 6k: its two CLI runs and its 724 window on
    space:2, frames:2 and frames:2,space:2."""
    from maua_style_tpu_torch import config

    out = set()
    for _, _, mesh in IV_MESH:
        axes = dict(config.parse_mesh(mesh))
        out |= img_vid_run_gram_inputs(IV_SIZES[:IV_MESH_SCALES], IV_GFW, axes.get("frames", 1), axes.get("space", 1))
    for _, mesh in IV_PARITY_MESHES:
        axes = dict(config.parse_mesh(mesh))
        out |= img_vid_run_gram_inputs((IV_PARITY_SIZE,), (IV_PARITY_GFW,), axes.get("frames", 1), axes.get("space", 1))
    return out


def img_vid_tensor_gram_inputs() -> set[tuple[int, int, int]]:
    """K1's inputs on phase 6p: its CLI run at 256 on tensor:2 and its 724
    window on tensor:2 and frames:2,tensor:2 (each group's static Grams,
    (T_i, C_t, N), and whole-window diagonal block, (1, T_i·C_t, N))."""
    from maua_style_tpu_torch import config

    out = img_vid_run_gram_inputs(IV_TENSOR_SIZES, IV_GFW, 1, 1, dict(config.parse_mesh(IV_TENSOR_CLI[2]))["tensor"])
    for _, mesh in IV_TENSOR_MESHES:
        axes = dict(config.parse_mesh(mesh))
        out |= img_vid_run_gram_inputs((IV_PARITY_SIZE,), (IV_PARITY_GFW,), axes.get("frames", 1), axes.get("space", 1),
                                       axes.get("tensor", 1))
    return out


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


def check_img_vid_mesh_gram(results: dict) -> dict:
    """K1 at every input of phase 6k that phase 6's check does not hold,
    f32, with phase 2's bars and times: the row bands' (gfw, C, N_j) and
    (1, gfw·C, N_j) at 256 (and 724), and the "frames" shares' (T_i, C, N)
    and (1, T_i·C, N), whole and banded (9 + 9 frames at 256, 4 + 3 at
    724)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for shape in sorted(img_vid_mesh_gram_inputs() - img_vid_run_gram_inputs(IV_SIZES, IV_GFW)):
        f = torch.relu(torch.randn(shape, device="cuda", generator=gen))
        row = {"shape": list(shape), "kind": "window" if shape[0] == 1 else "frames", **measure_gram(f)}
        rows.append(row)
        print("img_vid mesh gram", json.dumps(row))
        del f
    torch.cuda.empty_cache()
    results["gram_img_vid_mesh"] = rows
    out = {"shapes": len(rows), "max_rel_err_f64": max(r["kernel_rel_err_f64"] for r in rows)}
    for kind in ("window", "frames"):
        kr = [r for r in rows if r["kind"] == kind]
        out[kind] = {"ms": sum(r["kernel_ms"] for r in kr), "plain_ms": sum(r["plain_ms"] for r in kr),
                     "library_ms": sum(r["library_ms"] for r in kr), "bound_ms": sum(r["bound_ms"] for r in kr),
                     "shapes": len(kr), "slower_than_library": [r["shape"] for r in kr if r["kernel_ms"] >= r["library_ms"]]}
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


_COUNTS = ("gram.launches", "correlation.launches")
_counts_from: dict[str, int] = {}


def reset_counts() -> None:
    from maua_style_tpu_torch import trace

    _counts_from.update({name: trace.counter(name) for name in _COUNTS})


def read_counts() -> dict[str, int]:
    """The kernels' launches since ``reset_counts`` (differences of the
    port's process-wide counters)."""
    from maua_style_tpu_torch import trace

    return {name.split(".")[0]: trace.counter(name) - _counts_from.get(name, 0) for name in _COUNTS}


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
                       "steps": self.__dict__.pop("_steps_span"), "log": self.last_loss_log})
        return out

    def timed_run(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_run(self, *a, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.__dict__.setdefault("_chunk_ms", []).append(((t1 - t0) * 1e3, a[-1]))
        # the host clock at the scale's first step and after its last
        self.__dict__["_steps_span"] = (self.__dict__.get("_steps_span", (t0,))[0], t1)
        return out

    argv = [
        "--content", c_path, "--style", s_path, "--output_dir", run_dir,
        "--image_sizes", ",".join(map(str, SIZES)), "--num_iters", ",".join(map(str, ITERS)),
        "--optimizer", "lbfgs", "--lbfgs_num_correction", "100", "--model_file", "vgg19",
        "--allow_random_weights", "--precision", "highest", "--compute_dtype", "float32",
        "--seed", "0", "--gpu", "0", "--verbose", "--print_iter", "10",
    ]
    StyleEngine.optimize, StyleEngine._run = timed_optimize, timed_run
    syncs: dict = {}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        with counting_syncs(syncs):
            style.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() - base
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
               "ms_per_iter_steps": sum(ms for ms, _ in sc["chunks"]) / iters,
               "first_total": first, "last_total": last}
        rows.append(row)
        print("scale", json.dumps(row))
    between = [b["steps"][0] - a["steps"][1] for a, b in zip(scales, scales[1:])]
    print(f"main path: peak {peak} B, host s between scales {json.dumps(between)}, "
          f"synchronising calls {syncs['total']} ({json.dumps(syncs['by_line'])})")
    results["main_path"] = {"wall_s": wall, "launches": counts, "scales": rows, "argv": argv, "peak_bytes": peak,
                            "between_scales_s": between, "syncs": syncs}
    return counts


@contextlib.contextmanager
def counting_syncs(into: dict):
    """While inside, ``torch.cuda.set_sync_debug_mode("warn")``; on exit
    ``into`` holds the synchronising calls it flagged: ``total``, and
    ``by_line``, the count by the Python line that made each (this
    script's own synchronisations are not flagged: they wait on the whole
    device)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield into
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lines = collections.Counter(f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    into.update(total=sum(lines.values()), by_line=dict(lines.most_common()))


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


def first_pass_chunks(size: int, args, shares: int = 1) -> list[int]:
    """The stacked first pass's chunk sizes for the clip's frames at
    ``size``: the frame loop's rule (the capacity model's batch times the
    mesh's ``shares`` on "frames", each chunk rounded down to a power of
    two)."""
    from maua_style_tpu_torch.pipelines.frame_loop import _auto_frame_batch

    batch, left, chunks = _auto_frame_batch(vid_hw(size), 0, args) * shares, VID_FRAMES, []
    while left:
        chunks.append(1 << (min(batch, left).bit_length() - 1))
        left -= chunks[-1]
    return chunks


def band_style_shapes(h: int, w: int, bands: int, tensor: int = 1) -> set[tuple[int, int]]:
    """(C, N) of each band's VGG-19 style layers for an h x w frame cut
    into ``bands`` row bands (``parallel/spatial.py``; the whole frame's
    for one band), and on a "tensor" axis of ``tensor`` (C_t, N) of each
    band's channel shares (``parallel.channel_shares``)."""
    from maua_style_tpu_torch.parallel import channel_shares, spatial

    heights = spatial.band_rows(h, bands, 16)
    spec = vgg19_spec()
    out = set()
    for c, layer in VGG_STYLE:
        width = spatial.level_heights([w], spec, layer)[0]
        out |= {(ch.stop - ch.start, hb * width) for hb in spatial.level_heights(heights, spec, layer)
                for ch in channel_shares(c, tensor)}
    return out


def vid_gram_inputs(args, sizes, passes: int, bands: int = 1, shares: int = 1,
                    tensor: int = 1) -> set[tuple[int, int, int]]:
    """The (B, C, N) inputs K1 gets on a vid_img run: each scale's style
    capture (the 768² style scaled to the frame's area), the stacked first
    pass's chunks at the first scale (split into ``shares`` where the
    "frames" axis divides a chunk), and the per-frame later passes, each of
    ``bands`` row bands on a "space" mesh and of ``tensor`` channel shares
    on a "tensor" axis (the diagonal blocks, (B, C_t, N))."""
    import math

    from maua_style_tpu_torch.ops.resize import scale_shape

    out = set()
    for si, size in enumerate(sizes):
        h, w = vid_hw(size)
        factor = math.sqrt(h * w / (VID_STYLE_SIDE * VID_STYLE_SIDE))
        out |= {(1, c, n) for c, n in hw_style_shapes(*scale_shape((VID_STYLE_SIDE, VID_STYLE_SIDE), factor))}
        frame = band_style_shapes(h, w, bands, tensor)
        if si == 0:
            chunks = {b // shares if b % shares == 0 else b for b in first_pass_chunks(size, args, shares)}
            out |= {(b, c, n) for b in chunks for c, n in frame}
        if si > 0 or passes > 1:
            out |= {(1, c, n) for c, n in frame}
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
             iters=VID_ITERS, passes: int = VID_PASSES, gpu: str = "0", mesh: str | None = None) -> list[str]:
    return [
        "--transfer_type", "vid_img", "--content", v_path, "--style", s_path, "--output_dir", run_dir,
        "--flow_models", flow_models, "--image_sizes", ",".join(map(str, sizes)),
        "--num_iters", ",".join(map(str, iters)), "--passes_per_scale", str(passes),
        "--init", "random", "--model_file", "vgg19", "--allow_random_weights", "--precision", "highest",
        "--compute_dtype", "float32", "--seed", "0", "--gpu", gpu, "--verbose", *(["--mesh", mesh] if mesh else []),
    ]


def run_vid_img(results: dict, key: str = "vid_img", flow_models: str = "spynet,pwc", sizes=VID_SIZES,
                iters=VID_ITERS, passes: int = VID_PASSES, gpu: str = "0", mesh: str | None = None) -> dict[str, int]:
    """``style.main --transfer_type vid_img`` on the 8-frame 1024x576 clip
    (phase 5 with SPyNet + PWC, the UnFlow + LiteFlowNet phase, and phase
    6j's runs with ``--gpu`` and ``--mesh``), its artifacts, finite flows
    and losses, both kernels' launches against the schedule's formula, the
    wall and the peak memory.  The run's files stay in OUT/``key``."""
    import numpy as np
    import torch
    from PIL import Image

    from maua_style_tpu_torch import config, style
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.io.flo import read_flo
    from maua_style_tpu_torch.ops import gram as G
    from maua_style_tpu_torch.pipelines import flow_prepass, frame_loop

    run_dir = os.path.join(OUT, key)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    v_path, s_path = write_video(run_dir)
    argv = vid_argv(v_path, s_path, run_dir, flow_models, sizes, iters, passes, gpu, mesh)
    axes = dict(config.parse_mesh(mesh))
    bands, shares, tensor = axes.get("space", 1), axes.get("frames", 1), axes.get("tensor", 1)

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

    with patched((StyleEngine, "optimize_frame", timed_frame), (StyleEngine, "optimize_frames", timed_chunk),
                 (flow_prepass, "_compute_flow_pairs", timed_pairs), (G._GramFn, "apply", gram_inputs_into(seen))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        style.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() - base

    # K1: one style capture per scale (one style image, 5 layers); 5 Grams
    # per band per channel share per iteration of each share of each chunk
    # of the first scale's stacked first pass (a chunk the "frames" axis
    # does not divide is one share), and of every frame of every other pass
    cap_args = vid_capacity_args()
    first_chunks = first_pass_chunks(sizes[0], cap_args, shares)
    per_frame = [it // passes for it in iters]
    pieces = bands * tensor
    want_gram = sum(5 + 5 * pieces * VID_FRAMES * passes * it for it in per_frame)
    want_gram -= 5 * pieces * per_frame[0] * sum(c - (shares if c % shares == 0 else 1) for c in first_chunks)
    for size in sizes:
        hw = vid_hw(size)
        print(f"{key} chunks at {size} ({hw[0]}x{hw[1]}): stacked first pass {first_pass_chunks(size, cap_args, shares)}"
              f", chained {frame_loop._auto_chain_k(hw, cap_args)}")
    if [c["frames"] for c in chunks] != first_chunks:
        fail(f"{key}: first-pass chunks {[c['frames'] for c in chunks]} != the frame loop's rule {first_chunks}")
    checked = vid_gram_inputs(cap_args, sizes, passes, bands, shares, tensor)
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
    summary = {"wall_s": wall, "peak_bytes": peak, "launches": counts, "first_pass_chunks": chunks,
               "prepass_wall_s": pre["wall_s"],
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


def img_vid_expected_launches(sizes=IV_SIZES, shares: int = 1, bands: int = 1, tensor: int = 1) -> tuple[int, int]:
    """K1 launches of an img_vid CLI run, from the code's schedule, and the
    Grams' off-diagonal products (plain ``torch.matmul``, not K1): each
    scale runs ceil(T / gfw) + 1 windows (engine/windows.py); each window
    first captures its targets, whole on the first device, from an
    --avg_frame_window-frame stretch of the style video, max(afw - gfw +
    1, 1) style windows of 5 static and 5 whole-window Grams each, then
    runs its iterations: on each band of each share's channel share 5
    static Grams and 5 diagonal blocks of the whole-window Gram (a window
    holds gfw frames, as the target), and a band's 5 products for each
    pair of groups (share × channel share) of the whole-window Gram and,
    on "tensor", for each pair of channel shares of each share's static
    Grams."""
    import math

    gram = products = 0
    groups = shares * tensor
    for gfw, it in zip(IV_GFW, IV_ITERS[: len(sizes)]):
        windows = math.ceil(IV_FRAMES / gfw) + 1
        gram += windows * (10 * max(IV_AFW - gfw + 1, 1) + 10 * bands * groups * it)
        products += windows * it * 5 * bands * (groups * (groups - 1) // 2 + shares * tensor * (tensor - 1) // 2)
    return gram, products


def run_img_vid(results: dict, key: str = "img_vid", gpu: str = "0", mesh: str | None = None,
                sizes=IV_SIZES) -> dict[str, int]:
    """``style.main --transfer_type img_vid`` with the defaults' window
    structure (gfw 18,9,7, afw 18, video_style_factor 100, temporal blend
    0.5, L-BFGS history 100), VGG-19 f32 --precision highest, --init random,
    cut to 24 frames, ``sizes`` (256/512/724) and 4 iterations a window; on
    ``--gpu`` and ``--mesh`` (phase 6k).  Checks the stacks, finite outputs
    and loss logs, a non-zero dynamic term at every scale, K1's inputs
    against phase 2's, K1's launches and the off-diagonal products against
    the schedule's formula; records s per window, the wall and the peak
    memory."""
    import numpy as np
    import scipy.ndimage
    import torch

    from maua_style_tpu_torch import config, style
    from maua_style_tpu_torch import io as mio
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.engine import optimize as engine_optimize
    from maua_style_tpu_torch.ops import gram as G
    from maua_style_tpu_torch.parallel import spatial
    from maua_style_tpu_torch.pipelines import img_vid as img_vid_pipeline

    run_dir = os.path.join(OUT, key)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    c_path, s_path = write_img_vid_inputs(run_dir)
    n = len(sizes)
    argv = [
        "--transfer_type", "img_vid", "--content", c_path, "--style", s_path, "--output_dir", run_dir,
        "--image_sizes", ",".join(map(str, sizes)), "--num_iters", ",".join(map(str, IV_ITERS[:n])),
        "--num_frames", str(IV_FRAMES), "--gram_frame_window", ",".join(map(str, IV_GFW[:n])),
        "--avg_frame_window", str(IV_AFW), "--video_style_factor", "100", "--temporal_blend", "0.5",
        "--optimizer", "lbfgs", "--lbfgs_num_correction", "100", "--init", "random", "--model_file", "vgg19",
        "--allow_random_weights", "--precision", "highest", "--compute_dtype", "float32", "--seed", "0", "--gpu", gpu,
        *(["--mesh", mesh] if mesh else []),
    ]
    axes = dict(config.parse_mesh(mesh))
    bands, shares, tensor = axes.get("space", 1), axes.get("frames", 1), axes.get("tensor", 1)
    scales = []
    seen = set()  # the (B, C, N) inputs K1 got
    products = [0]  # the whole-window Gram's off-diagonal blocks computed
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
        cur.pop("whole_dynamic", None)
        scales.append({"hw": list(np.shape(init)[1:3]), "frames": int(np.shape(init)[0]), "iters": num_iters,
                       "gfw": kw.get("gram_frame_window"), "wall_s": wall_s, "log": self.last_loss_log,
                       "mesh": self.mesh.axes if self.mesh else None,
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

    def whole_targets(fn, self, targets, layout):
        # the window's whole dynamic targets, for the probe on a mesh
        cur.setdefault("whole_dynamic", targets.get("style_video", {}))
        return fn(self, targets, layout)

    def dynamic_probe(fn, pastiche, acts, targets, cfg, scale=None, *rest):
        # a copy of the scale's first activations (gathered from the
        # shares' pieces on a mesh: channel shares of row bands) and
        # dynamic targets, for timed_optimize to read the dynamic term from
        if "probe" not in cur:
            if isinstance(pastiche, list):
                vt, dev = cur.get("whole_dynamic", {}), pastiche[0][0].device
                whole = {l: torch.cat([torch.cat([torch.cat([b.to(dev) for b in col], dim=2)
                                                  for col in spatial.columns(a[l], tensor)], dim=1) for a in acts])
                         for l in vt}
            else:
                vt, whole = targets.get("style_video", {}), acts
            if vt:
                cur["probe"] = {l: (whole[l].detach().float().clone(), t) for l, t in vt.items()}
        return fn(pastiche, acts, targets, cfg, scale, *rest)

    def counted(fn, a, b):
        products[0] += 1
        return fn(a, b)

    host = {}  # the pipeline's host steps, seconds
    with patched((StyleEngine, "optimize", timed_optimize), (StyleEngine, "_run", timed_run),
                 (StyleEngine, "style_video_targets", timed_capture), (StyleEngine, "_share_targets", whole_targets),
                 (engine_optimize, "evaluate_losses", dynamic_probe),
                 (engine_optimize, "evaluate_window_losses", dynamic_probe),
                 (G._GramFn, "apply", gram_inputs_into(seen)), (G, "_cross_block", counted),
                 *((obj, name, seconds_into(host, name)) for obj, name in (
                     (scipy.ndimage, "gaussian_filter"), (img_vid_pipeline, "match_histogram"),
                     (img_vid_pipeline, "resize_bilinear_np"), (mio, "save_tensor_to_file"),
                     (mio, "process_style_videos"), (img_vid_pipeline, "build_engine")))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        style.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() - base

    want, want_products = img_vid_expected_launches(sizes, shares, bands, tensor)
    print(f"{key} path: {wall:.1f} s, launches {counts} (expected gram {want}, correlation 0), off-diagonal products "
          f"{products[0]} (expected {want_products})")
    if counts != {"gram": want, "correlation": 0} or products[0] != want_products:
        fail(f"{key} launches {counts}, products {products[0]} != gram {want}, correlation 0, products {want_products}")
    checked = img_vid_run_gram_inputs(sizes, IV_GFW, shares, bands, tensor)
    if seen != checked:
        fail(f"{key}'s Gram inputs {sorted(seen)} != phase 2's {sorted(checked)}")
    if len(scales) != n:
        fail(f"{key}: {len(scales)} scales optimised, expected {n}")

    stem = os.path.join(run_dir, "content_stylevid")
    rows = []
    for size, gfw, it, sc in zip(sizes, IV_GFW, IV_ITERS, scales):
        hw = iv_hw(size)
        n_windows = -(-IV_FRAMES // gfw) + 1
        log = sc["log"]
        if tuple(sc["hw"]) != hw or sc["frames"] != IV_FRAMES or sc["gfw"] != gfw or not sc["out_finite"]:
            fail(f"{key} scale {size}: engine saw {sc['frames']} frames of {sc['hw']} at gfw {sc['gfw']} "
                 f"(expected {hw}, {gfw})")
        if (sc["mesh"] or ()) != tuple(config.parse_mesh(mesh) if mesh else ()):
            fail(f"{key} scale {size}: the engine's mesh {sc['mesh']} is not --mesh {mesh}")
        if log is None or log.shape[0] != n_windows * it or not np.isfinite(log).all():
            fail(f"{key} scale {size}: loss log {None if log is None else log.shape} not finite / wrong length")
        dyn = sc["dynamic"]
        if len(dyn) != 5 or not all(v is not None and np.isfinite(v) and v > 0 for v in dyn.values()):
            fail(f"{key} scale {size}: dynamic term {dyn} not non-zero and finite at every style layer")
        for art in (f"{stem}_{size}",) + ((stem,) if size == sizes[-1] else ()):
            arr = np.load(art + ".npy") if os.path.exists(art + ".npy") else None
            if not os.path.exists(art + ".mp4") and (arr is None or arr.shape != (IV_FRAMES, *hw, 3)):
                fail(f"{art}: no .mp4 and no ({IV_FRAMES}, {hw}, 3) .npy stack ({None if arr is None else arr.shape})")
        run_s = sum(ms for ms, _, _ in sc["run_ms"]) / 1e3
        row = {"size": size, "hw": list(hw), "gfw": gfw, "windows": n_windows, "iters_per_window": it,
               "wall_s": sc["wall_s"], "capture_s": sc["capture_s"], "iterations_s": run_s,
               "s_per_window": run_s / n_windows, "ms_per_iter": run_s * 1e3 / (n_windows * it),
               "ms_per_iter_window0": sc["run_ms"][0][0] / sc["run_ms"][0][1],
               "frozen": [f for _, _, f in sc["run_ms"]], "dynamic_mse_first_iter": dyn,
               "first_total": float(log[0].sum()), "last_total": float(log[-1].sum())}
        rows.append(row)
        print(key, json.dumps(row))
    summary = {"wall_s": wall, "peak_bytes": peak, "launches": counts, "expected_gram": want,
               "off_diagonal_products": products[0], "optimize_s": sum(r["wall_s"] for r in rows),
               "capture_s": sum(r["capture_s"] for r in rows), "host_s": wall - sum(r["wall_s"] for r in rows),
               "host_steps_s": host, "scales": rows, "argv": argv}
    print(f"{key} summary", json.dumps({k: v for k, v in summary.items() if k not in ("scales", "argv")}))
    results[key] = summary
    shutil.rmtree(run_dir)  # the stacks and frames, checked above
    return counts


def profile_img_vid_window(results: dict) -> None:
    """torch.profiler over 3 iterations of img_vid's first window (all gfw
    frames move, L-BFGS history 100, f32, TF32 off) at the 256 and the 724
    scale of the phase's run, after a warm-up window; the style targets
    come from the style video's first gfw frames.  Report only: the split
    of the device time between the convolutions, K1, the whole-window
    Gram's backward and the elementwise passes over its matrices."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.losses import LossConfig
    from maua_style_tpu_torch.models import init_params, select_model

    spec = select_model("vgg19")
    eng = StyleEngine(spec, init_params(spec), LossConfig(video_style_factor=100.0), device="cuda",
                      precision="highest", lbfgs_history=100)
    rng = np.random.default_rng(5)
    out = {}
    for size, gfw in ((IV_SIZES[0], IV_GFW[0]), (IV_SIZES[-1], IV_GFW[-1])):
        hw, shw = iv_hw(size), iv_style_hw(size)
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


class GradRecorder:
    """An optimiser that hands ``update`` to ``opt`` and keeps the gradient
    it was given."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state):
        self.grads = grads
        return self.opt.update(grads, state)


def off_diagonal_ms(hw, t_w: int, shares: int, bands: int, tensor: int = 1) -> float:
    """Device ms of one iteration's off-diagonal Gram blocks of a
    ``t_w``-frame window of hw frames on a mesh of ``shares`` rows of
    ``bands`` bands and ``tensor`` channel shares: at each style layer and
    each band, for each pair of groups (share × channel share) the product
    F_iF_kᵀ of the whole-window Gram, and on "tensor" for each share and
    pair of channel shares the batched product of its static Grams, each
    forward and its gradient to both operands (``ops.gram._cross_block``
    under autograd), on random activations of the band's shapes; CUDA
    events, median of 7."""
    import torch

    from maua_style_tpu_torch.ops import gram as G
    from maua_style_tpu_torch.parallel import channel_shares, spatial

    per, extra = divmod(t_w, shares)
    frames = [per + (i < extra) for i in range(shares)]
    heights = spatial.band_rows(hw[0], bands, 16) if bands > 1 else [hw[0]]
    gen = torch.Generator(device="cuda").manual_seed(9)
    spec = vgg19_spec()
    total = 0.0

    def timed(a_shape, b_shape):
        a = torch.randn(a_shape, device="cuda", generator=gen).requires_grad_(True)
        b = torch.randn(b_shape, device="cuda", generator=gen).requires_grad_(True)
        g = torch.randn((*a_shape[:-1], b_shape[-2]), device="cuda", generator=gen)
        return time_ms(lambda: torch.autograd.grad(G._cross_block(a, b), (a, b), g))

    for c, layer in VGG_STYLE:
        width = spatial.level_heights([hw[1]], spec, layer)[0]
        chs = [ch.stop - ch.start for ch in channel_shares(c, tensor)]
        groups = [t * ch for t in frames for ch in chs if ch]
        for hb in spatial.level_heights(heights, spec, layer):
            n = hb * width
            total += sum(timed((groups[i], n), (groups[k], n)) for i in range(len(groups))
                         for k in range(i + 1, len(groups)))
            total += sum(timed((t, chs[i], n), (t, chs[k], n)) for t in frames for i in range(len(chs))
                         for k in range(i + 1, len(chs)) if chs[k])
    return total


def window_grad(layout, grads: list, dev):
    """The gradient the optimiser got on a window's moving pieces as one
    (T_moving, 3, H, W) tensor: each share's pieces (its channel shares'
    row bands) gathered, the shares in window order."""
    import torch

    from maua_style_tpu_torch.parallel import spatial

    n = len(layout.heights) * layout.tensor
    return torch.cat([spatial.gather_pieces(grads[i : i + n], layout.heights, layout.tensor, dev, 3, layout.width)
                      for i in range(0, len(grads), n)])


def check_img_vid_window_parity(results: dict, meshes=IV_PARITY_MESHES, key: str = "img_vid_mesh",
                                witnessed: bool = False) -> dict:
    """One img_vid window at 724 (7 frames of 407x724, gfw 7, VGG-19 f32,
    the default layers, video_style_factor 100, L-BFGS history 100, TF32
    off, ``cudnn.deterministic``) unsharded and on each of ``meshes`` (6k:
    space:2, frames:2 and frames:2,space:2; 6p: tensor:2 and
    frames:2,tensor:2) of ``[cuda:0] * n``, each engine capturing its own
    targets (the content band by band, the style video's whole and then
    copied to the rows), from one 0.001·N(0, 1) init, at w = 0 (every frame
    moves) and under w = 1's frozen split (the first 3 and the last frame
    frozen: one frame of the first share moves, two of the second):

    - one step: every loss term within rtol 1e-5 and the gradient the
      optimiser gets within 1e-4 of its max;
    - 4 iterations at lr 0.1 (6h's and 6j's): the first two totals within
      rtol 1e-5, mean|Δ| within 1e-2 of mean|p|; ms per iteration and
      the peak memory;
    - w = 0 at the CLI's lr 1: the first two totals within rtol 1e-5 and
      mean|Δ| within twice the unsharded run's own from the init moved one
      f32 spacing up (the witness; at least 1e-2), as 6j holds warp_prev.
      At lr 1 L-BFGS's first curvature pair is set by the gradients'
      rounding, so 4 iterations carry a 1e-6 gradient difference to ≈ 1%
      of mean|p| (2.6% for the witness on an H100; PERF.md);

    with K1's inputs among phase 2's.  Then the off-diagonal blocks' device
    ms an iteration (``off_diagonal_ms``) and their share of the window's
    ms per iteration, on the meshes with several groups (on one card the
    copies of F_k are no-ops).

    ``witnessed`` (6p, "tensor"): a share's convolution sums its channels
    in another order (``run_tensor``), so the unsharded step is repeated
    from the eight inits one f32 spacing off (``TENSOR_NUDGES``) at w = 0
    and w = 1, and the meshes' gradient is held to twice its furthest (at
    least 1e-4); the terms and the first two totals within rtol 1e-5, every
    total within rtol 1e-4 and mean|Δ| within 1e-2 of mean|p| (from this
    init the 4 iterations do not follow the rounding: eight nudged runs
    gave every total bit for bit on an H100); no lr 1 runs.  The
    off-diagonal products an iteration are counted on each mesh."""
    import numpy as np
    import torch

    from maua_style_tpu_torch import config
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.engine.optimize import to_nchw
    from maua_style_tpu_torch.losses import LossConfig
    from maua_style_tpu_torch.models import init_params, select_model
    from maua_style_tpu_torch.ops import gram as G
    from maua_style_tpu_torch.parallel import build_mesh

    dev = torch.device("cuda", 0)
    spec = select_model("vgg19")
    params = init_params(spec, seed=0)
    t_w, (fo, eo) = IV_PARITY_GFW, IV_PARITY_FROZEN
    hw, shw = iv_hw(IV_PARITY_SIZE), iv_style_hw(IV_PARITY_SIZE)
    rng = np.random.default_rng(11)
    content = rng.normal(0, 50, (1, *hw, 3)).astype(np.float32)
    video = rng.normal(0, 50, (t_w, *shw, 3)).astype(np.float32)
    init = rng.normal(0, 0.001, (t_w, *hw, 3)).astype(np.float32)
    layouts = [("unsharded", [])] + [(name, config.parse_mesh(mesh)) for name, mesh in meshes]
    seen: set = set()
    runs = {}  # (layout, w, lr, witness) -> readings
    products = {}  # off-diagonal products in one iteration, by layout
    torch.backends.cudnn.deterministic = True
    try:
        for name, axes in layouts:
            n = int(np.prod([s for _, s in axes])) if axes else 1
            engine = StyleEngine(spec, params, LossConfig(video_style_factor=100.0), lbfgs_history=100,
                                 precision="highest", device=dev, mesh=build_mesh([dev] * n, axes) if axes else None)
            with patched((G._GramFn, "apply", gram_inputs_into(seen))):
                targets = {"content": engine.content_targets(content)}
                engine._set_style_video_targets(targets, [video], [1.0], t_w)
                layout = engine._window_layout(t_w, hw)
                run_targets = engine._share_targets(targets, layout) if layout else targets
                if witnessed:
                    cases = [(w, frozen, IV_PARITY_LR, nudge_by) for w, frozen in (("w0", None), ("w1", IV_PARITY_FROZEN))
                             for nudge_by in ((None,) if axes else (None, *TENSOR_NUDGES))]
                else:
                    cases = [("w0", None, IV_PARITY_LR, None), ("w1", IV_PARITY_FROZEN, IV_PARITY_LR, None),
                             ("w0", None, IV_CLI_LR, None)] + ([("w0", None, IV_CLI_LR, ("flat", 1))] if not axes else [])
                for w, frozen, lr, witness in cases:
                    p = to_nchw(init, dev)
                    if witness:
                        p = nudge(p, *witness)
                    pieces = layout.split(p) if layout else p
                    moving = layout.moving(pieces, frozen) if layout else p if frozen is None else p[fo : t_w - eo]
                    engine.learning_rate = lr
                    row = {}
                    if lr == IV_PARITY_LR:  # one step: the terms and the gradient the optimiser gets
                        rec = GradRecorder(engine._make_optimizer())
                        count = [0]
                        with patched((G, "_cross_block", lambda fn, a, b: count.__setitem__(0, count[0] + 1) or fn(a, b))):
                            _, _, log1 = engine._run(pieces, rec, rec.init(moving), run_targets, {}, 1, frozen=frozen,
                                                     window=layout)
                        products.setdefault(name, count[0])
                        row.update(terms=log1[0].cpu().numpy(), grad=(window_grad(layout, rec.grads, dev) if layout
                                                                      else rec.grads).detach())
                    if witnessed and witness:  # the gradient's witness: one step
                        runs[(name, w, lr, witness)] = row
                        continue
                    opt = engine._make_optimizer()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    t0 = time.perf_counter()
                    q, _, log = engine._run(pieces, opt, opt.init(moving), run_targets, {}, IV_PARITY_ITERS,
                                            frozen=frozen, window=layout)
                    torch.cuda.synchronize()
                    row.update(log=log.cpu().numpy(), p=layout.gather(q, dev) if layout else q,
                               ms_per_iter=(time.perf_counter() - t0) * 1e3 / IV_PARITY_ITERS,
                               peak_bytes=torch.cuda.max_memory_allocated() - base)
                    runs[(name, w, lr, witness)] = row
            del engine, run_targets, targets
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False

    def apart(r, ref):
        tot, tot_ref = r["log"].sum(axis=1), ref["log"].sum(axis=1)
        d = (r["p"] - ref["p"]).abs()
        row = {"first_two_rtol": float(np.max(np.abs(tot[:2] - tot_ref[:2]) / np.abs(tot_ref[:2]))),
               "log_rtol": float(np.max(np.abs(tot - tot_ref) / np.abs(tot_ref))),
               "mean_abs_rel_pastiche": float(d.mean() / ref["p"].abs().mean()), "max_abs_pastiche": float(d.max()),
               "finite": bool(np.isfinite(r["log"]).all()), "ms_per_iter": r["ms_per_iter"],
               "peak_bytes": r["peak_bytes"]}
        if "terms" in r:
            row["terms_rtol"] = float(np.max(np.abs(r["terms"] - ref["terms"]) / np.maximum(np.abs(ref["terms"]), 1e-30)))
            row["grad_rel"] = float((r["grad"] - ref["grad"]).abs().max() / ref["grad"].abs().max())
        return row

    out = {"hw": list(hw), "frames": t_w, "iters": IV_PARITY_ITERS, "frozen_w1": list(IV_PARITY_FROZEN),
           "lr": IV_PARITY_LR, "off_diagonal_products_per_iter": products}
    for w in ("w0", "w1"):
        ref = runs[("unsharded", w, IV_PARITY_LR, None)]
        out[w] = {"unsharded": {"ms_per_iter": ref["ms_per_iter"], "peak_bytes": ref["peak_bytes"],
                                "terms": ref["terms"].tolist()},
                  **{name: apart(runs[(name, w, IV_PARITY_LR, None)], ref) for name, _ in layouts[1:]}}
        out[w]["bars"] = {"grad_rel": 1e-4, "log_rtol": None, "mean_abs_rel_pastiche": 1e-2}
        if witnessed:  # the unsharded step's gradient from its eight inits one f32 spacing off
            wit = {f"ulp_{kind}_{'up' if sign > 0 else 'down'}":
                   float((runs[("unsharded", w, IV_PARITY_LR, (kind, sign))]["grad"] - ref["grad"]).abs().max()
                         / ref["grad"].abs().max())
                   for kind, sign in TENSOR_NUDGES}
            out[w]["witness_one_ulp_off_grad_rel"] = wit
            out[w]["bars"] = {"grad_rel": max(1e-4, 2 * max(wit.values())), "log_rtol": 1e-4,
                              "mean_abs_rel_pastiche": 1e-2}
    if not witnessed:
        ref = runs[("unsharded", "w0", IV_CLI_LR, None)]
        witness = apart(runs[("unsharded", "w0", IV_CLI_LR, ("flat", 1))], ref)
        out["lr1_w0"] = {"witness_one_ulp_up": witness,
                         "mean_abs_rel_bar": max(1e-2, 2 * witness["mean_abs_rel_pastiche"]),
                         **{name: apart(runs[(name, "w0", IV_CLI_LR, None)], ref) for name, _ in layouts[1:]}}
    for name, mesh in meshes:
        axes = dict(config.parse_mesh(mesh))
        if axes.get("frames", 1) * axes.get("tensor", 1) > 1:
            ms = off_diagonal_ms(hw, t_w, axes.get("frames", 1), axes.get("space", 1), axes.get("tensor", 1))
            out[f"off_diagonal_{name}"] = {"ms_per_iter": ms, "share_of_window_iter": ms / out["w0"][name]["ms_per_iter"]}
    print(f"{key}: one 724 window on meshes of one card against unsharded:", json.dumps(out))
    for w in ("w0", "w1"):
        if min(out[w]["unsharded"]["terms"][:-1]) <= 0:  # content, style and TV; the temporal term has no target
            fail(f"{key} {w}: a loss term is zero: {out[w]['unsharded']['terms']}")
        bars = out[w]["bars"]
        for name, _ in layouts[1:]:
            row = out[w][name]
            if not (row["finite"] and row["terms_rtol"] <= 1e-5 and row["grad_rel"] <= bars["grad_rel"]
                    and row["first_two_rtol"] <= 1e-5 and row["mean_abs_rel_pastiche"] <= bars["mean_abs_rel_pastiche"]
                    and (bars["log_rtol"] is None or row["log_rtol"] <= bars["log_rtol"])):
                fail(f"{key}: the 724 window ({w}) on {name} against unsharded: {row} (bars {bars})")
    if not witnessed:
        lr1 = out["lr1_w0"]
        for name, _ in layouts[1:]:
            row = lr1[name]
            if not (row["finite"] and row["first_two_rtol"] <= 1e-5
                    and row["mean_abs_rel_pastiche"] <= lr1["mean_abs_rel_bar"]):
                fail(f"{key}: the 724 window at lr 1 on {name} against unsharded: {row} (bar {lr1['mean_abs_rel_bar']})")
    checked = img_vid_run_gram_inputs(IV_SIZES, IV_GFW) | img_vid_mesh_gram_inputs() | img_vid_tensor_gram_inputs()
    if seen - checked:
        fail(f"{key} parity's Gram inputs {sorted(seen - checked)} not among phase 2's")
    return out


def run_img_vid_mesh(results: dict) -> dict[str, dict]:
    """Phase 6k, img_vid on meshes of one card standing in for several:
    phase 6's CLI run (``run_img_vid``: every stack, finite outputs and
    loss logs, a non-zero dynamic term at every scale, K1's inputs and
    launches, 10 per band per share per iteration plus captures, and the
    off-diagonal products, 5 per band per pair of shares an iteration)
    with ``--gpu 0,0 --mesh space:2`` and with ``--gpu 0,0,0,0 --mesh
    frames:2,space:2`` at its first two scales (256 and 512), each beside
    phase 6's unsharded run (s per window, wall s, peak memory); between
    them ``check_img_vid_window_parity``.  Returns each CLI run's
    launches."""
    counts, summary = {}, {}
    sizes = IV_SIZES[:IV_MESH_SCALES]
    for i, (key, gpu, mesh) in enumerate(IV_MESH):
        counts[f"img_vid_{key}"] = run_img_vid(results, f"img_vid_{key}", gpu, mesh, sizes)
        if i == 0:
            summary["window_parity"] = check_img_vid_window_parity(results)
    beside = {}
    for name in ("img_vid", *(f"img_vid_{key}" for key, _, _ in IV_MESH)):
        if name not in results:  # phase 6 not run (this phase called alone)
            continue
        r = results[name]
        beside[name] = {"wall_s": r["wall_s"], "peak_bytes": r["peak_bytes"], "launches": r["launches"],
                        "off_diagonal_products": r["off_diagonal_products"],
                        "by_scale": [{k: row[k] for k in ("size", "wall_s", "s_per_window", "ms_per_iter")}
                                     for row in r["scales"][:IV_MESH_SCALES]]}
    summary["beside_unsharded"] = beside
    mesh = results.get("img_vid_frames2_space2")
    if mesh is not None:  # the off-diagonal blocks' share of the CLI's windows, at each scale
        summary["off_diagonal_cli"] = []
        for row in mesh["scales"]:
            ms = off_diagonal_ms(iv_hw(row["size"]), row["gfw"], 2, 2)
            summary["off_diagonal_cli"].append({"size": row["size"], "ms_per_iter": ms,
                                                "share_of_window_iter": ms / row["ms_per_iter"]})
    print("img_vid_mesh: the CLI runs beside phase 6's unsharded run", json.dumps(summary["beside_unsharded"]),
          json.dumps(summary.get("off_diagonal_cli")))
    results["img_vid_mesh"] = summary
    return counts


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
    512², 1024² and 2048² (``measure_step``: what tensors took and what the
    allocator reserved), each beside ``estimate_step_bytes`` with the
    module's constants and its relative error, and the constants
    ``fit_constants`` fits to these peaks with their own error; then
    ``probe_max_sizes`` for VGG-19 (L-BFGS and Adam, f32, the budget the
    card's free memory at the search's start less the allocator's reserve,
    ``search_budget_bytes``), written to OUT, with its probes (each one's
    reserved and allocated peaks and seconds) and each search's probes and
    seconds; the estimate's VGG-19 tables at 2, 4 and 8 devices, and the
    measured 2-device probe where two cards are visible;
    the size it calls safe for L-BFGS run as one img_img scale (the style
    CLI, 2 iterations) in this same process, beside the fresh-process
    table's; ``hbm_bytes()`` and the frame sizing at 1024x576 and 512x288.
    Fails if the scale runs out of memory, or if
    ``torch.cuda.memory_allocated()`` does not come back to its start (read
    after a warm-up probe: a process's first cuBLAS call keeps its
    workspace, 64 MiB on the card, for the process's life)."""
    import torch

    from maua_style_tpu_torch.tuning import max_sizes as ms

    ms.measure_step_bytes("vgg19", "adam", 64)  # warm-up: the process's cuBLAS and cuDNN workspaces
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    # what the earlier phases left: unused blocks of segments that live tensors hold a part of (the probes
    # reuse them, the search's budget, the device's free memory, leaves them out)
    kept = {"unused_bytes": release_cached(), "segments": sorted(
        ({"total": seg["total_size"], "allocated": seg["allocated_size"],
          "live_blocks": sorted((b["size"] for b in seg["blocks"] if b["state"] == "active_allocated"), reverse=True)[:4]}
         for seg in torch.cuda.memory_snapshot() if seg["allocated_size"] < seg["total_size"]),
        key=lambda r: r["allocated"] - r["total"])[:8]}
    print("tuner: the allocator's kept segments at the start", json.dumps(kept))
    cases = [("vgg19", opt, method, dtype) for dtype in ("float32", "bfloat16")
             for opt, method in (("lbfgs", "compact"), ("lbfgs", "two_loop"), ("adam", "compact"))]
    rows = []
    for model, opt, method, dtype in [*cases, ("prune", "adam", "compact", "float32")]:
        for size in TUNER_SIZES:
            t0 = time.perf_counter()
            probe = ms.measure_step(model, opt, size, compute_dtype=dtype, lbfgs_method=method)
            if probe is None:
                fail(f"tuner: {model} {opt} {dtype} at {size}² ran out of memory")
            got = probe["allocated"]
            est = ms.estimate_step_bytes(model, opt, size, lbfgs_method=method, compute_dtype=dtype)
            row = {"model": model, "optimizer": opt, "method": method, "dtype": dtype, "size": size, "measured": got,
                   "reserved": probe["reserved"], "free_before": probe["free"],
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
        t0, retries = time.perf_counter(), torch.cuda.memory_stats().get("num_alloc_retries", 0)
        got = fn(*a, **kw)
        # the caching allocator's retries: a cudaMalloc that failed, the cached blocks handed back, and again
        probes.append({"optimizer": a[1], "size": a[2], "s": time.perf_counter() - t0,
                       "reserved": got[0] if got else None, "allocated": got[1] if got else None,
                       "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries})
        return got

    t0 = time.perf_counter()
    budget = ms.search_budget_bytes()
    with patched((ms, "measure_step_bytes", counted)):
        table = ms.probe_max_sizes(models=("vgg19",), optimizers=("lbfgs", "adam"), method="analysis",
                                   compute_dtype="float32", budget_bytes=budget)
    search = {"table": table, "probes": probes, "s": time.perf_counter() - t0, "budget_bytes": budget,
              "total_memory": torch.cuda.get_device_properties(0).total_memory,
              "by_optimizer": {opt: {"probes": sum(p["optimizer"] == opt for p in probes),
                                     "s": sum(p["s"] for p in probes if p["optimizer"] == opt)}
                               for opt in ("lbfgs", "adam")}}
    with open(os.path.join(OUT, "max-sizes-vgg19-float32.json"), "w") as f:
        json.dump(table, f, indent=2)
    print("tuner search", json.dumps(search))
    for opt, row in search["by_optimizer"].items():
        print(f"tuner search: VGG-19 f32 {opt} bracketed in {row['probes']} probes, {row['s']:.1f} s")
    # N-device tables: the estimate anywhere; the measured probe on N distinct cards only
    hbm = ms.hbm_bytes()
    search["estimate_devices"] = {
        n: {k: v["safe_max_size"] for k, v in ms.probe_max_sizes(models=("vgg19",), method="estimate", devices=n,
                                                                 budget_bytes=hbm, compute_dtype="float32",
                                                                 verbose=False).items()}
        for n in TUNER_DEVICES}
    print("tuner: estimated VGG-19 f32 safe sizes on N devices sharing each image in row bands",
          json.dumps(search["estimate_devices"]))
    if torch.cuda.device_count() >= 2:
        search["measured_devices"] = ms.probe_max_sizes(models=("vgg19",), optimizers=("adam",), method="analysis",
                                                        devices=2, compute_dtype="float32")
    else:
        search["measured_devices"] = (f"not run: {torch.cuda.device_count()} CUDA device visible (the sharded probe "
                                      "needs 2 distinct cards; one card repeated would read the sum of the bands)")
    print(f"tuner: the measured 2-device probe: {search['measured_devices']}")
    search["scale"] = run_tuner_scale(table["vgg19,lbfgs,1"]["safe_max_size"])
    sizing = {f"{h}x{w} {opt}": {"frames_per_program": ms.frames_per_program("vgg19", opt, (h, w), hbm=hbm),
                                 "chain_frames_per_program": ms.chain_frames_per_program("vgg19", opt, (h, w), hbm=hbm)}
              for h, w in ((576, 1024), (288, 512)) for opt in ("lbfgs", "adam")}
    print(f"tuner hbm_bytes() {hbm}, sizing (f32)", json.dumps(sizing))
    torch.cuda.synchronize()
    end = torch.cuda.memory_allocated()
    results["tuner"] = {"kept_at_start": kept, "peaks": rows, "constants": table_constants, "fitted": fitted, **err,
                        "search": search, "hbm_bytes": hbm, "sizing": sizing, "allocated_start": start,
                        "allocated_end": end}
    if end != start:
        fail(f"tuner: memory_allocated {end} after the probes, {start} before")


def run_tuner_scale(safe: int) -> dict:
    """One img_img scale at the search's safe size for VGG-19 f32 L-BFGS
    (history 100), in this process after every other phase: the style CLI
    at ``--image_sizes safe --num_iters 2`` on the main path's images.
    Prints the size beside the fresh-process table's; fails if it runs out
    of memory."""
    import torch

    from maua_style_tpu_torch import style
    from maua_style_tpu_torch.tuning import max_sizes as ms

    with open(os.path.join(ms.TABLE_DIR, "max-sizes-79GB-1chip.json")) as f:
        fresh = json.load(f)["vgg19,lbfgs,1"]["safe_max_size"]
    run_dir = os.path.join(OUT, "tuner_scale")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    c_path, s_path = write_inputs(run_dir)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        style.main(["--content", c_path, "--style", s_path, "--output_dir", run_dir, "--image_sizes", str(safe),
                    "--num_iters", "2", "--optimizer", "lbfgs", "--lbfgs_num_correction", "100",
                    "--precision", "highest", "--allow_random_weights", "--seed", "0", "--gpu", "0",
                    "--scaling_args", os.path.join(run_dir, "none.json")])
    except torch.cuda.OutOfMemoryError as e:
        fail(f"tuner: the safe size {safe} (VGG-19 f32 L-BFGS) ran out of memory in this process: {str(e)[:300]}")
    out = {"safe_in_process": safe, "safe_fresh_process_table": fresh, "s": time.perf_counter() - t0,
           "peak_allocated": torch.cuda.max_memory_allocated(), "peak_reserved": torch.cuda.max_memory_reserved()}
    shutil.rmtree(run_dir)
    print(f"tuner: one img_img scale at the in-process safe size {safe} (the fresh-process table: {fresh}) ran",
          json.dumps(out))
    return out


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


# the mesh phases: a space:2 img_img at 1024², a frames:2 first
# pass of phase 5's first scale, and the fidelity run
SPACE_SIDE, SPACE_ITERS, SPACE_BANDS, SPACE_LR = 1024, 10, 2, 0.1
# the tuner phase's estimate tables: devices sharing each image
TUNER_DEVICES = (2, 4, 8)
FRAMES_B, FRAMES_SIZE = 8, VID_SIZES[0]
FID_SIZES, FID_ITERS = (256, 512), (20, 10)
# the fidelity phase's runs: the CLI's lr (report only) and the gated one
FID_LRS, FID_GATE_LR = (1.0, 0.1), 0.1
# phase 6j: phase 5's vid_img CLI on meshes of one card standing in for several
MESH_VID = (("space2", "0,0", "space:2"), ("frames2_space2", "0,0,0,0", "frames:2,space:2"))
FRAME_PARITY_ITERS, FRAME_PARITY_LR = 10, 0.1
# phase 6o: vid_img on "tensor": phase 5's CLI cut to its 512 scale, optimize_frame at
# 1024x576, and optimize_frames at 512x288 on two meshes
VID_TENSOR_CLI, VID_TENSOR_SIZES, VID_TENSOR_ITERS = ("tensor2", "0,0", "tensor:2"), VID_SIZES[:1], VID_ITERS[:1]
VID_TENSOR_FRAME = ("tensor2", (("tensor", 2),))
VID_TENSOR_MESHES = (("tensor2", "tensor:2"), ("frames2_tensor2", "frames:2,tensor:2"))


def mesh_gram_shapes() -> list[tuple[int, int, int]]:
    """K1's new inputs on the mesh phases: the space phase's two bands of a
    1024² pastiche, (1, C, N/2) at each style layer, and a frames:2 half of
    the frames phase's chunk, (4, C, N) at 512x288.  Their other inputs
    (the style captures, the unsharded runs) are phase 2's 1024² shapes
    and phase 5's."""
    h, w = vid_hw(FRAMES_SIZE)
    return ([(1, c, n // SPACE_BANDS) for c, n in vgg_style_shapes(SPACE_SIDE)]
            + [(FRAMES_B // 2, c, n) for c, n in hw_style_shapes(h, w)])


def vid_mesh_gram_inputs() -> set[tuple[int, int, int]]:
    """K1's inputs on phase 6j: its two vid_img runs (the style captures,
    and each band of the stacked first pass's shares and of the per-frame
    passes), and ``optimize_frame``'s two bands of a 1024x576 frame."""
    from maua_style_tpu_torch import config

    args, out = vid_capacity_args(), set()
    for _, _, mesh in MESH_VID:
        axes = dict(config.parse_mesh(mesh))
        out |= vid_gram_inputs(args, VID_SIZES, VID_PASSES, axes.get("space", 1), axes.get("frames", 1))
    return out | {(1, c, n) for c, n in band_style_shapes(*vid_hw(VID_SIZES[-1]), 2)}


def vid_tensor_gram_inputs() -> set[tuple[int, int, int]]:
    """K1's inputs on phase 6o: its CLI run at 512 on tensor:2 (the style
    capture, the stacked chunk's and the per-frame passes' channel shares),
    ``optimize_frame`` at 1024x576 on tensor:2, (1, C_t, N), and
    ``optimize_frames``' 8 frames at 512x288 on tensor:2 and
    frames:2,tensor:2, (8, C_t, N) and (4, C_t, N)."""
    from maua_style_tpu_torch import config

    tensor = dict(config.parse_mesh(VID_TENSOR_CLI[2]))["tensor"]
    out = vid_gram_inputs(vid_capacity_args(), VID_TENSOR_SIZES, VID_PASSES, 1, 1, tensor)
    out |= {(1, c, n) for c, n in band_style_shapes(*vid_hw(VID_SIZES[-1]), 1, dict(VID_TENSOR_FRAME[1])["tensor"])}
    for _, mesh in VID_TENSOR_MESHES:
        axes = dict(config.parse_mesh(mesh))
        out |= {(FRAMES_B // axes.get("frames", 1), c, n)
                for c, n in band_style_shapes(*vid_hw(FRAMES_SIZE), axes.get("space", 1), axes.get("tensor", 1))}
    return out


def check_mesh_gram(results: dict) -> dict:
    """K1 at the mesh phases' new inputs, f32, with phase 2's bars and
    times: 6h's bands and 6i's halves, then every input of 6j's
    vid_img runs that no other phase's check holds (the bands of 512x288
    stacks of 8 and 4 frames and of one frame, and of one 1024x576 frame)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    vid_bands = sorted(vid_mesh_gram_inputs() - set(mesh_gram_shapes()) - vid_runs_gram_inputs())
    for shape in mesh_gram_shapes() + vid_bands:
        f = torch.relu(torch.randn(shape, device="cuda", generator=gen))
        row = {"shape": list(shape), "vid_band": shape in vid_bands, **measure_gram(f)}
        rows.append(row)
        print("mesh gram", json.dumps(row))
        del f
    results["gram_mesh"] = rows
    bands, vid = rows[:STYLE_LAYERS], [r for r in rows if r["vid_band"]]

    def total(rs, key):
        return sum(r[key] for r in rs)

    return {"ms": total(rows, "kernel_ms"), "plain_ms": total(rows, "plain_ms"),
            "library_ms": total(rows, "library_ms"), "bound_ms": total(rows, "bound_ms"),
            "bands_ms": total(bands, "kernel_ms"), "bands_library_ms": total(bands, "library_ms"),
            "bands_bound_ms": total(bands, "bound_ms"),
            "vid_bands_ms": total(vid, "kernel_ms"), "vid_bands_plain_ms": total(vid, "plain_ms"),
            "vid_bands_library_ms": total(vid, "library_ms"), "vid_bands_bound_ms": total(vid, "bound_ms"),
            "vid_bands_slower_than_library": [r["shape"] for r in vid if r["kernel_ms"] >= r["library_ms"]],
            "max_rel_err_f64": max(r["kernel_rel_err_f64"] for r in rows), "shapes": len(rows)}


def gram_inputs_into(seen: set):
    """A ``patched`` wrapper of ``ops.gram._GramFn.apply`` that records each
    (B, C, N) input K1 gets."""
    def wrapper(fn, f):
        seen.add(tuple(f.shape))
        return fn(f)

    return wrapper


def run_fidelity(results: dict) -> dict[str, int]:
    """``maua_style_tpu_torch.fidelity`` on the card: a 256→512 img_img at
    the CLI's settings (L-BFGS, 20 and 10 iterations, VGG-19 with seeded
    random weights, f32, TF32 off, ``cudnn.deterministic``) scored by SSIM
    against the same run on the CPU (``--gpu c``, same seed and weights),
    at ``--learning_rate 1`` (the CLI's) and at 0.1.  The gate: the phase
    fails when the lr 0.1 pair scores below the tool's 0.98 (BASELINE.md's
    bar).  The lr 1 pair's SSIM is report only: at lr 1 L-BFGS without a
    line search turns float noise into another image within a few
    iterations (it scored 0.3637 on an H100 in every run: the card's f32
    matches its own f64 within 2.6e-6 at every layer, where the CPU's f32
    flips max-pool near-ties; on the CPU alone the same run unbanded and on
    two bands, 1e-7 apart, scored 0.84 at lr 1 and 0.99958 at lr 0.1;
    PERF.md).  Prints both SSIMs, both pairs' largest relative loss-log
    difference per scale and iteration, K1's launches (5 an iteration and 5
    a style capture, each card run's) and inputs (among phase 2's); fails
    if these are off or a log is not finite.  Returns both card runs'
    launches."""
    import numpy as np
    import torch

    from maua_style_tpu_torch import fidelity, style
    from maua_style_tpu_torch.ops import gram as G
    from maua_style_tpu_torch.pipelines import img_img as img_img_module

    run_dir = os.path.join(OUT, "fidelity")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    c_path, s_path = write_inputs(run_dir)
    want_gram = sum(STYLE_LAYERS * (it + 1) for it in FID_ITERS)
    seen = set()

    def argv(out, gpu, lr):
        return ["--content", c_path, "--style", s_path, "--output_dir", os.path.join(run_dir, out),
                "--image_sizes", ",".join(map(str, FID_SIZES)), "--num_iters", ",".join(map(str, FID_ITERS)),
                "--seed", "0", "--gpu", gpu, "--allow_random_weights", "--precision", "highest",
                "--learning_rate", str(lr)]

    engines, runs = [], {}

    def recorded(fn, args, current_size=None):
        engines.append(fn(args, current_size))
        return engines[-1]

    torch.backends.cudnn.deterministic = True
    try:
        with patched((img_img_module, "build_engine", recorded)):
            for lr in FID_LRS:
                engines.clear()
                t0 = time.perf_counter()
                style.main(argv(f"cpu_lr{lr}", "c", lr))  # the reference image
                cpu_s = time.perf_counter() - t0
                ref = os.path.join(run_dir, f"cpu_lr{lr}", f"content_style_{FID_SIZES[-1]}.png")
                with patched((G._GramFn, "apply", gram_inputs_into(seen))):
                    reset_counts()
                    t0 = time.perf_counter()
                    verdict = fidelity.main(["--reference_output", ref, "--", *argv(f"gpu_lr{lr}", "0", lr)])
                    torch.cuda.synchronize()
                    gpu_s = time.perf_counter() - t0
                    counts = read_counts()
                cpu_logs = [e.last_loss_log for e in engines[: len(FID_SIZES)]]
                gpu_logs = [e.last_loss_log for e in engines[len(FID_SIZES):]]
                runs[lr] = {
                    "ssim": verdict["ssim"], "threshold": verdict["threshold"], "pass": verdict["pass"],
                    "gated": lr == FID_GATE_LR, "cpu_s": cpu_s, "gpu_s": gpu_s, "launches": counts,
                    "finite": all(np.isfinite(l).all() for l in cpu_logs + gpu_logs),
                    "log_rtol_by_iteration": [np.max(np.abs(g - c) / np.maximum(np.abs(c), 1e-30), axis=1).tolist()
                                              for g, c in zip(gpu_logs, cpu_logs)],
                    "total_loss": {"cpu": [l.sum(axis=1).tolist() for l in cpu_logs],
                                   "gpu": [l.sum(axis=1).tolist() for l in gpu_logs]}}
    finally:
        torch.backends.cudnn.deterministic = False
    results["fidelity"] = {f"lr{lr}": run for lr, run in runs.items()}
    for lr, run in runs.items():
        what = "the gate" if run["gated"] else "the CLI's lr, report only"
        print(f"fidelity at lr {lr} ({what}): card against CPU at {FID_SIZES[-1]}², SSIM {run['ssim']} (the tool's "
              f"bar {run['threshold']}: {'passes' if run['pass'] else 'fails'}); the loss logs' largest relative "
              f"difference per iteration {json.dumps(run['log_rtol_by_iteration'])}; CPU {run['cpu_s']:.1f} s, card "
              f"{run['gpu_s']:.1f} s, launches {run['launches']}")
    shutil.rmtree(run_dir)
    for lr, run in runs.items():
        if run["launches"] != {"gram": want_gram, "correlation": 0}:
            fail(f"fidelity at lr {lr}: launches {run['launches']} != gram {want_gram}, correlation 0")
        if not run["finite"] or not np.isfinite(run["ssim"]):
            fail(f"fidelity at lr {lr}: a loss log or the SSIM ({run['ssim']}) is not finite")
    if seen - set(similarity_gram_shapes()):
        fail(f"fidelity's Gram inputs {sorted(seen)} not among phase 2's {sorted(similarity_gram_shapes())}")
    gate = runs[FID_GATE_LR]
    if not gate["pass"]:
        fail(f"fidelity at lr {FID_GATE_LR}: SSIM {gate['ssim']} below the tool's {gate['threshold']}")
    return {k: sum(run["launches"][k] for run in runs.values()) for k in ("gram", "correlation")}


def step_apart(x, one, targets: dict, two, btargets: dict) -> dict:
    """One step at ``x``, a (B, C, H, W) pastiche, through the unbanded
    engine ``one`` with ``targets`` and through ``two``'s bands ("space"
    mesh; on a "tensor" axis its (band, share) pieces) with ``btargets``: the loss terms' largest relative difference,
    the gradients' largest difference over the gradient's max, and the
    unbanded terms."""
    import torch

    from maua_style_tpu_torch.losses import evaluate_banded_losses, evaluate_losses

    cfg = one.loss_cfg
    x = x.detach().requires_grad_(True)
    total, per = evaluate_losses(x, one._extract(x, cfg.all_layers), targets, cfg)
    (grad,) = torch.autograd.grad(total, x)
    split, gather = two._band_layout(x.shape)
    bands = [b.requires_grad_(True) for b in split(x.detach())]
    btotal, bper = evaluate_banded_losses(bands, two._extract_bands(bands, cfg.all_layers), btargets, cfg,
                                          shares=two.shares)
    bgrad = gather(list(torch.autograd.grad(btotal, bands)))
    per, bper = per.detach(), bper.detach()
    return {"loss_rtol": float(((bper - per).abs() / per.abs().clamp(min=1e-30)).max()),
            "grad_rel": float((bgrad - grad).abs().max() / grad.abs().max()), "terms": per.tolist()}


# the inits one f32 spacing off that witness "tensor" runs (6o, 6p): every value
# up or down, and up and down in a checkerboard, in alternate rows, in alternate
# columns, each both ways
TENSOR_NUDGES = tuple((kind, sign) for kind in ("flat", "checker", "rows", "cols") for sign in (1, -1))


def nudged(pattern: str, sign: int):
    """A ``patched`` wrapper of ``StyleEngine._run`` or ``_steps`` that
    moves the unsharded init one f32 spacing: every value up (``pattern``
    "flat", ``sign`` 1) or down (-1), or up and down in a "checker"board,
    in alternate "rows" or in alternate "cols", ``sign`` choosing which
    half goes up."""

    def wrapper(fn, engine, p0, opt, state, *a, **k):
        p0 = nudge(p0, pattern, sign)
        return fn(engine, p0, opt, opt.init(p0), *a, **k)

    return wrapper


def nudge(p, pattern: str, sign: int):
    """``p`` (..., H, W) moved one f32 spacing as ``nudged`` says."""
    import torch

    i = torch.arange(p.shape[-2], device=p.device)[:, None]
    j = torch.arange(p.shape[-1], device=p.device)[None]
    odd = {"flat": 0 * (i + j), "checker": (i + j) % 2, "rows": i % 2 + 0 * j, "cols": j % 2 + 0 * i}[pattern]
    up = (odd == 0) if sign > 0 else (odd == 1)
    return torch.nextafter(p, torch.where(up, float("inf"), float("-inf")).to(p.dtype).expand_as(p))


def grad_witness(engine, x, targets: dict) -> float:
    """How far the unsharded gradient at ``x`` moves when ``x`` moves one
    f32 spacing up or down (the larger, over the gradient's max): the
    witness that "tensor" runs are held to twice of, since a share's
    convolution sums its channels in another order (``run_tensor``)."""
    import torch

    from maua_style_tpu_torch.losses import evaluate_losses

    def grad(x):
        x = x.detach().requires_grad_(True)
        total, _ = evaluate_losses(x, engine._extract(x, engine.loss_cfg.all_layers), targets, engine.loss_cfg)
        return torch.autograd.grad(total, x)[0]

    g0 = grad(x)
    return max(float((grad(torch.nextafter(x, torch.full_like(x, towards))) - g0).abs().max() / g0.abs().max())
               for towards in (float("inf"), float("-inf")))


def run_space(results: dict) -> dict[str, int]:
    """img_img's ``StyleEngine.optimize`` at 1024² (VGG-19 f32, the default
    layers, L-BFGS history 100, TF32 off) unsharded and on a space:2 mesh of
    ``[cuda:0, cuda:0]`` (two bands of 512 rows), under
    ``cudnn.deterministic``:

    - one step from the content init: every loss term within rtol 1e-5 and
      the gradient within 1e-4 of its max;
    - 10 iterations from the content init at lr 0.1 (at the CLI's lr 1,
      a 1e-7 perturbation of the init moved the loss log by 5.7e22 and
      the pastiche by 7% mean in 10 iterations, PERF.md): the first two
      iterations' total losses (the init's, and after the scaled gradient
      step, before L-BFGS's first curvature pair) within rtol 1e-5, every
      iteration's within rtol 1e-4 (measured 3.4e-5), and mean|Δ| of the
      pastiches within 1e-2 of mean|p| (measured 0.62%; a 1e-7 perturbed
      init alone drifted 2.2%; max|Δ| printed);
    - K1's launches (5 a style capture; 5 an iteration unsharded, 10 on two
      bands) and inputs (among phase 2's).

    Then, with cuDNN's default algorithms, lr 1 and warmed up, ms/iter and
    the peak memory of both in turns (unsharded, space:2, space:2,
    unsharded).
    With two or more cards, the CLI with ``--gpu 0,1`` at 2048² and each
    card's peak."""
    import numpy as np
    import torch

    from maua_style_tpu_torch import io as mio
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.engine.optimize import to_nchw
    from maua_style_tpu_torch.losses import LossConfig
    from maua_style_tpu_torch.models import init_params, select_model
    from maua_style_tpu_torch.ops import gram as G
    from maua_style_tpu_torch.ops.resize import resize_bilinear_np
    from maua_style_tpu_torch.parallel import build_mesh

    run_dir = os.path.join(OUT, "space")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    c_path, s_path = write_inputs(run_dir)
    content = mio.preprocess(c_path)
    style = resize_bilinear_np(mio.preprocess(s_path), size=(SPACE_SIDE, SPACE_SIDE))
    spec = select_model("vgg19")
    params = init_params(spec, seed=0)
    dev = torch.device("cuda", 0)
    mesh = build_mesh([dev] * SPACE_BANDS, [("space", SPACE_BANDS)])
    chunks = []

    def engine_on(m, lr=1.0):
        return StyleEngine(spec, params, LossConfig(), optimizer="lbfgs", learning_rate=lr, lbfgs_history=100,
                           precision="highest", device=dev, mesh=m)

    def timed_run(fn, self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(self, *a, **kw)
        torch.cuda.synchronize()
        chunks.append((time.perf_counter() - t0) * 1e3 / a[5])
        return out

    def run(m, iters=SPACE_ITERS, lr=1.0):
        engine = engine_on(m, lr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        chunks.clear()
        with patched((StyleEngine, "_run", timed_run)):
            reset_counts()
            out = engine.optimize(content, [style], content, iters)
            counts = read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        return out, engine.last_loss_log, counts, chunks[-1], peak

    def apart(p, log, p_ref, log_ref):
        # the total loss: at the content init the content term starts at 0
        rtol = np.abs(log.sum(axis=1) - log_ref.sum(axis=1)) / np.abs(log_ref.sum(axis=1))
        return {"log_rtol": float(rtol.max()), "log_rtol_by_iteration": rtol.tolist(),
                "mean_abs_rel_pastiche": float(np.abs(p - p_ref).mean() / np.abs(p_ref).mean()),
                "max_abs_pastiche": float(np.abs(p - p_ref).max())}

    seen: set = set()
    torch.backends.cudnn.deterministic = True
    try:
        # one step: the loss terms and the gradient
        one, two = engine_on(None), engine_on(mesh)
        style_t = one.style_targets([style], [1.0])
        step = step_apart(to_nchw(content, dev), one, {"content": one.content_targets(content), "style": style_t},
                          two, {"content": two.content_targets(content), "style": style_t})
        del one, two
        # 10 iterations
        p0, log0, counts0, _, _ = run(None, lr=SPACE_LR)
        with patched((G._GramFn, "apply", gram_inputs_into(seen))):
            p2, log2, counts2, _, _ = run(mesh, lr=SPACE_LR)
    finally:
        torch.backends.cudnn.deterministic = False
    parity = apart(p2, log2, p0, log0)
    bars = {"log_rtol": 1e-4, "mean_abs_rel_pastiche": 1e-2}
    run(None, 1), run(mesh, 1)  # warm-up: cuDNN's algorithms for both shapes
    timing = {"unsharded": [], "space2": []}
    for key in ("unsharded", "space2", "space2", "unsharded"):
        _, _, _, ms_iter, peak = run(mesh if key == "space2" else None)
        timing[key].append({"ms_per_iter": ms_iter, "peak_bytes": peak})
    summary = {"one_step": step, "space2_vs_unsharded": parity, "bars": bars,
               "launches_unsharded": counts0, "launches_space2": counts2, "max_abs_p": float(np.abs(p0).max()),
               "timing": timing, "bands": SPACE_BANDS, "side": SPACE_SIDE, "iters": SPACE_ITERS}
    print(f"space: {SPACE_SIDE}² on {SPACE_BANDS} bands of one card against unsharded, L-BFGS from the content init"
          f" at lr {SPACE_LR}, {SPACE_ITERS} iterations:", json.dumps(summary))
    if torch.cuda.device_count() >= 2:
        summary["two_cards"] = run_space_two_cards(run_dir, c_path, s_path)
    else:
        summary["two_cards"] = f"not run: {torch.cuda.device_count()} CUDA device visible (it needs two cards)"
        print(f"space: the --gpu 0,1 CLI at 2048² did not run: {summary['two_cards']}")
    results["space"] = summary
    shutil.rmtree(run_dir)
    want0 = {"gram": STYLE_LAYERS * (SPACE_ITERS + 1), "correlation": 0}
    want2 = {"gram": STYLE_LAYERS * (SPACE_BANDS * SPACE_ITERS + 1), "correlation": 0}
    if counts0 != want0 or counts2 != want2:
        fail(f"space launches: unsharded {counts0} (expected {want0}), space:2 {counts2} (expected {want2})")
    checked = {(1, c, n) for c, n in vgg_style_shapes(SPACE_SIDE)} | set(mesh_gram_shapes())
    if seen - checked:
        fail(f"space's Gram inputs {sorted(seen - checked)} not among phase 2's")
    if not (step["loss_rtol"] <= 1e-5 and step["grad_rel"] <= 1e-4):
        fail(f"space: one step on two bands against unsharded: {step}")
    if not max(parity["log_rtol_by_iteration"][:2]) <= 1e-5:
        fail(f"space:2 against unsharded: the first two iterations' losses {parity['log_rtol_by_iteration'][:2]} past 1e-5")
    if not (np.isfinite(p2).all() and all(parity[k] <= bars[k] for k in bars)):
        fail(f"space:2 against unsharded: {parity} past {bars}")
    return counts2


# phase 6l: configs/scaling-img.json's first NIN mesh row ("9088": NIN, these
# layers, Adam, space:2) at its size, one scale, one card standing in for
# two; then the CLI with --model_file nin --mesh space:2 over a short pyramid
NIN_SIDE, NIN_BANDS, NIN_ITERS = 9088, 2, 3
NIN_STYLE = (("relu1", 96), ("relu3", 96), ("relu5", 256), ("relu7", 384), ("relu9", 384), ("relu11", 1024))
NIN_CONTENT = "relu8"
NIN_CLI_SIZES, NIN_CLI_ITERS = (256, 512), (10, 5)
# phase 6m: the imagenet_16384 decoder's z sides (256² and 1024² out)
VQ_Z_SIDES = (16, 64)


def nin_spec():
    """NIN up to the scaling table's deepest layer (relu11)."""
    from maua_style_tpu_torch.models import select_model, truncate_spec

    return truncate_spec(select_model("nin"), [l for l, _ in NIN_STYLE] + [NIN_CONTENT])


def nin_gram_shapes(side: int, bands: int) -> list[tuple[int, int, int]]:
    """(1, C, N) of NIN's style layers for a side² image cut into ``bands``
    row bands (``spatial.band_rows`` and ``level_heights``: ceil-mode pools,
    the last band the whole image's rest; one band: the whole image's)."""
    from maua_style_tpu_torch.parallel import spatial

    spec = nin_spec()
    heights = spatial.band_rows(side, bands, spatial.band_alignment(spec), spec) if bands > 1 else [side]
    out = []
    for layer, c in NIN_STYLE:
        width = spatial.level_heights([side], spec, layer)[0]
        out += [(1, c, h * width) for h in spatial.level_heights(heights, spec, layer)]
    return out


def nin_run_gram_shapes() -> list[tuple[int, int, int]]:
    """K1's inputs on phase 6l, in order and unique: at 9088² whole (the
    style capture, the unsharded run) and banded, then the CLI's 256² and
    512² (square: the content is 1024², the style scaled to its area)
    whole and banded."""
    return list(dict.fromkeys(s for side in (NIN_SIDE, *NIN_CLI_SIZES) for bands in (1, NIN_BANDS)
                              for s in nin_gram_shapes(side, bands)))


def check_nin_gram(results: dict) -> dict:
    """K1 at every input of phase 6l, f32, with phase 2's bars and times."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    for shape in nin_run_gram_shapes():
        f = torch.relu(torch.randn(shape, device="cuda", generator=gen))
        row = {"shape": list(shape), "at_9088": shape in nin_gram_shapes(NIN_SIDE, 1) + nin_gram_shapes(NIN_SIDE, 2),
               **measure_gram(f)}
        rows.append(row)
        print("nin gram", json.dumps(row))
        del f
    results["gram_nin"] = rows
    big = [r for r in rows if r["at_9088"]]

    def total(rs, key):
        return sum(r[key] for r in rs)

    return {"shapes": len(rows), "ms": total(rows, "kernel_ms"), "plain_ms": total(rows, "plain_ms"),
            "library_ms": total(rows, "library_ms"), "bound_ms": total(rows, "bound_ms"),
            "ms_9088": total(big, "kernel_ms"), "plain_ms_9088": total(big, "plain_ms"),
            "library_ms_9088": total(big, "library_ms"), "bound_ms_9088": total(big, "bound_ms"),
            "slower_than_library": [r["shape"] for r in rows if r["kernel_ms"] >= r["library_ms"]],
            "max_rel_err_f64": max(r["kernel_rel_err_f64"] for r in rows)}


def run_nin_space(results: dict) -> dict[str, dict]:
    """NIN on space:2 (configs/scaling-img.json's "9088" row), one card
    standing in for two: ``StyleEngine.optimize`` at 9088², one scale, with
    the table's layers and Adam (lr 1), seeded random weights, f32, TF32
    off, unbanded and on a space:2 mesh of ``[cuda:0, cuda:0]``:

    - under ``cudnn.deterministic``, one step from the content init: every
      loss term within rtol 1e-5 and the gradient within 1e-4 of its max,
      6h's bars.  The bands sum each Gram (K1 per band, 3xTF32, f32
      accumulation) and each convolution in another order than the whole
      image: at 1024² K1 lies 5.4e-7 from an f64 Gram (phase 2), and its
      error grows at most as √N, to ≈ 1.3e-6 at relu1's 5.15M positions,
      ten times under 1e-5; the gradient's bar is 6h's for the same sums;
    - warmed up, 3 iterations of each in turn: ms/iter, each run's peak
      memory, the loss logs' relative difference and mean|Δ| (report only:
      Adam's sign(g) steps turn float noise into whole steps, ROADMAP);
      K1's launches (6 a style capture; 6 an iteration unsharded, 12 on
      two bands) and inputs (among phase 2's, ``check_nin_gram``).

    Then the img_img CLI with ``--model_file nin --gpu 0,0 --mesh space:2``,
    the table's layers and Adam at 256 and 512 (10 and 5 iterations): the
    PNGs, finite loss logs, every engine NIN on two bands, K1's launches
    (6 a scale's capture, 12 an iteration) and inputs.  Returns the
    launches of the space:2 run and of the CLI."""
    import numpy as np
    import torch

    from maua_style_tpu_torch import io as mio
    from maua_style_tpu_torch import style
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.engine.optimize import to_nchw, to_nhwc
    from maua_style_tpu_torch.losses import LossConfig
    from maua_style_tpu_torch.models import init_params, select_model
    from maua_style_tpu_torch.ops import gram as G
    from maua_style_tpu_torch.ops.resize import resize_bilinear
    from maua_style_tpu_torch.parallel import build_mesh
    from maua_style_tpu_torch.pipelines import img_img as img_img_module

    run_dir = os.path.join(OUT, "nin_space")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    c_path, s_path = write_inputs(run_dir)
    dev = torch.device("cuda", 0)
    # the main path's images resized to the table's size on the card (host arrays of 1 GB each)
    content, style_img = (to_nhwc(resize_bilinear(to_nchw(mio.preprocess(p), dev), size=(NIN_SIDE, NIN_SIDE)))
                          for p in (c_path, s_path))
    spec = select_model("nin")
    params = init_params(spec, seed=0)
    layers = [l for l, _ in NIN_STYLE]
    cfg = LossConfig(content_layers=(NIN_CONTENT,), style_layers=tuple(layers))
    mesh = build_mesh([dev] * NIN_BANDS, [("space", NIN_BANDS)])
    chunks = []

    def engine_on(m):
        return StyleEngine(spec, params, cfg, optimizer="adam", learning_rate=1.0, precision="highest", device=dev,
                           mesh=m)

    def timed_run(fn, self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(self, *a, **kw)
        torch.cuda.synchronize()
        chunks.append((time.perf_counter() - t0) * 1e3 / a[5])
        return out

    def run(m, iters):
        engine = engine_on(m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        chunks.clear()
        with patched((StyleEngine, "_run", timed_run)):
            reset_counts()
            out = engine.optimize(content, [style_img], content, iters)
            counts = read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        return out, engine.last_loss_log, counts, chunks[-1], peak

    seen: set = set()
    torch.backends.cudnn.deterministic = True
    try:
        one, two = engine_on(None), engine_on(mesh)
        style_t = one.style_targets([style_img], [1.0])
        step = step_apart(to_nchw(content, dev), one, {"content": one.content_targets(content), "style": style_t},
                          two, {"content": two.content_targets(content), "style": style_t})
        del one, two, style_t
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"nin_space: one step at {NIN_SIDE}² on {NIN_BANDS} bands against unsharded", json.dumps(step))
    run(None, 1), run(mesh, 1)  # warm-up: cuDNN's algorithms for both shapes
    p0, log0, counts0, ms0, peak0 = run(None, NIN_ITERS)
    with patched((G._GramFn, "apply", gram_inputs_into(seen))):
        p2, log2, counts2, ms2, peak2 = run(mesh, NIN_ITERS)
    total0, total2 = log0.sum(axis=1), log2.sum(axis=1)
    summary = {"one_step": step, "side": NIN_SIDE, "bands": NIN_BANDS, "iters": NIN_ITERS,
               "unsharded": {"ms_per_iter": ms0, "peak_bytes": peak0, "launches": counts0},
               "space2": {"ms_per_iter": ms2, "peak_bytes": peak2, "launches": counts2},
               "log_rtol_by_iteration": (np.abs(total2 - total0) / np.abs(total0)).tolist(),
               "mean_abs_rel_pastiche": float(np.abs(p2 - p0).mean() / np.abs(p0).mean()),
               "finite": bool(np.isfinite(p2).all() and np.isfinite(log2).all() and np.isfinite(log0).all())}
    del p0, p2
    print(f"nin_space: {NIN_SIDE}², Adam from the content init, {NIN_ITERS} iterations each, unsharded and on "
          f"{NIN_BANDS} bands of one card:", json.dumps({k: v for k, v in summary.items() if k != "one_step"}))

    engines = []

    def recorded(fn, args, current_size=None):
        engines.append(fn(args, current_size))
        return engines[-1]

    cli_dir = os.path.join(run_dir, "cli")
    argv = ["--content", c_path, "--style", s_path, "--output_dir", cli_dir, "--model_file", "nin",
            "--style_layers", ",".join(layers), "--content_layers", NIN_CONTENT, "--optimizer", "adam",
            "--image_sizes", ",".join(map(str, NIN_CLI_SIZES)), "--num_iters", ",".join(map(str, NIN_CLI_ITERS)),
            "--gpu", "0,0", "--mesh", f"space:{NIN_BANDS}", "--precision", "highest", "--allow_random_weights",
            "--seed", "0", "--scaling_args", os.path.join(run_dir, "none.json")]
    with patched((img_img_module, "build_engine", recorded), (G._GramFn, "apply", gram_inputs_into(seen))):
        reset_counts()
        t0 = time.perf_counter()
        style.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_counts = read_counts()
    pngs = [os.path.join(cli_dir, f"content_style_{size}.png") for size in NIN_CLI_SIZES]
    summary["cli"] = {"wall_s": cli_s, "launches": cli_counts, "pngs": [os.path.exists(p) for p in pngs],
                      "banded": [e.band_devices == [dev] * NIN_BANDS and e.spec.arch == "nin" for e in engines],
                      "finite": all(np.isfinite(e.last_loss_log).all() for e in engines)}
    print("nin_space: the img_img CLI with --model_file nin --mesh space:2 at", NIN_CLI_SIZES, json.dumps(summary["cli"]))
    results["nin_space"] = summary
    shutil.rmtree(run_dir)
    want0 = {"gram": len(NIN_STYLE) * (NIN_ITERS + 1), "correlation": 0}
    want2 = {"gram": len(NIN_STYLE) * (NIN_BANDS * NIN_ITERS + 1), "correlation": 0}
    want_cli = {"gram": sum(len(NIN_STYLE) * (NIN_BANDS * it + 1) for it in NIN_CLI_ITERS), "correlation": 0}
    if counts0 != want0 or counts2 != want2 or cli_counts != want_cli:
        fail(f"nin_space launches: unsharded {counts0} (expected {want0}), space:2 {counts2} (expected {want2}), "
             f"the CLI {cli_counts} (expected {want_cli})")
    if seen - set(nin_run_gram_shapes()):
        fail(f"nin_space's Gram inputs {sorted(seen - set(nin_run_gram_shapes()))} not among phase 2's")
    if not (step["loss_rtol"] <= 1e-5 and step["grad_rel"] <= 1e-4):
        fail(f"nin_space: one step on two bands against unsharded: {step} past rtol 1e-5 / 1e-4")
    if not summary["finite"] or not summary["cli"]["finite"]:
        fail("nin_space: a pastiche or a loss log is not finite")
    if not (all(summary["cli"]["pngs"]) and len(engines) == len(NIN_CLI_SIZES) and all(summary["cli"]["banded"])):
        fail(f"nin_space: the CLI's artifacts or engines are off: {summary['cli']}")
    return {"nin_space2": counts2, "nin_cli": cli_counts}


def run_vqgan_space(results: dict) -> dict[str, int]:
    """``spatial.banded_decode`` of imagenet_16384 at full width (seeded
    random weights, f32, TF32 off, ``cudnn.deterministic``) on a space:2
    mesh of ``[cuda:0, cuda:0]`` against the whole decode, at z of 16×16
    (256² out) and 64×64 (1024² out): the output and the gradient of a
    random projection with respect to z within 1e-4 of their max.  The
    bands' GroupNorm statistics, attention scores and convolutions sum in
    another order, and cuDNN picks its algorithms per shape, so the bands'
    convolutions are other kernels than the whole's: 1e-4 is the bar this
    repository holds the decoder to across implementations (phase 6c's
    card against CPU, tests/test_torch_vqgan.py's port against JAX).
    Prints the max|Δ|s, ms of the forward and of forward plus gradient
    (CUDA events, median of 5) and each one's peak memory; K1 and K2 0."""
    import torch

    from maua_style_tpu_torch.engine.optimize import apply_precision
    from maua_style_tpu_torch.models import vqgan as vq
    from maua_style_tpu_torch.parallel import build_mesh, spatial

    apply_precision("highest")
    dev = torch.device("cuda", 0)
    model = vq.init_vqgan(vq.PRESETS["imagenet_16384"], seed=0).to(dev).eval().requires_grad_(False)
    mesh = build_mesh([dev] * 2, [("space", 2)])
    gen = torch.Generator(device=dev).manual_seed(16)
    rows = []
    reset_counts()
    torch.backends.cudnn.deterministic = True
    try:
        for side in VQ_Z_SIDES:
            z = torch.randn((1, model.cfg.embed_dim, side, side), device=dev, generator=gen)
            proj = None
            got = {}
            for key, m in (("whole", None), ("space2", mesh)):
                zz = z.clone().requires_grad_(True)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                out = spatial.banded_decode(model, zz, m)
                if proj is None:
                    proj = torch.randn(out.shape, device=dev, generator=gen)
                (g,) = torch.autograd.grad((out * proj).sum(), zz)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base

                def forward(zz=zz, m=m):
                    with torch.no_grad():
                        spatial.banded_decode(model, zz, m)

                def backward(zz=zz, m=m):
                    torch.autograd.grad((spatial.banded_decode(model, zz, m) * proj).sum(), zz)

                got[key] = {"out": out.detach(), "grad": g, "peak_bytes": peak,
                            "forward_ms": time_ms(forward, reps=5, warmup=1),
                            "grad_ms": time_ms(backward, reps=5, warmup=1)}
            w, b = got["whole"], got["space2"]
            row = {"z": [side, side], "out": list(w["out"].shape),
                   "out_rel": float((b["out"] - w["out"]).abs().max() / w["out"].abs().max()),
                   "grad_rel": float((b["grad"] - w["grad"]).abs().max() / w["grad"].abs().max()),
                   "finite": bool(torch.isfinite(b["out"]).all() and torch.isfinite(b["grad"]).all()),
                   **{f"{k}_{m}": got[k][m] for k in got for m in ("forward_ms", "grad_ms", "peak_bytes")}}
            rows.append(row)
            del got, w, b, z, proj
            print("vqgan_space: imagenet_16384 decode on space:2 against whole", json.dumps(row))
    finally:
        torch.backends.cudnn.deterministic = False
    counts = read_counts()
    results["vqgan_space"] = rows
    del model
    for row in rows:
        if not (row["finite"] and row["out_rel"] <= 1e-4 and row["grad_rel"] <= 1e-4):
            fail(f"vqgan_space: the banded decode at z {row['z']} against whole: {row}")
    if counts != {"gram": 0, "correlation": 0}:
        fail(f"vqgan_space: launches {counts}, expected none")
    return counts


# phase 6n: img_img's engine on "tensor" meshes of one card standing in for
# two and six (channel shares alone, and beside two bands), then the CLI on
# tensor:3 over a short pyramid
TENSOR_SIDE, TENSOR_ITERS, TENSOR_LR = 1024, 10, 0.1
TENSOR4_SIDE = 256  # 6n's tensor:4 step (an empty share of the colour channels)
TENSOR_MESHES = (("tensor2", (("tensor", 2),)), ("space2_tensor3", (("space", 2), ("tensor", 3))))
TENSOR_CLI_MESH, TENSOR_CLI_SIZES, TENSOR_CLI_ITERS = (("tensor", 3),), (256, 512), (10, 5)


def mesh_arg(axes) -> str:
    """``--mesh``'s form of ((axis, size), ...)."""
    return ",".join(f"{a}:{n}" for a, n in axes)


def tensor_gram_shapes(side: int, axes) -> list[tuple[int, int, int]]:
    """(1, C_t, N) of VGG-19's style layers for a side² image on a mesh of
    ``axes``: each layer's channel shares (``parallel.channel_shares``) of
    each band (``spatial.band_rows`` and ``level_heights``), K1's diagonal
    blocks."""
    from maua_style_tpu_torch.parallel import channel_shares, spatial

    spec = vgg19_spec()
    sizes = dict(axes)
    bands = sizes.get("space", 1)
    heights = spatial.band_rows(side, bands, 16, spec) if bands > 1 else [side]
    out = []
    for c, layer in VGG_STYLE:
        width = spatial.level_heights([side], spec, layer)[0]
        for h in spatial.level_heights(heights, spec, layer):
            out += [(1, ch.stop - ch.start, h * width) for ch in channel_shares(c, sizes.get("tensor", 1))]
    return out


def tensor_run_gram_shapes() -> list[tuple[int, int, int]]:
    """K1's new inputs on phase 6n, in order and unique: the engine's at
    1024² on each mesh, then the CLI's at 256² and 512² on tensor:3."""
    runs = [(TENSOR_SIDE, axes) for _, axes in TENSOR_MESHES]
    runs += [(side, TENSOR_CLI_MESH) for side in TENSOR_CLI_SIZES]
    return list(dict.fromkeys(s for side, axes in runs for s in tensor_gram_shapes(side, axes)))


def check_tensor_gram(results: dict) -> dict:
    """K1 at every (1, C_t, N) input of phase 6n, f32, with phase 2's bars
    and times: ragged channel counts (21, 22, 43, 85, 171 …) meet the
    kernel's zero fill of a partial tile."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    engine = {key: set(tensor_gram_shapes(TENSOR_SIDE, axes)) for key, axes in TENSOR_MESHES}
    for shape in tensor_run_gram_shapes():
        f = torch.relu(torch.randn(shape, device="cuda", generator=gen))
        row = {"shape": list(shape), "meshes": [k for k, v in engine.items() if shape in v], **measure_gram(f)}
        rows.append(row)
        print("tensor gram", json.dumps(row))
        del f
    results["gram_tensor"] = rows

    def total(rs, key):
        return sum(r[key] for r in rs)

    out = {"shapes": len(rows), "ms": total(rows, "kernel_ms"), "plain_ms": total(rows, "plain_ms"),
           "library_ms": total(rows, "library_ms"), "bound_ms": total(rows, "bound_ms"),
           "slower_than_library": [r["shape"] for r in rows if r["kernel_ms"] >= r["library_ms"]],
           "max_rel_err_f64": max(r["kernel_rel_err_f64"] for r in rows)}
    for key, axes in TENSOR_MESHES:  # one iteration's diagonal blocks at 1024² on each mesh, each launch counted
        launches = collections.Counter(tensor_gram_shapes(TENSOR_SIDE, axes))
        out[key] = {k: sum(r[k] * launches[tuple(r["shape"])] for r in rows)
                    for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    return out


def tensor_video_gram_inputs() -> list[tuple[int, int, int]]:
    """K1's new inputs on phases 6n (tensor:4 at 256²), 6o and 6p that no
    other phase's check holds, in order."""
    old = (set(tensor_run_gram_shapes()) | vid_runs_gram_inputs() | img_vid_run_gram_inputs(IV_SIZES, IV_GFW)
           | set(similarity_gram_shapes()))
    new = set(tensor_gram_shapes(TENSOR4_SIDE, (("tensor", 4),))) | vid_tensor_gram_inputs() | img_vid_tensor_gram_inputs()
    return sorted(new - old)


def check_tensor_video_gram(results: dict) -> dict:
    """K1 at every new input of phases 6n's tensor:4 step, 6o and 6p, f32,
    with phase 2's bars and times (``check_tensor_gram``): the channel
    shares of vid_img's stacks, (8, 32, 147456) … (8, 256, 576) at 512x288,
    (4, C_t, N) on frames:2,tensor:2, and of a 1024x576 frame, (1, 32,
    589824) … (1, 256, 2304); img_vid's groups' static Grams (T_i, C_t, N)
    and whole-window diagonal blocks (1, T_i·C_t, N) of the 724 window
    (7 frames, or 4 + 3 on frames:2,tensor:2) and of the 256 CLI's 18-frame
    windows; tensor:4's (1, 16, 65536) … (1, 128, 256)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    vid, ivid = vid_tensor_gram_inputs(), img_vid_tensor_gram_inputs()
    for shape in tensor_video_gram_inputs():
        f = torch.relu(torch.randn(shape, device="cuda", generator=gen))
        path = "vid_img" if shape in vid else "img_vid" if shape in ivid else "tensor4"
        row = {"shape": list(shape), "path": path, **measure_gram(f)}
        rows.append(row)
        print("tensor video gram", json.dumps(row))
        del f
    torch.cuda.empty_cache()
    results["gram_tensor_video"] = rows
    out = {"shapes": len(rows), "max_rel_err_f64": max(r["kernel_rel_err_f64"] for r in rows)}
    for path in ("vid_img", "img_vid", "tensor4"):
        pr = [r for r in rows if r["path"] == path]
        out[path] = {k: sum(r[k] for r in pr) for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
        out[path].update(shapes=len(pr), slower_than_library=[r["shape"] for r in pr if r["kernel_ms"] >= r["library_ms"]])
    return out


def tensor_off_diagonal_ms(side: int, axes) -> float:
    """Device ms of one iteration's off-diagonal Gram blocks on a mesh of
    ``axes``: at each style layer, for each band and each pair of channel
    shares t < u, the product F_t F_uᵀ forward and its gradient to both
    operands (``ops.gram._cross_block`` under autograd), on random
    activations of the piece's shapes; CUDA events, median of 7."""
    import torch

    from maua_style_tpu_torch.ops import gram as G
    from maua_style_tpu_torch.parallel import channel_shares, spatial

    spec = vgg19_spec()
    sizes = dict(axes)
    bands = sizes.get("space", 1)
    heights = spatial.band_rows(side, bands, 16, spec) if bands > 1 else [side]
    gen = torch.Generator(device="cuda").manual_seed(17)
    total = 0.0
    for c, layer in VGG_STYLE:
        width = spatial.level_heights([side], spec, layer)[0]
        chs = [ch.stop - ch.start for ch in channel_shares(c, sizes.get("tensor", 1))]
        for hb in spatial.level_heights(heights, spec, layer):
            for t in range(len(chs)):
                for u in range(t + 1, len(chs)):
                    a = torch.randn((chs[t], hb * width), device="cuda", generator=gen).requires_grad_(True)
                    b = torch.randn((chs[u], hb * width), device="cuda", generator=gen).requires_grad_(True)
                    g = torch.randn((chs[t], chs[u]), device="cuda", generator=gen)
                    total += time_ms(lambda: torch.autograd.grad(G._cross_block(a, b), (a, b), g))
    return total


def tensor4_step(content, style, engine_on) -> dict:
    """One img_img step at 256² from the content init (the 1024² inputs
    resized) unsharded and on tensor:4 over ``[cuda:0] * 4``: the
    pastiche's 3 colour channels in shares of 1 + 1 + 1 + 0 (the fourth
    empty, as GSPMD's padding leaves it), every later layer's 16 … 128 a
    share.  The terms' largest relative difference (gated at rtol 1e-5)
    and the gradient's, the fewest input channels any convolution and K1
    launch saw (an empty share must reach neither), and K1's inputs."""
    import torch

    from maua_style_tpu_torch.engine.optimize import to_nchw
    from maua_style_tpu_torch.ops import gram as G
    from maua_style_tpu_torch.ops.resize import resize_bilinear_np
    from maua_style_tpu_torch.parallel import build_mesh, spatial

    dev = torch.device("cuda", 0)
    c, st = (resize_bilinear_np(a, size=(TENSOR4_SIDE, TENSOR4_SIDE)) for a in (content, style))
    one, four = engine_on(None), engine_on(build_mesh([dev] * 4, [("tensor", 4)]))
    style_t = one.style_targets([st], [1.0])
    x = to_nchw(c, dev)
    convs, seen = [], set()
    with patched((spatial.F, "conv2d", lambda fn, x, *a, **k: convs.append(x.shape[1]) or fn(x, *a, **k)),
                 (G._GramFn, "apply", gram_inputs_into(seen))):
        step = step_apart(x, one, {"content": one.content_targets(c), "style": style_t},
                          four, {"content": four.content_targets(c), "style": style_t})
    step.update(side=TENSOR4_SIDE, pastiche_shares=[p.shape[1] for p in four._band_layout(x.shape)[0](x)],
                fewest_conv_channels=min(convs), fewest_gram_channels=min(c for _, c, _ in seen),
                gram_inputs=sorted(seen))
    print(f"tensor:4 step at {TENSOR4_SIDE}²:", json.dumps(step))
    return step


def run_tensor(results: dict) -> dict[str, dict]:
    """img_img's ``StyleEngine.optimize`` at 1024² (VGG-19 f32, the default
    layers, L-BFGS history 100, TF32 off) unsharded, on tensor:2 over
    ``[cuda:0] * 2`` (each layer's channels in two shares: 3 → 2 + 1, 64 →
    32 + 32 …) and on space:2,tensor:3 over ``[cuda:0] * 6`` (two bands
    of three shares: 64 → 22 + 21 + 21 …), under ``cudnn.deterministic``:

    - one step from the content init: every loss term within rtol 1e-5
      (6h's bar) and the gradient within 1e-4 of its max (6h's) or, past
      that, within twice the unsharded gradient's own difference at an
      input one f32 spacing off (up and down).  A share's convolution sums
      its input channels in another order than the whole one, so its
      activations differ in the last bits (the bands' are bit for bit the
      whole image's), and VGG-19's ReLUs and max-pools route the gradient
      by those bits at near-ties, as they do between two inputs one f32
      spacing apart (PERF.md has the figures);
    - 10 iterations from the content init at lr 0.1: the first two totals
      within rtol 1e-5, every total within rtol 1e-4 and mean|Δ| within
      1e-2 of mean|p| (6h's bars), or, past those, within twice the
      unsharded run's own drift from an init one f32 spacing off, for the
      same reason;
    - K1's launches (5 a style capture; 5 per share per band an
      iteration) and inputs (among phase 2's), and the off-diagonal Gram
      blocks' plain products (5 per band per pair of shares an iteration).

    Then, with cuDNN's default algorithms, lr 1 and warmed up, ms/iter and
    the peak memory of each in turns, with the off-diagonal products'
    device ms an iteration (``tensor_off_diagonal_ms``).  Then the style
    CLI with ``--gpu 0,0,0 --mesh tensor:3`` at 256 and 512 (10 and 5
    iterations): the PNGs, finite loss logs, every engine on three
    shares, K1's launches and inputs.  Returns each run's launches."""
    import numpy as np
    import torch

    from maua_style_tpu_torch import io as mio
    from maua_style_tpu_torch import style as style_cli
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.engine.optimize import to_nchw
    from maua_style_tpu_torch.losses import LossConfig
    from maua_style_tpu_torch.models import init_params, select_model
    from maua_style_tpu_torch.ops import gram as G
    from maua_style_tpu_torch.ops.resize import resize_bilinear_np
    from maua_style_tpu_torch.parallel import build_mesh
    from maua_style_tpu_torch.pipelines import img_img as img_img_module

    t_phase = time.perf_counter()
    run_dir = os.path.join(OUT, "tensor")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    c_path, s_path = write_inputs(run_dir)
    content = mio.preprocess(c_path)
    style = resize_bilinear_np(mio.preprocess(s_path), size=(TENSOR_SIDE, TENSOR_SIDE))
    spec = select_model("vgg19")
    params = init_params(spec, seed=0)
    dev = torch.device("cuda", 0)
    meshes = {"unsharded": None, **{key: build_mesh([dev] * int(np.prod([n for _, n in axes])), list(axes))
                                    for key, axes in TENSOR_MESHES}}
    chunks, products = [], [0]

    def engine_on(m, lr=1.0):
        return StyleEngine(spec, params, LossConfig(), optimizer="lbfgs", learning_rate=lr, lbfgs_history=100,
                           precision="highest", device=dev, mesh=m)

    def timed_run(fn, self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(self, *a, **kw)
        torch.cuda.synchronize()
        chunks.append((time.perf_counter() - t0) * 1e3 / a[5])
        return out

    def counted_block(fn, a, b):
        products[0] += 1
        return fn(a, b)

    def run(key, lr=1.0, init=None, seen=None):
        engine = engine_on(meshes[key], lr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        chunks.clear()
        products[0] = 0
        wrap = [(StyleEngine, "_run", timed_run), (G, "_cross_block", counted_block)]
        if seen is not None:
            wrap.append((G._GramFn, "apply", gram_inputs_into(seen)))
        with patched(*wrap):
            reset_counts()
            out = engine.optimize(content, [style], content if init is None else init, TENSOR_ITERS)
            counts = {**read_counts(), "products": products[0]}
        peak = torch.cuda.max_memory_allocated() - base
        return out, engine.last_loss_log, counts, chunks[-1], peak

    def apart(p, log, p_ref, log_ref):
        rtol = np.abs(log.sum(axis=1) - log_ref.sum(axis=1)) / np.abs(log_ref.sum(axis=1))
        return {"first_two_rtol": float(rtol[:2].max()), "log_rtol": float(rtol.max()),
                "log_rtol_by_iteration": rtol.tolist(),
                "mean_abs_rel_pastiche": float(np.abs(p - p_ref).mean() / np.abs(p_ref).mean()),
                "max_abs_pastiche": float(np.abs(p - p_ref).max()), "finite": bool(np.isfinite(log).all())}

    seen: set = set()
    steps, parity, counts = {}, {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        one = engine_on(None)
        style_t = one.style_targets([style], [1.0])
        x = to_nchw(content, dev)
        step_witness = grad_witness(one, x, {"content": one.content_targets(content), "style": style_t})
        for key, m in meshes.items():
            if m is not None:
                two = engine_on(m)
                steps[key] = step_apart(x, one, {"content": one.content_targets(content), "style": style_t},
                                        two, {"content": two.content_targets(content), "style": style_t})
                del two
        del one
        tensor4 = tensor4_step(content, style, engine_on)
        p0, log0, counts["unsharded"], _, _ = run("unsharded", TENSOR_LR)
        nudged = np.nextafter(content, np.float32(np.inf)).astype(np.float32)
        pw, logw, _, _, _ = run("unsharded", TENSOR_LR, init=nudged)
        witness = apart(pw, logw, p0, log0)
        for key, _ in TENSOR_MESHES:
            p, log, counts[key], _, _ = run(key, TENSOR_LR, seen=seen)
            parity[key] = apart(p, log, p0, log0)
    finally:
        torch.backends.cudnn.deterministic = False
    bars = {"log_rtol": max(1e-4, 2 * witness["log_rtol"]),
            "mean_abs_rel_pastiche": max(1e-2, 2 * witness["mean_abs_rel_pastiche"]),
            "step_grad_rel": max(1e-4, 2 * step_witness)}
    for key in meshes:  # warm-up: cuDNN's algorithms for every piece's shapes
        run(key)
    timing = {key: [] for key in meshes}
    order = list(meshes)
    for key in order + order[::-1]:
        _, _, _, ms_iter, peak = run(key)
        timing[key].append({"ms_per_iter": ms_iter, "peak_bytes": peak})
    off_diag = {key: tensor_off_diagonal_ms(TENSOR_SIDE, axes) for key, axes in TENSOR_MESHES}

    # the CLI on tensor:3 over a short pyramid
    engines = []

    def recorded(fn, args, current_size=None):
        engines.append(fn(args, current_size))
        return engines[-1]

    cli_seen: set = set()
    cli_dir = os.path.join(run_dir, "cli")
    t0 = time.perf_counter()
    with patched((img_img_module, "build_engine", recorded), (G._GramFn, "apply", gram_inputs_into(cli_seen))):
        reset_counts()
        style_cli.main(["--content", c_path, "--style", s_path, "--output_dir", cli_dir,
                        "--image_sizes", ",".join(map(str, TENSOR_CLI_SIZES)),
                        "--num_iters", ",".join(map(str, TENSOR_CLI_ITERS)), "--optimizer", "lbfgs",
                        "--precision", "highest", "--allow_random_weights", "--seed", "0",
                        "--gpu", ",".join(["0"] * int(np.prod([n for _, n in TENSOR_CLI_MESH]))),
                        "--mesh", mesh_arg(TENSOR_CLI_MESH), "--scaling_args", os.path.join(run_dir, "none.json")])
        torch.cuda.synchronize()
        counts["cli_tensor3"] = read_counts()
    cli_s = time.perf_counter() - t0
    pngs = [os.path.join(cli_dir, f"content_style_{size}.png") for size in TENSOR_CLI_SIZES]
    cli = {"s": cli_s, "pngs": [os.path.exists(f) for f in pngs],
           "shares": [e.shares for e in engines],
           "finite": all(e.last_loss_log is not None and np.isfinite(e.last_loss_log).all() for e in engines)}
    shutil.rmtree(run_dir)

    summary = {"one_step": steps, "one_step_witness_grad_rel": step_witness, "tensor4": tensor4, "vs_unsharded": parity,
               "witness_one_ulp_off": witness, "bars": bars,
               "launches": counts, "timing": timing, "off_diagonal_device_ms_per_iter": off_diag, "cli": cli,
               "side": TENSOR_SIDE, "iters": TENSOR_ITERS, "lr": TENSOR_LR}
    summary["phase_s"] = time.perf_counter() - t_phase
    results["tensor"] = summary
    print(f"tensor: {TENSOR_SIDE}² on channel shares of one card against unsharded, L-BFGS from the content init at "
          f"lr {TENSOR_LR}, {TENSOR_ITERS} iterations, and the CLI on {mesh_arg(TENSOR_CLI_MESH)}:",
          json.dumps(summary))
    for key, axes in (("unsharded", ()), *TENSOR_MESHES):
        sizes = dict(axes)
        pieces, pairs = sizes.get("tensor", 1) * sizes.get("space", 1), math.comb(sizes.get("tensor", 1), 2)
        want = {"gram": STYLE_LAYERS * (pieces * TENSOR_ITERS + 1), "correlation": 0,
                "products": STYLE_LAYERS * sizes.get("space", 1) * pairs * TENSOR_ITERS}
        if counts[key] != want:
            fail(f"tensor {key}: launches {counts[key]}, expected {want}")
    cli_pieces = int(np.prod([n for _, n in TENSOR_CLI_MESH]))
    want_cli = {"gram": sum(STYLE_LAYERS * (cli_pieces * it + 1) for it in TENSOR_CLI_ITERS), "correlation": 0}
    if counts["cli_tensor3"] != want_cli:
        fail(f"tensor CLI: launches {counts['cli_tensor3']}, expected {want_cli}")
    checked = set(tensor_run_gram_shapes())
    if seen - checked - {(1, c, n) for c, n in vgg_style_shapes(TENSOR_SIDE)}:
        fail(f"tensor's Gram inputs {sorted(seen - checked)} not among phase 2's")
    if cli_seen - checked - set(similarity_gram_shapes()):
        fail(f"tensor CLI's Gram inputs {sorted(cli_seen - checked)} not among phase 2's")
    for key, step in steps.items():
        if not (step["loss_rtol"] <= 1e-5 and step["grad_rel"] <= bars["step_grad_rel"]):
            fail(f"tensor {key}: one step against unsharded: {step} (gradient bar {bars['step_grad_rel']})")
    if not (tensor4["loss_rtol"] <= 1e-5 and tensor4["fewest_conv_channels"] >= 1 and tensor4["fewest_gram_channels"] >= 1
            and tensor4["pastiche_shares"] == [1, 1, 1, 0]):
        fail(f"tensor:4 step at {TENSOR4_SIDE}² against unsharded: {tensor4}")
    if set(tensor4["gram_inputs"]) - set(tensor_video_gram_inputs()) - set(similarity_gram_shapes()):
        fail(f"tensor:4's Gram inputs {tensor4['gram_inputs']} not among phase 2's")
    for key, row in parity.items():
        if not (row["finite"] and row["first_two_rtol"] <= 1e-5
                and all(row[k] <= bars[k] for k in ("log_rtol", "mean_abs_rel_pastiche"))):
            fail(f"tensor {key} against unsharded: {row} past {bars} (first two within 1e-5)")
    if not (all(cli["pngs"]) and cli["finite"] and cli["shares"] == [cli_pieces] * len(TENSOR_CLI_SIZES)):
        fail(f"tensor CLI on {mesh_arg(TENSOR_CLI_MESH)}: {cli}")
    return {f"tensor_{key}": counts[key] for key, _ in TENSOR_MESHES} | {"tensor_cli": counts["cli_tensor3"]}


def run_space_two_cards(run_dir: str, c_path: str, s_path: str) -> dict:
    """The style CLI with ``--gpu 0,1`` at 2048² (5 L-BFGS iterations): each
    card's peak memory."""
    import torch

    from maua_style_tpu_torch import style

    for i in range(2):
        torch.cuda.reset_peak_memory_stats(i)
    t0 = time.perf_counter()
    style.main(["--content", c_path, "--style", s_path, "--output_dir", os.path.join(run_dir, "cli"),
                "--image_sizes", "2048", "--num_iters", "5", "--gpu", "0,1", "--allow_random_weights", "--seed", "0"])
    out = {"wall_s": time.perf_counter() - t0, "peak_bytes": [torch.cuda.max_memory_allocated(i) for i in range(2)]}
    print("space: --gpu 0,1 at 2048²", json.dumps(out))
    return out


def run_frames(results: dict, key: str = "frames", meshes=(("frames2", "frames:2"),)) -> dict[str, dict]:
    """``optimize_frames`` on 8 frames of phase 5's clip at 512x288 (phase
    5's engine: VGG-19 f32, L-BFGS history 100, its random init, 20
    iterations, the style's histogram statistics) unsharded and on each of
    ``meshes`` ((name, ``--mesh``), every device ``cuda:0``; phase 6i:
    frames:2, two stacked steps of 4 frames enqueued in turn; phase 6j:
    space:2, the 8 frames' rows in two bands, and frames:2,space:2, two
    rows of two bands): under ``cudnn.deterministic`` and over phase 5's
    stacked-against-per-frame check's 5 iterations, its bars (every loss
    within rtol 1e-2, mean|Δ| within 1e-2 of mean|p|), K1's launches (5 a
    style capture, 5 per band per share per iteration) and inputs; the
    same readings over the pass's 20 iterations, report only (L-BFGS drifts
    further); then, warmed up, the seconds of each at 20 iterations in
    turns.  A mesh with a "tensor" axis (phase 6o) is held to twice the
    unsharded run's own drift from its init moved one f32 spacing up and
    down where that is past 1e-2 (a share sums its channels in another
    order: ``run_tensor``).  Returns each mesh's launches."""
    import numpy as np
    import torch

    from maua_style_tpu_torch import config
    from maua_style_tpu_torch import io as mio
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.ops import gram as G
    from maua_style_tpu_torch.ops.frame_ops import style_hist_stats
    from maua_style_tpu_torch.pipelines.common import build_engine, scale_styles

    run_dir = os.path.join(OUT, key)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    v_path, s_path = write_video(run_dir, FRAMES_B)
    contents = np.load(v_path)
    args = config.get_args(vid_argv(v_path, s_path, run_dir))
    hw = vid_hw(FRAMES_SIZE)
    style_big = mio.process_style_images(args)
    styles = scale_styles(style_big, (1, *hw), args.style_scale)
    iters = VID_ITERS[0] // VID_PASSES
    kw = dict(out_hw=hw, content_scale=FRAMES_SIZE / max(VID_HW), blend_weights=args.style_blend_weights,
              hist_stats=style_hist_stats(style_big[0], rng=np.random.default_rng(0)), init_mode="random",
              seeds=list(range(FRAMES_B)))
    engines = {"unsharded": build_engine(args, FRAMES_SIZE)}
    meshes = [(name, config.parse_mesh(mesh)) for name, mesh in meshes]
    for name, axes in meshes:
        args.devices, args.mesh_shape = [torch.device("cuda", 0)] * int(np.prod([n for _, n in axes])), axes
        engines[name] = build_engine(args, FRAMES_SIZE)
        if engines[name].mesh is None or engines[name].mesh.axes != tuple(axes):
            fail(f"{key}: build_engine gave mesh {engines[name].mesh} for {axes}")

    def run(name, n):
        reset_counts()
        p, _ = engines[name].optimize_frames(contents, styles, n, **kw)
        torch.cuda.synchronize()
        return p, engines[name].last_loss_log.cpu().numpy(), read_counts()

    def apart(p, log, p_ref, log_ref):
        d = (p - p_ref).abs()
        return {"log_rtol": float(np.max(np.abs(log - log_ref) / np.maximum(np.abs(log_ref), 1e-30))),
                "mean_abs_rel_pastiche": float(d.mean() / p_ref.abs().mean()), "max_abs_pastiche": float(d.max()),
                "max_abs_p": float(p_ref.abs().max())}

    seen: set = set()
    rows, logs = {}, {}
    bars = {"log_rtol": 1e-2, "mean_abs_rel_pastiche": 1e-2}
    tensor = any(a == "tensor" for _, axes in meshes for a, _ in axes)
    torch.backends.cudnn.deterministic = True
    try:
        p0, log0, counts0 = run("unsharded", STACK_ITERS)
        long0 = run("unsharded", iters)[:2]
        if tensor:
            witness = []
            for sign in (1, -1):
                with patched((StyleEngine, "_steps", nudged("flat", sign))):
                    witness.append(apart(*run("unsharded", STACK_ITERS)[:2], p0, log0))
            tensor_bars = {k: max(v, 2 * max(w[k] for w in witness)) for k, v in bars.items()}
        for name, _ in meshes:
            with patched((G._GramFn, "apply", gram_inputs_into(seen))):
                p2, log2, counts2 = run(name, STACK_ITERS)
            logs[name] = log2
            rows[name] = {**apart(p2, log2, p0, log0), "launches": counts2,
                          f"report_only_{iters}_iters": apart(*run(name, iters)[:2], *long0)}
    finally:
        torch.backends.cudnn.deterministic = False
    secs = {name: [] for name in engines}
    for name in engines:
        run(name, 1)  # warm-up: cuDNN's algorithms for each batch and band shape
    order = [name for name, _ in meshes]
    for name in ("unsharded", *order, *reversed(order), "unsharded"):
        t0 = time.perf_counter()
        run(name, iters)
        secs[name].append(time.perf_counter() - t0)
    summary = {**rows, "launches_unsharded": counts0, "s": secs, "frames": FRAMES_B, "hw": list(hw), "iters": iters,
               "parity_iters": STACK_ITERS}
    if tensor:
        summary.update(witness_one_ulp_off=witness, tensor_bars=tensor_bars)
    print(f"{key}: {FRAMES_B} frames at {hw[0]}x{hw[1]} on {', '.join(order)} of one card against unsharded, {iters} "
          "L-BFGS iterations:", json.dumps(summary))
    results[key] = summary
    del engines, p0, p2
    shutil.rmtree(run_dir)
    # style capture once an engine; 5 an iteration for each band of each
    # stacked step
    want0 = {"gram": STYLE_LAYERS * (STACK_ITERS + 1), "correlation": 0}
    if counts0 != want0:
        fail(f"{key} launches: unsharded {counts0} (expected {want0})")
    for name, axes in meshes:
        steps = int(np.prod([n for a, n in axes if a in ("frames", "space", "tensor")]))
        want = {"gram": STYLE_LAYERS * (steps * STACK_ITERS + 1), "correlation": 0}
        if rows[name]["launches"] != want:
            fail(f"{key} launches: {name} {rows[name]['launches']} (expected {want})")
        row = rows[name]
        bar = tensor_bars if "tensor" in dict(axes) else bars
        if not (np.isfinite(logs[name]).all() and all(row[k] <= v for k, v in bar.items())):
            fail(f"{key}: {name} against unsharded: {row} past {bar}")
    checked = set(mesh_gram_shapes()) | vid_runs_gram_inputs() | vid_mesh_gram_inputs() | vid_tensor_gram_inputs()
    if seen - checked:
        fail(f"{key}'s Gram inputs {sorted(seen - checked)} not among phase 2's")
    return {name: rows[name]["launches"] for name, _ in meshes}


def check_vid_frame_parity(run_dir: str, key: str = "space2", axes=(("space", 2),),
                           modes=("warp_prev", "random")) -> dict:
    """``optimize_frame`` at 1024x576 (VGG-19 f32, L-BFGS history 100,
    phase 5's engine) unsharded and on a mesh of ``axes`` over ``[cuda:0] *
    n`` (phase 6j: space:2; phase 6o: tensor:2), under
    ``cudnn.deterministic``: frame 2 of the clip with the temporal term
    (frame 1's preprocessed content warped by the run's forward flow, the
    run's reliability weights).

    - one step, its targets captured by each engine (the content target
      piece by piece, the warp whole and then split): every loss term
      within rtol 1e-5 and the gradient within 1e-4 of its max, at the mean
      of the content and the warped frame, where every term is non-zero; on
      "tensor" the gradient within twice the unsharded gradient's own
      difference at an input one f32 spacing off (up and down) where that
      is larger (``run_tensor`` says why);
    - 10 iterations at lr 0.1 from the ``warp_prev`` init: the first two
      totals within rtol 1e-5 and mean|Δ| within 1e-2 of mean|p| (on
      "tensor" within twice the witness's furthest where that is larger);
      the later totals within twice the witness's furthest (at least 1e-4).
      L-BFGS's first step, lr/‖g‖₁, is ≈ 1e-8 a pixel here, below the
      f32 spacing of the pastiche's values (7.6e-6 at 100), so it moves
      few pixels; where the reliability weights are 1 the temporal term
      is then a sum of rounding residues (1.8e-15), its normalised
      gradient at full strength is set by which pixels rounded, and so is
      the first curvature pair (the later totals read 8.6e-6 and 3.0e-3
      apart in two runs on the same card).  The witness: the unsharded
      run again from the init moved one f32 spacing up and one down, each
      against the unsharded run (1.9e-2 to 1.2e-1 on the card); on
      "tensor" also from the init moved up and down in a checkerboard, in
      alternate rows and in alternate columns (eight in all): whether a
      nudged run follows other rounded pixels is a toss (on an H100 two
      such witnesses have read 3e-5 and 7e-5 where the shares' run lay
      1.5% away, and 2.4% elsewhere);
    - 10 iterations at lr 0.1 from the random init (0.001·N(0, 1), where
      the first step is not below the spacing): the first two totals within
      rtol 1e-5, every total within rtol 1e-4, mean|Δ| within 1e-2 of
      mean|p| (6h's bars), on "tensor" too: from this init the runs do not
      follow the rounding on the card (eight inits one f32 spacing off
      gave every total bit for bit and mean|Δ| 0.11% on an H100), so these
      fixed bars hold L-BFGS's history over pieces where the ``warp_prev``
      witnesses leave the later totals little bar.

    Each 10-iteration run also records its peak memory above what was
    allocated before it (``torch.cuda.max_memory_allocated``), unsharded
    and on the mesh.
    """
    import numpy as np
    import torch
    from PIL import Image

    from maua_style_tpu_torch import config
    from maua_style_tpu_torch import io as mio
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.io.flo import read_flo
    from maua_style_tpu_torch.ops.frame_ops import warp_map_from_flow
    from maua_style_tpu_torch.ops.resize import resize_bilinear
    from maua_style_tpu_torch.ops.warp import grid_sample
    from maua_style_tpu_torch.pipelines.common import build_engine, scale_styles

    work = os.path.join(run_dir, "vid_style")
    flow = read_flo(os.path.join(work, "flow", "forward_00001_00002.flo"))
    with Image.open(os.path.join(work, "flow", "forward_00001_00002.png")) as img:
        weights = np.array(img.convert("L"))
    frames = np.load(os.path.join(run_dir, "vid.npy"))
    args = config.get_args(vid_argv(os.path.join(run_dir, "vid.npy"), os.path.join(run_dir, "style.png"), run_dir))
    args.learning_rate = FRAME_PARITY_LR
    hw = vid_hw(VID_SIZES[-1])
    styles = scale_styles(mio.process_style_images(args), (1, *hw), args.style_scale)
    engines = {"unsharded": build_engine(args, VID_SIZES[-1])}
    args.devices, args.mesh_shape = [torch.device("cuda", 0)] * int(np.prod([n for _, n in axes])), list(axes)
    engines[key] = build_engine(args, VID_SIZES[-1])
    one, two = engines["unsharded"], engines[key]
    tensor = dict(axes).get("tensor", 1) > 1
    dev = one.device
    prev = one.prep_frame(frames[0], hw)
    kw = dict(out_hw=hw, blend_weights=args.style_blend_weights, prev=prev, flow=flow, weights_u8=weights,
              use_temporal=True, seed=0)

    def run(name, n, init_mode, nudge=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with patched((StyleEngine, "_run", nudged(*nudge))) if nudge else contextlib.nullcontext():
            p, _ = engines[name].optimize_frame(frames[1], styles, n, init_mode=init_mode, **kw)
        torch.cuda.synchronize()
        return p, engines[name].last_loss_log.cpu().numpy(), torch.cuda.max_memory_allocated() - base

    torch.backends.cudnn.deterministic = True
    try:
        # one step: the targets as optimize_frame captures them
        c = one._frame_content(torch.from_numpy(frames[1]).to(dev), hw, None, None)
        warped = grid_sample(prev, warp_map_from_flow(torch.from_numpy(flow).to(dev), hw))
        wts = resize_bilinear(torch.from_numpy(weights).to(dev).float()[None, None] / 255.0, size=hw)
        style_t = one.style_targets(styles, args.style_blend_weights)
        x = 0.5 * (c + warped)
        one_targets = {"style": style_t, "content": one._content_targets(c),
                       "temporal": one._temporal_targets(warped, wts)}
        step = step_apart(x, one, one_targets, two, {"style": style_t, "content": two._content_targets(c),
                                                     "temporal": two._temporal_targets(warped, wts)})
        step["reliable_share"] = float((weights == 255).mean())
        step["grad_bar"] = 1e-4
        if tensor:
            step["witness_grad_rel"] = grad_witness(one, x, one_targets)
            step["grad_bar"] = max(1e-4, 2 * step["witness_grad_rel"])
        runs = {mode: (run("unsharded", FRAME_PARITY_ITERS, mode), run(key, FRAME_PARITY_ITERS, mode))
                for mode in modes}
        # the witnesses from warp_prev: on "tensor" eight inits one f32 spacing off (TENSOR_NUDGES), else
        # two: the runs follow which pixels L-BFGS's first, sub-spacing step rounds, so whether a nudged run
        # moves is a toss
        witness = {f"ulp_{kind}_{'up' if sign > 0 else 'down'}": run("unsharded", FRAME_PARITY_ITERS, "warp_prev",
                                                                     (kind, sign))
                   for kind, sign in (TENSOR_NUDGES if tensor else (("flat", 1), ("flat", -1)))}
    finally:
        torch.backends.cudnn.deterministic = False
    out = {"one_step": step, "hw": list(hw), "iters": FRAME_PARITY_ITERS, "lr": FRAME_PARITY_LR}

    def apart(p, log, p_ref, log_ref):
        rtol = np.abs(log.sum(axis=1) - log_ref.sum(axis=1)) / np.abs(log_ref.sum(axis=1))
        return {"first_two_rtol": float(rtol[:2].max()), "log_rtol": float(rtol.max()),
                "log_rtol_by_iteration": rtol.tolist(),
                "mean_abs_rel_pastiche": float((p - p_ref).abs().mean() / p_ref.abs().mean()),
                "max_abs_pastiche": float((p - p_ref).abs().max()), "finite": bool(np.isfinite(log).all())}

    for mode, ((p0, l0, peak0), (p2, l2, peak2)) in runs.items():
        out[mode] = {**apart(p2, l2, p0, l0), "temporal_by_iteration": l0[:, -1].tolist(),
                     "peak_bytes_unsharded": peak0, f"peak_bytes_{key}": peak2}
    p0, l0, _ = runs["warp_prev"][0]
    out["warp_prev"]["witness_one_ulp_off"] = {k: apart(p, log, p0, l0) for k, (p, log, _) in witness.items()}
    wit = out["warp_prev"]["witness_one_ulp_off"].values()
    out["warp_prev"]["log_rtol_bar"] = max(1e-4, 2 * max(w["log_rtol"] for w in wit))
    # on "tensor" the init one f32 spacing off alone lands ≈ 1% of mean|p| away on an H100
    out["warp_prev"]["mean_abs_rel_bar"] = max(1e-2, 2 * max(w["mean_abs_rel_pastiche"] for w in wit)) if tensor else 1e-2
    if "random" in out:
        out["random"]["log_rtol_bar"], out["random"]["mean_abs_rel_bar"] = 1e-4, 1e-2
    print(f"frame parity: optimize_frame at {hw[0]}x{hw[1]} (temporal term) on {key} of one card against "
          "unsharded:", json.dumps(out))
    if not (step["loss_rtol"] <= 1e-5 and step["grad_rel"] <= step["grad_bar"] and min(step["terms"]) > 0):
        fail(f"frame parity: one step on {key} against unsharded: {step}")
    for mode, row in ((m, out[m]) for m in runs):
        if not (row["finite"] and row["first_two_rtol"] <= 1e-5 and row["log_rtol"] <= row["log_rtol_bar"]
                and row["mean_abs_rel_pastiche"] <= row["mean_abs_rel_bar"]):
            fail(f"frame parity: optimize_frame from the {mode} init on {key} against unsharded: {row}")
    return out


def run_vid_mesh(results: dict) -> dict[str, dict]:
    """Phase 6j, vid_img on meshes of one card standing in for several:
    phase 5's CLI run (``run_vid_img``: every artifact, finite flows and
    losses, K1's launches against the schedule's formula, 5 per band per
    share per iteration plus captures, and K2's as phase 5's) with ``--gpu
    0,0 --mesh space:2`` and with ``--gpu 0,0,0,0 --mesh
    frames:2,space:2``, each beside phase 5's unsharded run (s per frame,
    wall s, peak memory); between them ``check_vid_frame_parity`` on the
    space:2 run's flow artifacts; then ``optimize_frames`` on space:2 and
    on frames:2,space:2 against unsharded (``run_frames``, 6i's bars).
    Returns each CLI run's launches."""
    counts = {}
    summary = {}
    for key, gpu, mesh in MESH_VID:
        name = f"vid_img_{key}"
        counts[name] = run_vid_img(results, name, gpu=gpu, mesh=mesh)
        if key == "space2":
            summary["frame_parity"] = check_vid_frame_parity(os.path.join(OUT, name))
        shutil.rmtree(os.path.join(OUT, name))
    summary["frames_parity"] = run_frames(results, "vid_mesh_frames", [(key, mesh) for key, _, mesh in MESH_VID])
    beside = {}
    for name in ("vid_img", *(f"vid_img_{key}" for key, _, _ in MESH_VID)):
        if name not in results:  # phase 5 not run (a driver calling this phase alone)
            continue
        r = results[name]
        beside[name] = {"wall_s": r["wall_s"], "peak_bytes": r["peak_bytes"], "s_per_frame_all": r["s_per_frame_all"],
                        "s_per_frame_by_pass": [[p["size"], p["pass"], p["s_per_frame"]] for p in r["passes"]],
                        "launches": r["launches"]}
    summary["beside_unsharded"] = beside
    print("vid_mesh: the CLI runs beside phase 5's unsharded run", json.dumps(beside))
    results["vid_mesh"] = summary
    return counts


def run_vid_tensor(results: dict) -> dict[str, dict]:
    """Phase 6o, vid_img on "tensor", one card standing in for two or four:
    phase 5's CLI run (``run_vid_img``: every artifact, finite flows and
    losses, K1's launches against the schedule's formula, 5 per channel
    share per band per iteration plus captures, and K2's as phase 5's)
    with ``--gpu 0,0 --mesh tensor:2``, cut to its 512 scale (80 iterations
    over 4 passes; phase 5 also runs 1024), beside phase 5's unsharded run
    at 512 (s per frame by pass, wall s, peak memory); on its flow
    artifacts ``check_vid_frame_parity`` on tensor:2 (``optimize_frame`` at
    1024x576, the temporal term on: one step's terms and gradient, 10
    iterations at lr 0.1 from the ``warp_prev`` init, with the bars that
    hold "tensor" runs); then ``optimize_frames`` on tensor:2 and on
    frames:2,tensor:2 (``[cuda:0] * 4``: each row's two channel shares)
    against unsharded (``run_frames``, 6i's bars).  Returns the CLI run's
    and the stacked runs' launches."""
    key, gpu, mesh = VID_TENSOR_CLI
    name = f"vid_img_{key}"
    counts = {name: run_vid_img(results, name, sizes=VID_TENSOR_SIZES, iters=VID_TENSOR_ITERS, gpu=gpu, mesh=mesh)}
    summary = {"frame_parity": check_vid_frame_parity(os.path.join(OUT, name), *VID_TENSOR_FRAME)}
    shutil.rmtree(os.path.join(OUT, name))
    stacked = run_frames(results, "vid_tensor_frames", VID_TENSOR_MESHES)
    counts.update({f"vid_tensor_frames_{k}": v for k, v in stacked.items()})
    beside = {}
    for run in ("vid_img", name):
        if run not in results:  # phase 5 not run (this phase called alone)
            continue
        r = results[run]
        beside[run] = {"wall_s": r["wall_s"], "peak_bytes": r["peak_bytes"], "launches": r["launches"],
                       "s_per_frame_by_pass": [[p["size"], p["pass"], p["s_per_frame"]] for p in r["passes"]
                                               if p["size"] in VID_TENSOR_SIZES]}
    summary["beside_unsharded"] = beside
    print("vid_tensor: the CLI run beside phase 5's unsharded run", json.dumps(beside))
    results["vid_tensor"] = summary
    return counts


def run_img_vid_tensor(results: dict) -> dict[str, dict]:
    """Phase 6p, img_vid on "tensor", one card standing in for two or four:
    ``check_img_vid_window_parity`` on tensor:2 and frames:2,tensor:2
    (``witnessed``: one step and 4 L-BFGS iterations at lr 0.1 at w = 0
    and under w = 1's frozen split, held to twice the unsharded run's own
    difference from an init one f32 spacing off; the off-diagonal products
    an iteration, counted, and their device ms), then phase 6's CLI run
    (``run_img_vid``: the stacks, finite outputs and loss logs, a non-zero
    dynamic term, K1's launches, 10 per channel share per iteration plus
    captures, and the products) with ``--gpu 0,0 --mesh tensor:2``, cut to
    its 256 scale, beside phase 6's unsharded run (s per window, wall s,
    peak memory).  Returns the CLI run's launches."""
    summary = {"window_parity": check_img_vid_window_parity(results, IV_TENSOR_MESHES, "img_vid_tensor",
                                                            witnessed=True)}
    key, gpu, mesh = IV_TENSOR_CLI
    name = f"img_vid_{key}"
    counts = {name: run_img_vid(results, name, gpu, mesh, IV_TENSOR_SIZES)}
    beside = {}
    for run in ("img_vid", name):
        if run not in results:  # phase 6 not run (this phase called alone)
            continue
        r = results[run]
        beside[run] = {"wall_s": r["wall_s"], "peak_bytes": r["peak_bytes"], "launches": r["launches"],
                       "off_diagonal_products": r["off_diagonal_products"],
                       "by_scale": [{k: row[k] for k in ("size", "wall_s", "s_per_window", "ms_per_iter")}
                                    for row in r["scales"] if row["size"] in IV_TENSOR_SIZES]}
    summary["beside_unsharded"] = beside
    print("img_vid_tensor: the CLI run beside phase 6's unsharded run", json.dumps(beside))
    results["img_vid_tensor"] = summary
    return counts


# phase 6q: img_img's pyramid with --fuse_scales (``StyleEngine.optimize_pyramid``):
# phase 4's run fused; fused against the per-scale loop at the first three
# scales (lr 0.1, as 6h's and 6j's gated runs); fused on two meshes of one card
# standing in for two at the first two, 10 iterations a scale, each from the
# unsharded run's init (from the random init L-BFGS at lr 0.1 follows the
# rounding after about 13 at 256²); card against CPU with matching on
FUSED_LOOP_SIZES, FUSED_LOOP_ITERS, FUSED_LR = (256, 512, 724), (20, 20, 10), 0.1
FUSED_MESHES = (("space2", (("space", 2),)), ("tensor2", (("tensor", 2),)))
FUSED_MESH_SIZES, FUSED_MESH_ITERS = (256, 512), (10, 10)
FUSED_CPU_SIZES, FUSED_CPU_ITERS = (64, 96), (8, 4)
# part 4's Adam learning rates: the gated one, then the CLI's (report only: its
# steps of one u8 level flip where the gradient is float noise)
FUSED_CPU_LRS = (0.1, 1.0)


def fused_gram_inputs() -> list[tuple[int, int, int]]:
    """K1's inputs on phase 6q that no other phase's check holds, in order:
    the bands of space:2 and the channel shares of tensor:2 at 256² and
    512², and VGG-19's style layers at 64² and 96² (the card-against-CPU
    run).  Its other inputs are phase 4's."""
    new = {s for side in FUSED_MESH_SIZES for _, axes in FUSED_MESHES for s in tensor_gram_shapes(side, axes)}
    new |= {(1, c, n) for side in FUSED_CPU_SIZES for c, n in vgg_style_shapes(side)}
    return sorted(new - set(similarity_gram_shapes()))


def check_fused_gram(results: dict) -> dict:
    """K1 at every new input of phase 6q, f32, with phase 2's bars and
    times."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = []
    for shape in fused_gram_inputs():
        f = torch.relu(torch.randn(shape, device="cuda", generator=gen))
        row = {"shape": list(shape), **measure_gram(f)}
        rows.append(row)
        print("fused gram", json.dumps(row))
        del f
    results["gram_fused"] = rows
    return {k: sum(r[k] for r in rows) for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")} | {
        "shapes": len(rows), "max_rel_err_f64": max(r["kernel_rel_err_f64"] for r in rows),
        "slower_than_library": [r["shape"] for r in rows if r["kernel_ms"] >= r["library_ms"]]}


def run_fused(results: dict) -> dict[str, int]:
    """Phase 6q: img_img's pyramid with ``--fuse_scales``, every scale's
    tail on the device (``StyleEngine.optimize_pyramid``).

    1. Phase 4's CLI run (VGG-19 f32, L-BFGS history 100, 256→1448 at
       20/20/20/20/10, random init, histogram matching on) with
       ``--fuse_scales``: five PNGs of phase 4's shapes, each scale's loss
       falling over its iterations, K1 exactly phase 4's 475 launches.
       The wall, each scale's ms/iter, the host seconds between one
       scale's last step and the next one's first, the peak memory and the
       synchronising calls, beside phase 4's.
    2. Fused against the per-scale loop at 256/512/724 (20/20/10),
       ``--no_hist_match``, lr 0.1, one random init, under
       ``cudnn.deterministic``, the loop's init of a later scale resized on
       the card as the fused run resizes it: every scale's output and every
       iteration's losses bit for bit, and the fixed bars (every total
       within rtol 1e-4, each output within mean|Δ| 1e-2 of mean|p|).
    3. The fused pyramid at 256/512, 10 iterations a scale, on space:2 and
       tensor:2 (``--gpu 0,0``) against the unsharded fused run, every
       scale from the same init (the unsharded run replays the mesh run's
       resized inits: a mesh output 0.5% of mean|p| apart after 10
       iterations at 256² started the 512 scale 4.5% apart after 10 more),
       with the fixed bars; K1 5 per band or share an iteration + 5 a
       capture.
    4. Card against CPU (``--gpu c``): the fused pyramid with matching on
       at 64 and 96 px (Adam, 8 and 4 iterations), both runs given one
       draw of the colour statistics: at lr 0.1 the loss logs within rtol
       1e-3, atol 1e-6 (as the CPU tests hold the port to JAX) and every
       scale's PNG within the aggregate u8 bars (max ≤ 6, mean ≤ 0.5, ≤ 2%
       of pixels past 2); at the CLI's lr 1 report only (Adam's first
       steps are sign(g), one u8 level, and flip where g is float noise:
       the 96 px scale read 3 levels in one run and 7 in another, PERF.md).

    K1's inputs on the card runs of parts 2–4 are phase 4's or
    ``fused_gram_inputs()``."""
    import importlib

    import numpy as np
    import torch
    from PIL import Image

    from maua_style_tpu_torch import style
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.engine.optimize import to_nchw, to_nhwc
    from maua_style_tpu_torch.ops import gram as G
    from maua_style_tpu_torch.ops.resize import resize_bilinear, scale_shape

    pipeline = importlib.import_module("maua_style_tpu_torch.pipelines.img_img")
    run_dir = os.path.join(OUT, "fused")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    c_path, s_path = write_inputs(run_dir)
    pyramids, loops, spans, seen = [], [], [], set()

    def timed_run(fn, self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(self, *a, **kw)
        torch.cuda.synchronize()
        spans.append((t0, time.perf_counter(), a[5]))
        return out

    def recorded_pyramid(fn, self, *a, **kw):
        outs = fn(self, *a, **kw)
        pyramids.append((outs, self.last_loss_log))
        return outs

    def recorded_optimize(fn, self, *a, **kw):
        out = fn(self, *a, **kw)
        loops.append((out, self.last_loss_log))
        return out

    def argv(out, sizes, iters, *extra):
        return ["--content", c_path, "--style", s_path, "--output_dir", os.path.join(run_dir, out),
                "--image_sizes", ",".join(map(str, sizes)), "--num_iters", ",".join(map(str, iters)),
                "--lbfgs_num_correction", "100", "--model_file", "vgg19", "--allow_random_weights",
                "--precision", "highest", "--compute_dtype", "float32", "--seed", "0", *extra]

    def apart_from(outs, log, refs, ref_log):
        """Every iteration's total loss (rtol) and each scale's output
        (mean|Δ| over mean|p|, max|Δ|) against a reference run's."""
        a, b = log.sum(axis=1), ref_log.sum(axis=1)
        rtol = np.abs(a - b) / np.abs(b)
        return {"totals_rtol": float(rtol.max()), "totals_rtol_by_iteration": rtol.tolist(),
                "outputs": [{"mean_abs_rel": float(np.abs(o - r).mean() / np.abs(r).mean()),
                             "max_abs": float(np.abs(o - r).max())} for o, r in zip(outs, refs)]}

    summary = {}
    # 1. phase 4's run, fused
    with patched((StyleEngine, "_run", timed_run), (StyleEngine, "optimize_pyramid", recorded_pyramid)):
        syncs: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        with counting_syncs(syncs):
            style.main(argv("main", SIZES, ITERS, "--optimizer", "lbfgs", "--gpu", "0", "--verbose",
                            "--print_iter", "10", "--fuse_scales"))
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() - base
    expected = sum(STYLE_LAYERS * (it + 1) for it in ITERS)
    if counts["gram"] != expected or len(pyramids) != 1 or len(spans) != len(SIZES):
        fail(f"fused: K1 {counts['gram']} (expected {expected}), {len(pyramids)} pyramid(s), {len(spans)} step runs")
    _, log = pyramids.pop()
    if log.shape[0] != sum(ITERS) or not np.isfinite(log).all():
        fail(f"fused: loss log {log.shape} not finite or not {sum(ITERS)} iterations")
    rows, start = [], 0
    main = results["main_path"]
    for size, iters, (t0, t1, n), ref in zip(SIZES, ITERS, spans, main["scales"]):
        png = os.path.join(run_dir, "main", f"content_style_{size}.png")
        want_hw = tuple(scale_shape((1024, 1024), size / 1024))
        if not os.path.exists(png):
            fail(f"fused: missing {png}")
        with Image.open(png) as img:
            if (img.height, img.width) != want_hw:
                fail(f"fused: {png} is {img.height}x{img.width}, expected {want_hw}")
        first, last = float(log[start].sum()), float(log[start + iters - 1].sum())
        start += iters
        if n != iters or not last < first:
            fail(f"fused: scale {size}: {n} steps, last total {last:g} not below first {first:g}")
        rows.append({"size": size, "iters": iters, "ms_per_iter": (t1 - t0) * 1e3 / n,
                     "phase4_ms_per_iter": ref["ms_per_iter_steps"], "first_total": first, "last_total": last})
    between = [b[0] - a[1] for a, b in zip(spans, spans[1:])]
    summary["main"] = {"wall_s": wall, "phase4_wall_s": main["wall_s"], "scales": rows, "between_scales_s": between,
                       "phase4_between_scales_s": main["between_scales_s"], "peak_bytes": peak,
                       "phase4_peak_bytes": main["peak_bytes"], "syncs": syncs, "phase4_syncs": main["syncs"],
                       "launches": counts}
    print("fused: phase 4's run with --fuse_scales beside phase 4's", json.dumps(summary["main"]))
    shutil.rmtree(os.path.join(run_dir, "main"))

    # 2. fused against the loop; 3. fused on meshes
    loop_args = ("--optimizer", "lbfgs", "--learning_rate", str(FUSED_LR), "--no_hist_match")
    engine_module = importlib.import_module("maua_style_tpu_torch.engine.optimize")

    def pyramid(out, sizes, iters, *extra):
        with patched((StyleEngine, "optimize_pyramid", recorded_pyramid)):
            style.main(argv(out, sizes, iters, *loop_args, "--fuse_scales", *extra))
        return pyramids.pop()

    def resized_on_card(fn, x, size=None, scale_factor=None):
        """The loop's init of a later scale resized as ``optimize_pyramid``
        resizes the previous output: NCHW on the card (the content's
        pre-scaling, by ``scale_factor``, stays on the host in both)."""
        if size is None:
            return fn(x, scale_factor=scale_factor)
        return to_nhwc(resize_bilinear(to_nchw(x, "cuda"), size=size))

    def inits_into(inits):
        """A ``patched`` wrapper of the engine's ``resize_bilinear`` that keeps
        each later scale's resized init (img_img's fused run resizes nothing
        else there)."""
        def wrapper(fn, x, size):
            inits.append(fn(x, size=size).clone())
            return inits[-1]

        return wrapper

    def within(apart):
        """``apart`` with the fixed bars: every total within rtol 1e-4, each
        scale's output within mean|Δ| 1e-2 of mean|p|."""
        ok = apart["totals_rtol"] <= 1e-4 and all(o["mean_abs_rel"] <= 1e-2 for o in apart["outputs"])
        return {**apart, "ok": ok}

    torch.backends.cudnn.deterministic = True
    try:
        with patched((G._GramFn, "apply", gram_inputs_into(seen))):
            with patched((StyleEngine, "optimize", recorded_optimize),
                         (pipeline, "resize_bilinear_np", resized_on_card)):
                t0 = time.perf_counter()
                style.main(argv("loop", FUSED_LOOP_SIZES, FUSED_LOOP_ITERS, *loop_args, "--gpu", "0"))
                loop_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fused_outs, fused_log = pyramid("fused", FUSED_LOOP_SIZES, FUSED_LOOP_ITERS, "--gpu", "0")
            fused_s = time.perf_counter() - t0
            loop_outs, loop_logs = zip(*loops)
            # every scale starts from the same init in both: bit for bit
            same = bool(all(np.array_equal(f, lo) for f, lo in zip(fused_outs, loop_outs))
                        and np.array_equal(fused_log, np.concatenate(loop_logs)))
            summary["vs_loop"] = {**within(apart_from(fused_outs, fused_log, loop_outs, np.concatenate(loop_logs))),
                                  "bit_for_bit": same, "loop_wall_s": loop_s, "fused_wall_s": fused_s}
            print("fused: against the per-scale loop", json.dumps(summary["vs_loop"]))
            # each mesh against the unsharded run, every scale from the same
            # init: the later scales' from the mesh run's own gather and resize
            summary["meshes"] = {}
            for key, axes in FUSED_MESHES:
                inits = []
                reset_counts()
                with patched((engine_module, "resize_bilinear", inits_into(inits))):
                    outs, mlog = pyramid(key, FUSED_MESH_SIZES, FUSED_MESH_ITERS, "--gpu", "0,0", "--mesh",
                                         mesh_arg(axes))
                launches = read_counts()
                want = sum(STYLE_LAYERS * (2 * it + 1) for it in FUSED_MESH_ITERS)
                if launches != {"gram": want, "correlation": 0}:
                    fail(f"fused on {key}: launches {launches}, expected K1 {want}")
                with patched((engine_module, "resize_bilinear", lambda fn, x, size, _it=iter(inits): next(_it))):
                    ref_outs, ref_log = pyramid(f"{key}_unsharded", FUSED_MESH_SIZES, FUSED_MESH_ITERS, "--gpu", "0")
                summary["meshes"][key] = {**within(apart_from(outs, mlog, ref_outs, ref_log)), "launches": launches}
                print(f"fused on {key} against unsharded", json.dumps(summary["meshes"][key]))
    finally:
        torch.backends.cudnn.deterministic = False
    if not same:
        fail("fused: a scale differs from the loop's started from the same init (bit for bit)")
    for what, apart in (("the loop", summary["vs_loop"]), *summary["meshes"].items()):
        if not apart["ok"]:
            fail(f"fused against {what}: {apart} past its bars")

    # 4. card against CPU, one draw of the colour statistics in both
    draw = pipeline.style_hist_stats

    def replayed(source, mode="avg"):
        return draw(source, mode=mode, rng=np.random.default_rng(0))

    summary["card_vs_cpu"] = {}
    pipeline.style_hist_stats = replayed
    try:
        for lr in FUSED_CPU_LRS:
            cpu_args = ("--optimizer", "adam", "--learning_rate", str(lr), "--fuse_scales")
            with patched((G._GramFn, "apply", gram_inputs_into(seen)), (StyleEngine, "optimize_pyramid",
                                                                        recorded_pyramid)):
                style.main(argv(f"card{lr}", FUSED_CPU_SIZES, FUSED_CPU_ITERS, *cpu_args, "--gpu", "0"))
            t0 = time.perf_counter()
            with patched((StyleEngine, "optimize_pyramid", recorded_pyramid)):
                style.main(argv(f"cpu{lr}", FUSED_CPU_SIZES, FUSED_CPU_ITERS, *cpu_args, "--gpu", "c"))
            cpu_s = time.perf_counter() - t0
            (_, card_log), (_, cpu_log) = pyramids[-2:]
            del pyramids[-2:]
            drift = []
            for size in FUSED_CPU_SIZES:
                png = f"content_style_{size}.png"
                a, b = (np.asarray(Image.open(os.path.join(run_dir, f"{d}{lr}", png))).astype(int)
                        for d in ("card", "cpu"))
                d = np.abs(a - b)
                drift.append({"size": size, "max": int(d.max()), "mean": float(d.mean()),
                              "past_2": float((d > 2).mean())})
            summary["card_vs_cpu"][f"lr {lr}"] = {
                "u8": drift, "loss_rtol": float((np.abs(card_log - cpu_log) / np.abs(cpu_log).clip(1e-30)).max()),
                "losses_close": bool(np.allclose(card_log, cpu_log, rtol=1e-3, atol=1e-6)), "cpu_s": cpu_s}
    finally:
        pipeline.style_hist_stats = draw
    print("fused: card against CPU", json.dumps(summary["card_vs_cpu"]))
    gated = summary["card_vs_cpu"][f"lr {FUSED_CPU_LRS[0]}"]
    if not (gated["losses_close"] and all(d["max"] <= 6 and d["mean"] <= 0.5 and d["past_2"] <= 0.02
                                          for d in gated["u8"])):
        fail(f"fused: card against CPU at lr {FUSED_CPU_LRS[0]} past the bars (loss log rtol 1e-3, u8): {gated}")
    checked = {(1, c, n) for size in SIZES for c, n in vgg_style_shapes(size)} | set(fused_gram_inputs())
    if seen - checked:
        fail(f"fused: K1 inputs {sorted(seen - checked)} not among phase 2's")
    results["fused"] = summary
    shutil.rmtree(run_dir)
    return counts


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU (module docstring).")
    parser.add_argument("--only", default="", help="comma-separated phase functions to run alone, in this order, "
                        "after the builds (e.g. check_fused_gram,run_main_path,run_fused); prints no kernels or ok line")
    only = [name for name in parser.parse_args(argv).only.split(",") if name]
    t_start = time.perf_counter()
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
    # nvcc for sm_90a, from the sources in this checkout: the libraries and K2's ptxas -v reports, all at once
    with ThreadPoolExecutor(len(corr_libs)) as pool:
        reports = [pool.submit(build.ptxas_report, name, defines) for name, defines in corr_libs]
        build_s = build.build(["gram", *corr_libs])
        print(f"kernel builds (parallel): {json.dumps(build_s)}, {time.perf_counter() - t0:.1f} s in all")
        ptxas = {" ".join(defines): r.result() for (_, defines), r in zip(corr_libs, reports)}
    print(f"ptxas -v reports beside them: {time.perf_counter() - t0:.1f} s in all")
    for key, log in ptxas.items():
        print(f"ptxas -v, correlation.cu {key}:")
        print("\n".join(line for line in log.splitlines() if "Function properties" in line or "registers" in line
                        or "spill" in line or "Compiling entry" in line))

    os.makedirs(OUT, exist_ok=True)
    results = {"card": smi, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
               "cuda": torch.version.cuda, "build_s": build_s, "ptxas_correlation": ptxas}
    try:
        if only:
            for name in only:
                t0 = time.perf_counter()
                globals()[name](results)
                print(f"chip_smoke: {name} took {time.perf_counter() - t0:.1f} s; the allocator keeps "
                      f"{release_cached()} B unused")
        else:
            gram, corr = run_phases(results)
    finally:
        # the video runs' artifacts (hundreds of MB) go even when a phase fails
        for d in ("vid_img", "vid_img_unflow_liteflownet", "stacked", "img_vid", "flags", "nca", "clip_vqgan",
                  "clip_vqgan_rn50", "clip_video_style", "similarity", "fidelity", "space", "frames", "tuner_scale",
                  *(f"vid_img_{key}" for key, _, _ in MESH_VID), "vid_mesh_frames", "nin_space", "tensor",
                  *(f"img_vid_{key}" for key, _, _ in IV_MESH), f"vid_img_{VID_TENSOR_CLI[0]}", "vid_tensor_frames",
                  f"img_vid_{IV_TENSOR_CLI[0]}", "fused"):
            shutil.rmtree(os.path.join(OUT, d), ignore_errors=True)
        with open(os.path.join(OUT, "results.json"), "w") as f:
            json.dump(results, f, indent=1)

    if only:
        print(f"chip_smoke: {', '.join(only)} passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [gram, corr]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def release_cached() -> int:
    """Hands the caching allocator's unused segments back to the device
    (after a garbage collection) and returns the bytes it still keeps
    unused: free blocks of segments that live tensors hold a part of.  The
    tuner's search budget is the device's free memory, which leaves them
    out."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() - torch.cuda.memory_allocated()


def run_phases(results: dict) -> tuple[dict, dict]:
    """Phases 2 to 7; returns the kernels line's K1 and K2 entries.  Prints
    each phase's seconds (``results["phase_s"]``) and, after each phase has
    handed its unused memory back (``release_cached``), the bytes the
    allocator keeps unused (``results["cached_after_phase"]``)."""
    phase_s = results.setdefault("phase_s", {})

    cached = results.setdefault("cached_after_phase", {})

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        cached[name] = release_cached()
        print(f"chip_smoke: {name} took {phase_s[name]:.1f} s; the allocator keeps {cached[name]} B unused")
        return out

    gram = timed("check_gram", check_gram, results)
    gram["img_vid_shapes"] = timed("check_video_gram", check_video_gram, results)
    gram["nca_shapes"] = timed("check_nca_gram", check_nca_gram, results)
    gram["similarity_shapes"] = timed("check_similarity_gram", check_similarity_gram, results)
    gram["vid_img_shapes"] = timed("check_vid_gram", check_vid_gram, results)
    gram["mesh_shapes"] = timed("check_mesh_gram", check_mesh_gram, results)
    gram["img_vid_mesh_shapes"] = timed("check_img_vid_mesh_gram", check_img_vid_mesh_gram, results)
    gram["nin_shapes"] = timed("check_nin_gram", check_nin_gram, results)
    gram["tensor_shapes"] = timed("check_tensor_gram", check_tensor_gram, results)
    gram["tensor_video_shapes"] = timed("check_tensor_video_gram", check_tensor_video_gram, results)
    gram["fused_shapes"] = timed("check_fused_gram", check_fused_gram, results)
    corr = timed("check_correlation", check_correlation, results)
    img = timed("run_main_path", run_main_path, results)
    timed("check_small_against_cpu", check_small_against_cpu, results)
    timed("profile_step", profile_step, results)
    vid = timed("run_vid_img", run_vid_img, results)
    timed("check_flow_against_cpu", check_flow_against_cpu, results)
    timed("profile_vid_frame", profile_vid_frame, results)
    shutil.rmtree(os.path.join(OUT, "vid_img"))  # ~200 MB of frames and flow, checked above
    timed("check_stacked_against_per_frame", check_stacked_against_per_frame, results)
    vid_d = timed("run_vid_img_unflow_liteflownet", run_vid_img, results, "vid_img_unflow_liteflownet", VD_FLOW,
                  VD_SIZES, VD_ITERS, VD_PASSES)
    shutil.rmtree(os.path.join(OUT, "vid_img_unflow_liteflownet"))
    for nets in VD_FLOW.split(","):
        timed(f"check_flow_against_cpu {nets}", check_flow_against_cpu, results, nets)
    ivid = timed("run_img_vid", run_img_vid, results)
    timed("profile_img_vid_window", profile_img_vid_window, results)
    timed("check_img_vid_against_cpu", check_img_vid_against_cpu, results)
    nca_train_counts, nca_gen_counts = timed("run_nca", run_nca, results)
    timed("check_nca_against_cpu", check_nca_against_cpu, results)
    cv_counts, cv_engine = timed("run_clip_vqgan", run_clip_vqgan, results)
    timed("profile_clip_vqgan", profile_clip_vqgan, results, cv_engine)
    del cv_engine
    timed("check_clip_vqgan_against_cpu", check_clip_vqgan_against_cpu, results)
    rn_counts, rn_engine = timed("run_clip_vqgan_rn50", run_clip_vqgan, results, "clip_vqgan_rn50", "RN50", RN_ITERS)
    timed("profile_clip_vqgan_rn50", profile_clip_vqgan, results, rn_engine, "profile_clip_vqgan_rn50")
    del rn_engine
    timed("check_clip_vqgan_rn50_against_cpu", check_clip_vqgan_against_cpu, results, "RN50",
          "clip_vqgan_rn50_vs_cpu")
    timed("check_clip_embeddings_against_cpu", check_clip_embeddings_against_cpu, results)
    cvs_counts = timed("run_clip_video_style", run_clip_video_style, results)
    shutil.rmtree(os.path.join(OUT, "clip_video_style"))
    sim_counts = timed("run_similarity", run_similarity, results)
    shutil.rmtree(os.path.join(OUT, "similarity"))
    fid_counts = timed("run_fidelity", run_fidelity, results)
    space_counts = timed("run_space", run_space, results)
    frames_counts = timed("run_frames", run_frames, results)["frames2"]
    vid_mesh_counts = timed("run_vid_mesh", run_vid_mesh, results)
    img_vid_mesh_counts = timed("run_img_vid_mesh", run_img_vid_mesh, results)
    nin_counts = timed("run_nin_space", run_nin_space, results)
    vqgan_counts = timed("run_vqgan_space", run_vqgan_space, results)
    tensor_counts = timed("run_tensor", run_tensor, results)
    vid_tensor_counts = timed("run_vid_tensor", run_vid_tensor, results)
    img_vid_tensor_counts = timed("run_img_vid_tensor", run_img_vid_tensor, results)
    fused_counts = timed("run_fused", run_fused, results)
    timed("drive_flags", drive_flags, results)
    timed("check_determinism", check_determinism, results)
    timed("run_tuner", run_tuner, results)  # last: its probes take the card's memory to its limit
    # launches: each path's own count, read right after it ran from zero
    paths = {"img_img": img, "vid_img": vid, "vid_img_unflow_liteflownet": vid_d, "img_vid": ivid,
             "nca_train": nca_train_counts, "nca_gen": nca_gen_counts, "clip_vqgan": cv_counts,
             "clip_vqgan_rn50": rn_counts, "clip_video_style": cvs_counts, "similarity": sim_counts,
             "fidelity": fid_counts, "space": space_counts, "frames": frames_counts, **vid_mesh_counts,
             **img_vid_mesh_counts, **nin_counts, "vqgan_space2": vqgan_counts, **tensor_counts, **vid_tensor_counts,
             **img_vid_tensor_counts, "fused_pyramid": fused_counts}
    gram["launches"] = img["gram"]
    gram["launches_by_path"] = {k: v["gram"] for k, v in paths.items()}
    corr["launches"] = vid["correlation"]
    corr["launches_by_path"] = {k: v["correlation"] for k, v in paths.items()}
    results["kernels"] = [gram, corr]
    return gram, corr


if __name__ == "__main__":
    sys.exit(main())
