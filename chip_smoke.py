#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (maua_style_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught and passed over):

1. Device: the card's name and power limit (nvidia-smi), the torch and CUDA
   versions, and the seconds the kernel build took (``nvcc`` for sm_90a,
   from the sources in this checkout).
2. Kernel check: the Gram kernel (csrc/gram.cu) against its plain PyTorch
   version on the card, f32 and bf16, at the VGG-19 style-layer shapes of a
   1024² image, at ragged shapes of the 724 and 1448 scales and at B = 2
   (bar: max|Δ| / max|G| <= 1e-4), and the backward of the Gram's autograd
   Function against autograd of the plain version.  Times of the kernel,
   the plain version and torch.bmm (TF32 off) by CUDA events, median of 7
   after warm-up, beside the bound.
3. Main path: ``maua_style_tpu_torch.style.main`` on synthetic images
   through the default 256..1448 pyramid with L-BFGS (history 100), VGG-19
   at full width with seeded random weights, f32, --precision highest.
   Checks the five PNGs and their shapes, the loss logs, and that the Gram
   kernel was launched exactly as often as the path implies; prints ms/iter
   per scale.  A small input is then optimised on the GPU and on the CPU
   (whose plain path the CPU tests hold to the JAX package) and compared.
4. Profile: torch.profiler over 5 iterations at 1024², device time by
   kernel and by operator, and the device's busy share (report only).
5. A ``kernels`` JSON line, the card line, and last the ``ok`` line.

Exits non-zero without an ``ok`` line when there is no CUDA device, when
the package is not beside this script, or when any phase fails.  Details
go to chiprun_out/chip_smoke/results.json.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# H100 SXM data sheet (dense): FP32 SIMT, bf16 tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

SIZES = (256, 512, 724, 1024, 1448)
ITERS = (20, 20, 20, 20, 10)
STYLE_LAYERS = 5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def vgg_style_shapes(side: int) -> list[tuple[int, int]]:
    """(C, N) of relu1_1..relu5_1 for a side x side image (floor pools)."""
    out = []
    for c in (64, 128, 256, 512, 512):
        out.append((c, side * side))
        side //= 2
    return out


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


def gram_bound_ms(b: int, c: int, n: int, dtype) -> tuple[float, str]:
    """max(operations / peak, bytes / bandwidth).  G = F Fᵀ is symmetric, so
    the function needs the C(C+1)/2 entries on and above the diagonal:
    2·N·C(C+1)/2 = N·C·(C+1) operations per frame.  Each input element is
    read once, each f32 output written once."""
    import torch

    elt = 4 if dtype == torch.float32 else 2
    ops = 1.0 * b * n * c * (c + 1) / (PEAK_FP32 if dtype == torch.float32 else PEAK_BF16)
    byt = (elt * b * c * n + 4.0 * b * c * c) / PEAK_BYTES
    return max(ops, byt) * 1e3, ("operations" if ops >= byt else "bytes")


def check_gram(results: dict) -> dict:
    import torch

    from maua_style_tpu_torch.ops import gram as G

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
            del f64, exact
            if not rel <= 1e-4:
                fail(f"gram {tuple(shape)} {dtype}: max|d|/max|G| = {rel:.3e} > 1e-4")
            if not torch.equal(G.gram(f), got):
                fail(f"gram {tuple(shape)} {dtype}: two launches differ (must be deterministic)")
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1], "main_path_1024": shape in main,
                   "max_abs_err": err, "rel_err": rel, "kernel_rel_err_f64": rel64[0], "plain_rel_err_f64": rel64[1]}
            ft = f.transpose(1, 2)
            row["kernel_ms"] = time_ms(lambda: G.gram(f))
            row["plain_ms"] = time_ms(lambda: G.gram_reference(f))
            row["library_ms"] = time_ms(lambda: torch.bmm(f, ft))
            row["bound_ms"], row["bound_by"] = gram_bound_ms(b, c, n, dtype)
            rows.append(row)
            print("gram", json.dumps(row))

    # backward of the autograd Function against autograd of the plain version
    f = torch.randn((1, 128, 65536), device=dev, generator=gen).requires_grad_(True)
    w = torch.randn((1, 128, 128), device=dev, generator=gen)
    (gk,) = torch.autograd.grad((G._GramFn.apply(f) * w).sum(), f)
    (gp,) = torch.autograd.grad((G.gram_reference(f) * w).sum(), f)
    rel = float((gk - gp).abs().max() / gp.abs().max())
    print(f"gram backward float32: max|d|/max|g| = {rel:.3e}")
    if not rel <= 1e-4:
        fail(f"gram backward: {rel:.3e} > 1e-4")
    results["gram"] = rows
    f32_main = [r for r in rows if r["main_path_1024"] and r["dtype"] == "float32"]
    return {
        "name": "gram",
        "route": "cuda",
        "source": "maua_style_tpu_torch/csrc/gram.cu",
        "replaces": "maua_style_tpu/ops/pallas_gram.py:22",
        "max_abs_err": max(r["max_abs_err"] for r in f32_main),
        # one iteration's forward Grams at 1024², f32: the five style layers
        "ms": sum(r["kernel_ms"] for r in f32_main),
        "plain_ms": sum(r["plain_ms"] for r in f32_main),
        "bound_ms": sum(r["bound_ms"] for r in f32_main),
        # the term that accounts for more of the summed bound
        "bound_by": max(("operations", "bytes"), key=lambda k: sum(r["bound_ms"] for r in f32_main if r["bound_by"] == k)),
        "library_ms": sum(r["library_ms"] for r in f32_main),
        "checked": True,
    }


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


def run_main_path(results: dict) -> int:
    import numpy as np
    import torch
    from PIL import Image

    from maua_style_tpu_torch import style
    from maua_style_tpu_torch.engine import StyleEngine
    from maua_style_tpu_torch.ops import gram as G
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
        G.gram.launches = 0
        t0 = time.perf_counter()
        style.main(argv)
        wall = time.perf_counter() - t0
        launches = G.gram.launches
    finally:
        StyleEngine.optimize, StyleEngine._run = orig_optimize, orig_run

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
    results["main_path"] = {"wall_s": wall, "gram_launches": launches, "scales": rows, "argv": argv}
    return launches


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


def profile_step(results: dict) -> None:
    """torch.profiler over 5 iterations at 1024² (after a warm-up run):
    device time by kernel and by launching aten operator, the Gram
    kernel's share, and the device's busy share of the wall time.  Report
    only: the numbers feed PERF.md's breakdown."""
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

    cuda = torch.autograd.DeviceType.CUDA
    # device busy time = union of kernel intervals (overlapping kernels count once)
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
    gram_ms = sum(ms for ms, _, name in kernels if "gram_partial" in name or "gram_reduce" in name)
    summary = {
        "iters": 5, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3, "kernel_window_ms": window_us / 1e3,
        "busy_share_of_wall": busy_us / 1e3 / wall_ms, "gram_kernel_ms": gram_ms,
        "top_kernels": kernels[:12], "top_aten_ops": ops[:15],
        "note": "5 iterations at 1024^2 f32, TF32 off, L-BFGS history 100, including content/style capture",
    }
    if not spans:
        summary["note"] += "; the profiler saw no device time (not measured)"
    print("profile", json.dumps(summary))
    results["profile_1024"] = summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from maua_style_tpu_torch.ops import gram as G

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    G._gram_lib()  # nvcc for sm_90a, from the sources in this checkout
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s")

    os.makedirs(OUT, exist_ok=True)
    results = {"card": smi, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
               "cuda": torch.version.cuda, "build_s": build_s}
    entry = check_gram(results)
    entry["launches"] = run_main_path(results)
    check_small_against_cpu(results)
    profile_step(results)
    results["kernels"] = [entry]
    with open(os.path.join(OUT, "results.json"), "w") as f:
        json.dump(results, f, indent=1)

    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
