"""Capacity tuner: the largest image each (model, optimizer) can style, and
how many vid_img frames fit in one stacked step (JAX counterpart:
maua_style_tpu/tuning/max_sizes.py; reference: max-sizes.py).

The reference OOM-probes every (model x optimizer x #GPUs) combination on
CUDA (max-sizes.py:59-111).  Here ``method="analysis"`` is a measured probe
on the card: it builds the port's ``StyleEngine`` at the candidate size,
captures its targets, runs two iterations and reads the CUDA allocator's
peaks (``torch.cuda.max_memory_allocated``, ``max_memory_reserved``); the
search holds the reserved one to the free memory, and an out-of-memory
error counts as over budget.  ``method="estimate"`` is the analytic footprint
(``estimate_step_bytes``), whose constants (``CONSTANTS``) are fitted to
those measured peaks (``fit_constants``), not to XLA's memory analysis on a
TPU.

Like the reference: sizes grow by sqrt(2) from the previous safe size and
results are rounded to multiples of 32 (max-sizes.py:36-41, 96-97); the
table maps "model,optimizer,devices" -> {safe max, true max}.  With
``devices`` = N > 1 the table is JAX's N-device one: the estimate of a
step spatially sharded over N devices, or the measured probe on a
"space:N" mesh of the first N distinct CUDA devices, its footprint the
largest device's.

Usage: python -m maua_style_tpu_torch.tuning.max_sizes [--method estimate|analysis]
"""

from __future__ import annotations

import gc
import json
import math
import os

import numpy as np

DEFAULT_MODELS = ("vgg19", "vgg16", "sod", "nyud", "prune", "nin")
DEFAULT_OPTIMIZERS = ("lbfgs", "adam")

# The footprint model's constants, fitted by ``fit_constants`` to the peaks
# that chip_smoke.py's tuner phase measured on an NVIDIA H100 80GB HBM3
# (700 W): VGG-19 (L-BFGS compact and two-loop, Adam; f32 and bf16) and
# prune (Adam, f32) at 512², 1024² and 2048².  From 1024² up the estimate
# is within 11% of those peaks; at 512² f32 the peaks hold ≈ 0.4 GB more
# (cuDNN's f32 workspaces, not in the model).  JAX's v5e values, fitted to
# XLA's memory analysis, in brackets.
CONSTANTS = {
    # stored forward activations plus the backward's buffers, per byte of
    # activations [2.1]
    "activations": 1.93,
    # per-architecture factor on the activation term [prune 2.1]
    "arch_fudge": {"prune": 1.14},
    # L-BFGS: bytes of history per history row and pastiche byte, by
    # method: the two histories, written in place [5.3 compact, 4.0 two_loop]
    "lbfgs": {"compact": 2.0, "two_loop": 2.0},
    # L-BFGS's other vectors of the pastiche's size [6]
    "lbfgs_pixels": 0.92,
    # the allocator's share of the runtime beyond the weights, bytes [64 MiB]
    "slack": 67_200_000,
}


# the port's tables; the repository's top-level configs/ holds the JAX
# package's, which this tuner never writes
TABLE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def default_table_path(gb: int, devices: int = 1) -> str:
    """Where the CLI writes a table without ``--out``: the port's
    ``configs/`` under JAX's file name."""
    return os.path.join(TABLE_DIR, f"max-sizes-{gb}GB-{devices}chip.json")


def _round32(x: float) -> int:
    return int(x // 32 * 32)


def _loss_cfg_for(model: str):
    """Per-arch default loss layers (NIN has its own names, see
    configs/scaling-img.json)."""
    from ..losses import LossConfig

    if model == "nin":
        return LossConfig(
            content_layers=("relu8",),
            style_layers=("relu1", "relu3", "relu5", "relu7", "relu9", "relu11"),
        )
    return LossConfig()


def _bf16(compute_dtype: str) -> bool:
    return compute_dtype in ("bfloat16", "bf16")


def _terms(model: str, size: int, compute_dtype: str) -> tuple[float, float, float]:
    """(pastiche bytes, stored activation bytes at the compute dtype,
    parameter bytes) of one step at size x size."""
    from ..models import select_model, truncate_spec

    spec = truncate_spec(select_model(model, "max"), _loss_cfg_for(model).all_layers)
    f32 = 4
    act_el = 2 if _bf16(compute_dtype) else 4
    h = w = size
    act_bytes = 0
    ch = spec.in_ch
    for layer in spec.layers:
        if layer.kind == "conv":
            h = (h + 2 * layer.pad[0] - layer.kernel[0]) // layer.stride[0] + 1
            w = (w + 2 * layer.pad[1] - layer.kernel[1]) // layer.stride[1] + 1
            ch = layer.out_ch
            act_bytes += h * w * ch * f32
        elif layer.kind in ("maxpool", "avgpool"):
            if layer.ceil_mode:
                h = -(-(h - layer.kernel[0]) // layer.stride[0]) + 1
                w = -(-(w - layer.kernel[1]) // layer.stride[1]) + 1
            else:
                h = (h - layer.kernel[0]) // layer.stride[0] + 1
                w = (w - layer.kernel[1]) // layer.stride[1] + 1
            act_bytes += h * w * ch * f32
    params_bytes = 0
    cin = spec.in_ch
    for l in spec.conv_layers:
        params_bytes += l.kernel[0] * l.kernel[1] * cin * l.out_ch * f32
        cin = l.out_ch
    return size * size * 3 * f32, act_bytes * (act_el / f32), params_bytes


def estimate_step_bytes(model: str, optimizer: str, size: int, lbfgs_history: int = 100,
                        layers=None, lbfgs_method: str = "compact", devices: int = 1,
                        compute_dtype: str = "float32", _split_fixed: bool = False):
    """Analytic per-device footprint of one style-transfer step at
    size x size: the pastiche, the stored activations and the backward's
    buffers, the optimizer state, the weights and the runtime slack (JAX's
    terms, with ``CONSTANTS``).  ``devices`` > 1 is JAX's spatially sharded
    step, a device's share of it (``/ devices * 1.03``: the bands' halo
    rows and the replicated state).
    bf16 halves the activations and, as the engine stores them in bf16,
    the L-BFGS histories."""
    k = CONSTANTS
    pixels, acts, params_bytes = _terms(model, size, compute_dtype)
    total = pixels + acts * k["activations"] * k["arch_fudge"].get(model, 1.0)
    if optimizer == "adam":
        total += 2 * pixels  # mu, nu
    else:
        factor = k["lbfgs"][lbfgs_method] * (0.5 if _bf16(compute_dtype) else 1.0)
        total += factor * lbfgs_history * pixels + k["lbfgs_pixels"] * pixels
    if devices > 1:
        total = total / devices * 1.03
    fixed = params_bytes + k["slack"]
    if _split_fixed:
        return int(total), int(fixed)
    return int(total + fixed)


def _frame_size(out_hw: tuple[int, int]) -> int:
    return max(32, _round32(math.sqrt(out_hw[0] * out_hw[1]) + 31))


def frames_per_program(
    model: str,
    optimizer: str,
    out_hw: tuple[int, int],
    *,
    lbfgs_history: int = 100,
    lbfgs_method: str = "compact",
    compute_dtype: str = "float32",
    hbm: int | None = None,
    cap: int = 16,
) -> int:
    """How many independent frames fit in ONE stacked step
    (``StyleEngine.optimize_frames``): each stacked frame pays the whole
    per-frame step state, the weights and the slack are shared, and 70% of
    the device memory is the budget (JAX's rule: the rest absorbs the
    estimate's error and the allocator's fragmentation)."""
    per_frame, fixed = estimate_step_bytes(
        model, optimizer, _frame_size(out_hw), lbfgs_history, lbfgs_method=lbfgs_method,
        compute_dtype=compute_dtype, _split_fixed=True,
    )
    budget = (hbm if hbm is not None else hbm_bytes()) * 0.7 - fixed
    return int(max(1, min(cap, budget // max(per_frame, 1))))


def chain_frames_per_program(
    model: str,
    optimizer: str,
    out_hw: tuple[int, int],
    *,
    lbfgs_history: int = 100,
    lbfgs_method: str = "compact",
    compute_dtype: str = "float32",
    hbm: int | None = None,
    cap: int = 16,
) -> int:
    """How many chained frames one ``optimize_frame_chain`` call takes: one
    frame's step state plus the stacked per-frame inputs and outputs
    (content u8, flow, reliability, blend u8, display u8: 24 B/px), in
    JAX's 70% budget, capped."""
    per_frame, fixed = estimate_step_bytes(
        model, optimizer, _frame_size(out_hw), lbfgs_history, lbfgs_method=lbfgs_method,
        compute_dtype=compute_dtype, _split_fixed=True,
    )
    budget = (hbm if hbm is not None else hbm_bytes()) * 0.7 - fixed - per_frame
    stacked_inputs = out_hw[0] * out_hw[1] * 24
    return int(max(1, min(cap, budget // max(stacked_inputs, 1))))


def probe_devices(devices: int = 1, device=None) -> list:
    """The CUDA devices a probe of ``devices`` runs on: ``device`` (CUDA
    device 0 unless another is named) for one; the first N distinct CUDA
    devices for N > 1 (a mesh of one card repeated would read the sum of
    the bands, not a device's peak).  Raises ``RuntimeError`` without a
    CUDA device, or with fewer than N, as JAX's sharded probe does."""
    import torch

    from ..engine.optimize import resolve_device

    if devices > 1:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < devices:
            raise RuntimeError(f"need {devices} devices for the sharded probe, have {have} CUDA device(s)")
        return [torch.device("cuda", i) for i in range(devices)]
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the measured probe reads the CUDA allocator's peak: it needs a CUDA device")
    return [dev]


def measure_step(model: str, optimizer: str, size: int, compute_dtype: str = "bfloat16",
                 lbfgs_method: str = "compact", device=None, devices: int = 1) -> dict | None:
    """The measured probe: build the port's ``StyleEngine`` at size x size
    (``init_params`` seed 0; precision "default" for bf16, "highest" for
    f32), capture its content and style targets and run two iterations;
    with ``devices`` = N > 1 on a "space:N" mesh of the first N distinct
    CUDA devices (``probe_devices``), as JAX's probe shards its step.
    Returns the CUDA allocator's peaks above where they stood before, what
    tensors took (``allocated``, ``max_memory_allocated``) and what the
    allocator took from the device (``reserved``, ``max_memory_reserved``:
    its blocks' rounding and splits besides), and the device's free memory
    before the probe (``free``, ``torch.cuda.mem_get_info``); on N devices
    each the largest device's (the least free memory).  None when a card
    runs out of memory.  Everything the probe made is freed before it
    returns."""
    import torch

    from ..engine.optimize import StyleEngine
    from ..models import init_params, select_model
    from ..parallel import build_mesh

    devs = probe_devices(devices, device)
    bf16 = _bf16(compute_dtype)
    base, base_reserved, free = {}, {}, {}
    for dev in devs:
        torch.cuda.synchronize(dev)
        base[dev], base_reserved[dev] = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        free[dev] = torch.cuda.mem_get_info(dev)[0]
        torch.cuda.reset_peak_memory_stats(dev)
    engine = None
    try:
        spec = select_model(model, "max")
        engine = StyleEngine(
            spec, init_params(spec, 0), _loss_cfg_for(model), optimizer=optimizer, learning_rate=1.0,
            lbfgs_method=lbfgs_method, compute_dtype=torch.bfloat16 if bf16 else torch.float32,
            precision="default" if bf16 else "highest", device=devs[0],
            mesh=build_mesh(devs, [("space", len(devs))]) if len(devs) > 1 else None,
        )
        rng = np.random.default_rng(0)
        content = rng.standard_normal((1, size, size, 3), dtype=np.float32) * 50
        style = np.ascontiguousarray(content[:, ::-1])
        engine.optimize(content, [style], content, 2)
        for dev in devs:
            torch.cuda.synchronize(dev)
        return {"allocated": int(max(torch.cuda.max_memory_allocated(d) - base[d] for d in devs)),
                "reserved": int(max(torch.cuda.max_memory_reserved(d) - base_reserved[d] for d in devs)),
                "free": int(min(free.values()))}
    except torch.cuda.OutOfMemoryError:
        return None
    finally:
        engine = None
        gc.collect()
        torch.cuda.empty_cache()


def measure_step_bytes(model: str, optimizer: str, size: int, compute_dtype: str = "bfloat16",
                       lbfgs_method: str = "compact", device=None, devices: int = 1, allocated: bool = False):
    """The measured search's probe: ``measure_step``'s ``reserved`` peak,
    what the allocator took from the device (held to the free memory), or
    None when a card runs out of memory.  ``allocated=True`` returns
    (reserved, allocated): the search predicts the next size from what
    tensors took, which grows as size², while the reserved peak levels off
    under the free memory near the card's limit (the allocator hands back
    its cached blocks and retries instead of failing).  ``fit_constants``
    fits the ``allocated`` peaks too."""
    got = measure_step(model, optimizer, size, compute_dtype, lbfgs_method, device, devices)
    if got is None:
        return None
    return (got["reserved"], got["allocated"]) if allocated else got["reserved"]

def fit_constants(rows, lbfgs_history: int = 100) -> dict:
    """``CONSTANTS`` fitted to measured peaks: ``rows`` of (model,
    optimizer, lbfgs_method, compute_dtype, size, measured bytes), in
    three least-squares steps, each row weighted by 1/bytes:

    1. the L-BFGS terms from VGG-19's L-BFGS peak less its Adam peak at the
       same size and dtype (activations, weights and slack cancel): each
       method's history factor and the pixel term;
    2. the activation factor and the slack from VGG-19's Adam peaks;
    3. each other model's factor on the activation term: its rows'
       bytes beyond the other terms over their activation term."""
    peaks = {(r[0], r[1], r[2], r[3], r[4]): r[5] for r in rows}
    methods = sorted({r[2] for r in rows if r[0] == "vgg19" and r[1] == "lbfgs"})
    a, b = [], []
    for (model, optimizer, method, dtype, size), got in peaks.items():
        adam = next((v for k, v in peaks.items() if k[:2] == ("vgg19", "adam") and k[3:] == (dtype, size)), None)
        if model != "vgg19" or optimizer != "lbfgs" or adam is None:
            continue
        pixels = _terms(model, size, dtype)[0]
        row = [0.0] * (len(methods) + 1)
        row[methods.index(method)] = lbfgs_history * pixels * (0.5 if _bf16(dtype) else 1.0)
        row[-1] = pixels
        a.append(np.asarray(row) / got)
        b.append((got - adam + 2 * pixels) / got)
    lbfgs = np.linalg.lstsq(np.asarray(a), np.asarray(b), rcond=None)[0] if a else None
    a, b = [], []
    for (model, optimizer, _, dtype, size), got in peaks.items():
        if model == "vgg19" and optimizer == "adam":
            pixels, acts, params_bytes = _terms(model, size, dtype)
            a.append(np.asarray([acts, 1.0]) / got)
            b.append((got - 3 * pixels - params_bytes) / got)
    act, slack = np.linalg.lstsq(np.asarray(a), np.asarray(b), rcond=None)[0]
    fitted = {
        "activations": float(act),
        "arch_fudge": {},
        "lbfgs": {m: float(lbfgs[i]) for i, m in enumerate(methods)} if lbfgs is not None else CONSTANTS["lbfgs"],
        "lbfgs_pixels": float(lbfgs[-1]) if lbfgs is not None else CONSTANTS["lbfgs_pixels"],
        "slack": int(slack),
    }
    for model in sorted({r[0] for r in rows if r[0] != "vgg19"}):
        rest_sum = act_sum = 0.0
        for (m, optimizer, method, dtype, size), got in peaks.items():
            if m != model:
                continue
            pixels, acts, params_bytes = _terms(model, size, dtype)
            rest = got - pixels - params_bytes - fitted["slack"]
            if optimizer == "adam":
                rest -= 2 * pixels
            else:
                rest -= (fitted["lbfgs"][method] * (0.5 if _bf16(dtype) else 1.0) * lbfgs_history
                         + fitted["lbfgs_pixels"]) * pixels
            rest_sum += rest
            act_sum += acts * fitted["activations"]
        fitted["arch_fudge"][model] = rest_sum / act_sum
    return fitted


def hbm_bytes(device=None) -> int:
    """The device's memory: a CUDA device's ``total_memory`` (CUDA device 0
    unless another is named; without CUDA that raises), or 16 GiB for the
    CPU, JAX's value for a device without memory statistics."""
    import torch

    from ..engine.optimize import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return 16 * 1024 ** 3
    return int(torch.cuda.get_device_properties(dev).total_memory)


def search_budget_bytes(device=None, devices: int = 1) -> int:
    """The measured search's budget: the device's free memory at the
    search's start (``torch.cuda.mem_get_info``), after the caching
    allocator has handed back the blocks it holds unused; on N devices the
    least of theirs (``probe_devices``).  Unlike ``total_memory`` it leaves
    out the CUDA context, the cuDNN and cuBLAS handles and whatever the
    process keeps alive, so a size the search calls safe also fits in a
    process that ran other work first.  The search holds each probe's
    ``reserved`` peak to it: what the allocator took from the device, its
    blocks' rounding and splits included.  A CUDA device is required (CUDA
    device 0 unless another is named)."""
    import torch

    try:
        devs = probe_devices(devices, device)
    except RuntimeError as e:
        raise RuntimeError(f"the measured search's budget is a CUDA device's free memory: {e}") from None
    gc.collect()
    torch.cuda.empty_cache()
    return int(min(torch.cuda.mem_get_info(d)[0] for d in devs))


# the step up from the best fit where the fitted boundary lies below it and no
# probe has failed yet: a quarter octave (the reference's ladder is sqrt(2))
STALL_STEP = 2 ** 0.25


def _boundary(fits, budget: int) -> float:
    """The size at which the footprint the prediction follows reaches
    ``budget``: affine in size² through the two largest of ``fits``
    ((size, bytes) measured under budget), or through the largest and the
    origin where there is one fit or the two do not rise."""
    (s1, a1), *rest = sorted(fits, reverse=True)
    if rest:
        s0, a0 = rest[0]
        alpha = (a1 - a0) / (s1 * s1 - s0 * s0)
        if alpha > 0:
            return math.sqrt(max(budget - (a1 - alpha * s1 * s1), 0.0) / alpha)
    return s1 * math.sqrt(budget / max(a1, 1))


def probe_max_sizes(
    models=DEFAULT_MODELS,
    optimizers=DEFAULT_OPTIMIZERS,
    method: str = "estimate",
    start_size: int = 512,
    budget_bytes: int | None = None,
    verbose: bool = True,
    devices: int = 1,
    compute_dtype: str = "bfloat16",
    seed_table: dict | None = None,
) -> dict:
    """Build the capacity table (reference max-sizes.py:59-111); ``devices``
    = N > 1 sizes a step spatially sharded over N devices (JAX's N-device
    table: the estimate's ``/ N * 1.03``, or the measured probe on N
    distinct CUDA devices, which raises with fewer).

    The boundary search interpolates on the MEASURED footprint rather than
    bisecting on fit/no-fit: bytes(s) is nearly affine in s², so a
    quadratic model through the best fitting and smallest failing probes
    lands within a rung or two of the x32 boundary.  A probe that fails
    without a footprint (out of memory) counts as over budget.

    The measured probe's fit test is its ``reserved`` peak, but its
    prediction follows the ``allocated`` one (``_boundary``, the nearest
    rung): near the card's limit the reserved peak levels off under the
    free memory while what tensors take still grows as size², and a
    prediction from the reserved peak stalls on the best fit (it crept up
    32 px a probe).  Where the fitted boundary lies within one rung above
    the best fit and no probe has failed yet, the next probe is the next
    rung; where it lies below the fit (what tensors took passed the budget
    and the probe still fitted), the next probe is ``STALL_STEP`` (a
    quarter octave) above it.  Where a probe ran out of memory no more
    than a rung below the fitted boundary, the next is the boundary's rung
    (clamped inside the bracket), twice at most before a bisection; a
    fitted boundary further past the failure (the model is wrong there)
    bisects.  Wherever the footprint is monotone in size the
    search ends on the same 32-px bracket as JAX's."""
    if method == "analysis" and devices > 1:
        probe_devices(devices)  # JAX's "need N devices for the sharded probe", before any probe
    if budget_bytes is not None:
        budget = budget_bytes
    else:  # the measured search runs in this process: what is free here; the estimate sizes a whole card
        budget = search_budget_bytes(devices=devices) if method == "analysis" else hbm_bytes()

    def probe_bytes(model, optimizer, size):
        """(Footprint at ``size`` held to the budget, footprint the
        prediction follows) in bytes, or None if the probe failed without
        reporting one (counts as over budget).  A probe that reports one
        number gives it for both."""
        try:
            if method == "estimate":
                b = estimate_step_bytes(model, optimizer, size, devices=devices, compute_dtype=compute_dtype)
                return b, b
            got = measure_step_bytes(model, optimizer, size, compute_dtype=compute_dtype, devices=devices,
                                     allocated=True)
            return got if got is None or isinstance(got, tuple) else (got, got)
        except Exception as e:  # a failed probe counts as over budget
            if verbose:
                print(f"{model}+{optimizer}@{size}: probe error {str(e)[:200]}")
            return None

    gib = 1024 ** 3
    table: dict[str, dict] = {}
    prev_safe = start_size
    for model in models:
        for optimizer in optimizers:
            seed = (seed_table or {}).get(f"{model},{optimizer},{devices}", {}).get("safe_max_size")
            size = _round32(seed) if seed else max(_round32(prev_safe / math.sqrt(2)), 256)
            size = max(size, 64)
            fit = None   # (size, bytes) — largest size measured under budget
            fail = None  # (size, bytes|None) — smallest size measured over
            fits = []    # (size, predicted-from bytes) of every size measured under budget
            probed: set[int] = set()
            guesses = 0  # the fitted boundary's rungs probed since the last bisection
            for _ in range(24):  # hard cap; typical combo needs 3-4 probes
                probed.add(size)
                got = probe_bytes(model, optimizer, size)
                b, a = got if got is not None else (None, None)
                if verbose and method != "estimate":
                    what = "?" if b is None else (f"reserved {b / gib:.2f} GiB, allocated {a / gib:.2f} GiB, "
                                                  f"budget {budget / gib:.2f} GiB")
                    print(f"  {model}+{optimizer}@{size}: {what}", flush=True)
                if b is not None and b <= budget:
                    fits.append((size, a))
                    if fit is None or size > fit[0]:
                        fit = (size, b)
                else:
                    if fail is None or size < fail[0]:
                        fail = (size, b)
                # converged: bracket is x32-tight
                if fit and fail and fail[0] - fit[0] <= 32:
                    break
                # choose the next candidate
                if fit is None:
                    if fail[0] <= 64:
                        break
                    size = max(_round32(fail[0] / math.sqrt(2)), 32)
                elif fail is None:
                    s1 = fit[0]
                    if s1 >= 16320:
                        break  # effectively unbounded
                    bound = _boundary(fits, budget)
                    pred = _round32(bound + 16)  # the nearest rung
                    if pred <= s1 + 32:  # the boundary within a rung above the fit: the next rung, else stalled
                        pred = s1 + 32 if bound >= s1 else _round32(s1 * STALL_STEP)
                    size = pred
                    size = max(min(size, 16352), s1 + 32)
                else:
                    (s1, b1), (s2, b2) = fit, fail
                    pred = _boundary(fits, budget)
                    if b2 is not None and s2 * s2 > s1 * s1:
                        alpha = (b2 - b1) / (s2 * s2 - s1 * s1)
                        beta = b1 - alpha * s1 * s1
                        val = (budget * 0.999 - beta) / alpha if alpha > 0 else -1.0
                        size = _round32(math.sqrt(val)) if val > 0 else _round32((s1 + s2) / 2)
                        guesses = 0
                    elif pred < s2 + 32 and guesses < 2:  # out of memory within a rung of the fitted boundary
                        size, guesses = _round32(pred + 16), guesses + 1
                    else:
                        size, guesses = _round32((s1 + s2) / 2), 0
                    size = min(max(size, s1 + 32), s2 - 32)
                if size in probed:  # model stalled on a probed rung: bisect
                    if fit and fail:
                        size = _round32((fit[0] + fail[0]) / 2)
                        size = min(max(size, fit[0] + 32), fail[0] - 32)
                    if size in probed:
                        break
            safe = fit[0] if fit else None
            true = fail[0] if fail else None
            key = f"{model},{optimizer},{devices}"
            table[key] = {
                "model": model,
                "optimizer": optimizer,
                "devices": devices,
                "safe_max_size": safe,
                "true_max_size": true,
                "budget_gb": round(budget / 1024 ** 3, 2),
                "method": method,
                "compute_dtype": compute_dtype,
            }
            if verbose:
                print(f"{key}: safe {safe} / true {true}")
            prev_safe = safe or prev_safe
    return table


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser("max_sizes")
    ap.add_argument("--method", choices=["estimate", "analysis"], default="estimate",
                    help="estimate: the analytic footprint; analysis: a measured probe on the card")
    ap.add_argument("--models", default=",".join(DEFAULT_MODELS))
    ap.add_argument("--optimizers", default=",".join(DEFAULT_OPTIMIZERS))
    ap.add_argument("--devices", type=int, default=1,
                    help="N devices sharing each image in row bands (JAX's N-device table): the estimate's "
                         "footprint / N * 1.03 anywhere; the measured probe on a space:N mesh of the first N "
                         "distinct CUDA devices (it needs N cards)")
    ap.add_argument("--hbm_gb", type=float, default=None,
                    help="override the device memory budget (default: CUDA device 0's whole memory for "
                         "the estimate, its free memory for the measured search)")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    help="dtype of the probed step (bfloat16 also stores L-BFGS histories in bf16, as the engine does)")
    ap.add_argument("--seed_from", default=None,
                    help="existing table JSON whose safe sizes seed the probe ladder")
    ap.add_argument("--topology", default=None, help="AOT TPU topologies are not ported; raises")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.topology:
        raise NotImplementedError("--topology: AOT TPU topologies are not ported (the port probes the card it runs on)")

    seed_table = None
    if args.seed_from and os.path.exists(args.seed_from):
        with open(args.seed_from) as f:
            seed_table = json.load(f)

    budget = int(args.hbm_gb * 1024 ** 3) if args.hbm_gb else None
    table = probe_max_sizes(
        models=args.models.split(","),
        optimizers=args.optimizers.split(","),
        method=args.method,
        devices=args.devices,
        budget_bytes=budget,
        compute_dtype=args.compute_dtype,
        seed_table=seed_table,
    )
    gb = round((budget or hbm_bytes()) / 1024 ** 3)
    out = args.out or default_table_path(gb, args.devices)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(table, f, indent=2)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
