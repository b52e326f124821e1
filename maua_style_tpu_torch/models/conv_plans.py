"""How the feature net's convolutions pick their cuDNN plans (``ConvPlans``,
one per engine), and ``apply_precision``, the process's TF32 switch, which
every pipeline sets (the CLIP/VQGAN and NCA pipelines too) and under which
the plans run.  With ``StyleEngine(cudnn_autotune=True)`` cuDNN picks the
plans of the feature net's input gradient by timing them, not by its
heuristics: the same f32 (or bf16) arithmetic, another algorithm."""

from __future__ import annotations

import contextlib

import torch

from .. import trace
from .extractor import Extractor

_TF32 = {"highest": False, "high": True, "default": True}


def apply_precision(precision: str) -> None:
    """``highest`` turns TF32 off for matmul and cuDNN (cuDNN allows it by
    default); ``high`` and ``default`` allow it.  The flags are
    process-wide."""
    if precision not in _TF32:
        raise ValueError(f"unknown precision {precision!r}; one of {sorted(_TF32)}")
    torch.backends.cuda.matmul.allow_tf32 = _TF32[precision]
    torch.backends.cudnn.allow_tf32 = _TF32[precision]


# The candidate plans cuDNN times a problem, in the order of its heuristics
# (PyTorch's default 10): on an H100 80GB HBM3 the 10-plan search took 28.3 s
# of set-up at 2048² (VGG-19), 30.6 s over the pyramid's five scales and
# 136 s at 9088² (NIN); 2 plans find the same VGG-19 data-gradient plans
# (86.5 → 12.9 ms at 2048² conv1_2) in 0.9 s and 2.2 s, and 3 or 4 plans gain
# no more there; kept to deterministic plans, 2 take the 2048² data
# gradients from 260.2 to 129.2 ms an iteration in 0.9 s of search
BENCHMARK_LIMIT = 2
# every (arch, deepest layer, dtype, pastiche shape, device) this process has
# run a measured input gradient of: the key of one set of convolution
# problems that cuDNN times once and keeps a plan of for the process
_MEASURED: set = set()


def measured_selection():
    """cuDNN's measured selection inside the block: ``benchmark`` on,
    ``benchmark_limit`` at ``BENCHMARK_LIMIT``, and ``deterministic`` on,
    which keeps the search to plans that repeat bit for bit and, as a field
    of the key PyTorch caches a plan under, keeps the plans it picks from
    anything that runs the same problems with the flag off (the heuristics'
    plans stay theirs).  ``torch.backends.cudnn.flags`` gives every flag
    back after it, however it ends."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=True, benchmark_limit=BENCHMARK_LIMIT, deterministic=True,
                       allow_tf32=cudnn.allow_tf32)


def _image_conv_hook(module, inputs, out) -> None:
    """Forward hook of the convolution that reads the image: its input
    gradient, the last convolution of the backward, runs under the flags
    its forward ran under (the caller's; a measured scope opens only around
    the backward), on the plan it had before.  Its 3-channel result leaves
    cuDNN's candidates far apart: at 9088² NIN's 11x11 stride-4 conv1 took
    5.6 s to time its second plan and 51 s to find a faster one than the
    heuristics' 102 ms among ten (H100 80GB HBM3), and VGG-19's conv1_1
    gains 0.5 of 7.1 ms at 2048²."""
    if out.requires_grad:
        cudnn = torch.backends.cudnn
        caller = cudnn.benchmark, cudnn.deterministic

        def as_caller(grad) -> None:
            cudnn.benchmark, cudnn.deterministic = caller

        out.register_hook(as_caller)


class ConvPlans:
    """The plans of an engine's ``extractor`` (its weights ``dtype``): with
    ``measured``, the image convolution's hook, and ``scope``."""

    def __init__(self, extractor: Extractor, dtype: torch.dtype, measured: bool):
        self.measured = measured
        self._net = (extractor.spec.arch, extractor.spec.layers[-1].name if extractor.spec.layers else None, dtype)
        if measured and extractor.image_conv is not None:
            extractor.image_conv.register_forward_hook(_image_conv_hook)

    @contextlib.contextmanager
    def scope(self, p):
        """The scope of one step's input gradient of the pastiche ``p``:
        with ``measured`` cuDNN's measured selection, and a shape the
        process meets here for the first time counts once in
        ``net.autotune_shapes`` and runs under a ``net.autotune`` span
        (cuDNN searches only on a CUDA device, and only for problems it
        holds no plan of).  A banded pastiche (a list) keeps the caller's
        flags: its bands' backwards may run at once on several devices'
        threads, where the process-wide flags, which the image
        convolution's hook sets back in the middle of a backward, cannot
        follow each band."""
        if not self.measured or isinstance(p, list):
            yield
            return
        key = (*self._net, tuple(p.shape), p.device)
        search = contextlib.nullcontext()
        if key not in _MEASURED:
            _MEASURED.add(key)
            trace.count("net.autotune_shapes")
            search = trace.span("net.autotune", shape=list(p.shape))
        with measured_selection(), search:
            yield



__all__ = ["ConvPlans", "apply_precision", "measured_selection", "BENCHMARK_LIMIT"]
