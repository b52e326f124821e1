"""The capacity tuner's measured probe on a card.

These tests import no JAX, so they also run on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_tuning_cuda.py

Without a CUDA device they skip: the probe reads the CUDA allocator."""

import pytest
import torch

from maua_style_tpu_torch.tuning import max_sizes as ms


@pytest.mark.cuda
def test_measured_probe_frees_what_it_made():
    """The probe at 256² reports a peak above the weights, within a factor
    of two of the estimate, and leaves the allocator where it found it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ms.measure_step_bytes("vgg19", "adam", 64)  # the process's cuBLAS and cuDNN workspaces stay allocated
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    got = ms.measure_step_bytes("vgg19", "lbfgs", 256, compute_dtype="float32")
    assert got is not None and got > ms._terms("vgg19", 256, "float32")[2]
    assert torch.cuda.memory_allocated() == before
    est = ms.estimate_step_bytes("vgg19", "lbfgs", 256, compute_dtype="float32")
    assert 0.5 < got / est < 2.0, (got, est)
