"""The hand-written CUDA cost-volume kernel against its plain version, on a
card.

These tests import no JAX, so they also run on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_correlation_cuda.py

Without a CUDA device they skip: the kernel has no CPU mode.  Bar:
max|Δ| / max|corr| <= 1e-5 (f32 sums over C in another order)."""

import pytest
import torch

from maua_style_tpu_torch import trace
from maua_style_tpu_torch.ops import correlation as C


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("c,h,w,d,s", [
    (32, 13, 37, 4, 1),  # ragged H and W against the 8 x 32 tile
    (196, 9, 16, 4, 1),  # PWC level 6 of a 1024 x 576 frame
    (64, 1, 1, 4, 1),  # the 1 x 1 level of a 64 x 64 input
    (40, 17, 33, 3, 1),  # LiteFlowNet's d = 3
    (24, 20, 45, 20, 2),  # FlowNetC's d = 20, s = 2: 441 displacements, a halo wider than the frame
    (5, 8, 32, 4, 2),
    (12, 9, 17, 4, 1),  # W % 4 == 1: 4-byte copies, scalar stores
    (12, 7, 18, 2, 1),  # W % 4 == 2
    (196, 17, 30, 4, 1),  # PWC level 6 of a 1920 x 1088 frame, W % 4 == 2
    (12, 6, 19, 1, 1),  # W % 4 == 3
    (8, 6, 8, 20, 1),  # d = 20, s = 1: two displacement column groups
])
def test_cuda_kernel_matches_plain_version(b, c, h, w, d, s):
    _check(b, c, h, w, d, s)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w,d,s", [
    (8, 196, 9, 16, 4, 1),  # channel splits: PWC level 6 of 8 pairs of 1024 x 576
    (8, 128, 18, 32, 4, 1),  # level 5
    (2, 64, 24, 64, 20, 2),  # FlowNetC's d = 20, s = 2 at B = 2: dy-row blocks and splits
])
def test_cuda_kernel_schedules_match_plain_version(b, c, h, w, d, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    p = C.launch_plan(b, c, h, w, d, s, torch.cuda.get_device_properties(0).multi_processor_count)
    assert p.splits > 1 and (d != 20 or p.dy_blocks > 1)
    _check(b, c, h, w, d, s)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [32, 30])
def test_cuda_kernel_takes_an_unaligned_base_pointer(w):
    """A contiguous view at storage offset 1 is only 4-byte aligned: the
    kernel takes its 4-byte copies."""
    _check(2, 24, 16, w, 4, 1, offset=1)


def _check(b, c, h, w, d, s, offset=0):
    """The kernel against the plain version on one seeded input, and a
    bit-identical relaunch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    size = b * c * h * w
    f1 = torch.randn(size + offset, device="cuda", generator=gen)[offset:].view(b, c, h, w)
    f2 = torch.randn(size + offset, device="cuda", generator=gen)[offset:].view(b, c, h, w)
    assert f1.is_contiguous() and (f1.data_ptr() % 16 == 0) == (offset == 0)
    before = trace.counter("correlation.launches")
    got = C.correlation(f1, f2, d, s)
    torch.cuda.synchronize()
    assert trace.counter("correlation.launches") == before + 1
    want = C.correlation_reference(f1, f2, d, s)
    assert got.shape == want.shape == (b, (2 * d // s + 1) ** 2, h, w)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    torch.testing.assert_close(C.correlation(f1, f2, d, s), got, rtol=0, atol=0)  # deterministic: no atomics


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    f = torch.randn(1, 8, 6, 10, device="cuda")
    with pytest.raises(TypeError):
        C.correlation(f.half(), f.half())
    with pytest.raises(ValueError, match="contiguous"):
        C.correlation(f.transpose(2, 3), f.transpose(2, 3))
    with pytest.raises(ValueError, match="one CUDA device"):
        C.correlation(f, f.cpu())
    with pytest.raises(ValueError, match="shape"):
        C.correlation(f, f[:, :4].contiguous())
