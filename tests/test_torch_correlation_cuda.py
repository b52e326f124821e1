"""The hand-written CUDA cost-volume kernel against its plain version, on a
card.

These tests import no JAX, so they also run on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_correlation_cuda.py

Without a CUDA device they skip: the kernel has no CPU mode.  Bar:
max|Δ| / max|corr| <= 1e-5 (f32 sums over C in another order)."""

import pytest
import torch

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
])
def test_cuda_kernel_matches_plain_version(b, c, h, w, d, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    f1 = torch.randn(b, c, h, w, device="cuda", generator=gen)
    f2 = torch.randn(b, c, h, w, device="cuda", generator=gen)
    before = C.correlation.launches
    got = C.correlation(f1, f2, d, s)
    torch.cuda.synchronize()
    assert C.correlation.launches == before + 1
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
