"""The hand-written CUDA Gram kernel against its plain version, on a card.

These tests import no JAX, so they also run on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_gram_cuda.py

Without a CUDA device they skip: the kernel has no CPU mode."""

import pytest
import torch

from maua_style_tpu_torch import trace
from maua_style_tpu_torch.ops import gram as G

# N = 4097, 4098, 4099 are 1, 2, 3 (mod 4): f32 rows that are not 16-byte
# aligned, bf16 rows that are only 2-byte aligned; N = 4100 gives bf16 rows
# that are 8-byte aligned.  C <= 64 is a single, diagonal tile.
SHAPES = [(1, 64, 4096), (2, 70, 1000), (1, 130, 333), (1, 512, 2025), (3, 5, 7),
          (1, 64, 4097), (1, 128, 4098), (2, 96, 4099), (1, 200, 4100), (2, 48, 65536), (2, 512, 4096)]


def _f64_rel_err(got: torch.Tensor, f: torch.Tensor) -> float:
    f64 = f.double()
    exact = torch.bmm(f64, f64.transpose(1, 2))
    return float((got.double() - exact).abs().max() / exact.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,n", SHAPES)
def test_cuda_kernel_matches_plain_version(dtype, b, c, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    f = torch.randn(b, c, n, device="cuda").to(dtype)
    before = trace.counter("gram.launches")
    got = G.gram(f)
    torch.cuda.synchronize()
    assert trace.counter("gram.launches") == before + 1
    want = G.gram_reference(f)
    # the sum over N runs in another order: max error relative to max |G|
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    if dtype == torch.float32:
        # 3xTF32 keeps f32 accuracy: against an exact (f64) Gram
        assert _f64_rel_err(got, f) <= 1e-5
    torch.testing.assert_close(G.gram(f), got, rtol=0, atol=0)  # deterministic: no atomics
    with pytest.raises(ValueError, match="contiguous"):
        G.gram(f.transpose(1, 2))
    with pytest.raises(TypeError):
        G.gram(f.half())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_unaligned_base_pointer(dtype):
    """A contiguous view that starts one element into its storage: rows are
    not 16-byte aligned although N is, so the kernel takes its narrow loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, c, n = 2, 130, 4096
    f = torch.relu(torch.randn(b * c * n + 1, device="cuda")).to(dtype)[1:].view(b, c, n)
    assert f.is_contiguous() and f.data_ptr() % 16 != 0
    got = G.gram(f)
    want = G.gram_reference(f)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    if dtype == torch.float32:
        assert _f64_rel_err(got, f) <= 1e-5


# img_vid's whole-window Grams: the (1, T·C, H·W) view of a T-frame window.
# 18 frames of relu4_1/5_1 at the 256 and 512 scales (C' = 9216, a k-loop
# of 144 and 576 positions under a 340 MB output); a ragged C' = 7·64 with
# N % 4 = 1; and a relu1_1 window at the 1448 scale's order of size, whose
# 2.23e9 bytes of input pass 2**31.
VIDEO_VIEWS = [(18, 512, 144), (18, 512, 576), (7, 64, 4501), (7, 64, 1245184)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,c,n", VIDEO_VIEWS)
def test_cuda_video_gram_against_f64(t, c, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.relu(torch.randn(t, c, 1, n, device="cuda"))
    before = trace.counter("gram.launches")
    got = G.video_gram(x)
    torch.cuda.synchronize()
    assert trace.counter("gram.launches") == before + 1 and got.shape == (t * c, t * c)
    assert _f64_rel_err(got[None], x.view(1, t * c, n)) <= 1e-5
    torch.testing.assert_close(G.video_gram(x), got, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_video_gram_backward_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.randn(18, 512, 12, 12, device="cuda")
    w = torch.randn(18 * 512, 18 * 512, device="cuda")
    for cov in (False, True):
        xk = x.clone().requires_grad_(True)
        (G.video_gram(xk, cov) * w).sum().backward()
        xp = x.clone().requires_grad_(True)
        f = xp.reshape(1, 18 * 512, 144)
        if cov:
            f = f - f.mean(dim=2, keepdim=True)
        (G.gram_reference(f)[0] * w).sum().backward()
        assert float((xk.grad - xp.grad).abs().max() / xp.grad.abs().max()) <= 1e-4
