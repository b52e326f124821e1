"""The hand-written CUDA Gram kernel against its plain version, on a card.

These tests import no JAX, so they also run on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_gram_cuda.py

Without a CUDA device they skip: the kernel has no CPU mode."""

import pytest
import torch

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
    before = G.gram.launches
    got = G.gram(f)
    torch.cuda.synchronize()
    assert G.gram.launches == before + 1
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
