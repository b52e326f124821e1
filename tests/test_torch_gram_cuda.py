"""The hand-written CUDA Gram kernel against its plain version, on a card.

These tests import no JAX, so they also run on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_gram_cuda.py

Without a CUDA device they skip: the kernel has no CPU mode."""

import pytest
import torch

from maua_style_tpu_torch.ops import gram as G


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,n", [(1, 64, 4096), (2, 70, 1000), (1, 130, 333), (1, 512, 2025), (3, 5, 7)])
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
    torch.testing.assert_close(G.gram(f), got, rtol=0, atol=0)  # deterministic: no atomics
    with pytest.raises(ValueError, match="contiguous"):
        G.gram(f.transpose(1, 2))
    with pytest.raises(TypeError):
        G.gram(f.half())
