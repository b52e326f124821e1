"""The port's cost volume (``ops/correlation.py``) on the CPU against the
JAX package's: ``correlation_reference`` (the plain version, which CPU
tensors take) against ``correlation_xla`` (the oracle) and against the TPU
kernel ``correlation_pallas(..., interpret=True)``, run as
tests/test_flow.py runs it.  Inputs are NHWC numpy from one seed; the
port's are their NCHW transposes.  Tolerance: atol 1e-5 (float32 sums of
at most a few hundred products in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_style_tpu.ops.correlation import correlation_pallas, correlation_xla
from maua_style_tpu_torch.ops import correlation as C

CASES = [
    # (b, h, w, c, max_disp, stride)
    (1, 8, 8, 16, 4, 1),
    (1, 9, 16, 12, 3, 1),  # LiteFlowNet's d = 3
    (1, 12, 10, 8, 20, 2),  # FlowNetC's d = 20, s = 2: 441 channels, a halo wider than the frame
    (2, 13, 20, 16, 4, 1),  # B = 2, ragged H and W
    (1, 9, 16, 196, 4, 1),  # C not a multiple of 128 (PWC level 6 at 1024x576 is 16 x 9)
    (1, 1, 1, 5, 4, 1),  # a 1 x 1 level
]


def _inputs(b, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(2)]


def _port(f1, f2, d, s):
    t1, t2 = (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))) for x in (f1, f2))
    before = C.correlation.launches
    out = C.correlation(t1, t2, d, s)  # CPU tensors: the plain version, no launch
    assert C.correlation.launches == before
    return out.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("b,h,w,c,d,s", CASES)
def test_plain_version_matches_jax_oracle(b, h, w, c, d, s):
    f1, f2 = _inputs(b, h, w, c)
    want = np.asarray(correlation_xla(jnp.asarray(f1), jnp.asarray(f2), d, s))
    got = _port(f1, f2, d, s)
    assert got.shape == want.shape == (b, h, w, (2 * d // s + 1) ** 2)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("b,h,w,c,d,s", [(2, 13, 20, 16, 4, 1), (1, 8, 8, 16, 4, 2), (1, 9, 16, 12, 3, 1)])
def test_plain_version_matches_pallas_interpret(b, h, w, c, d, s):
    f1, f2 = _inputs(b, h, w, c, seed=1)
    want = np.asarray(correlation_pallas(jnp.asarray(f1), jnp.asarray(f2), d, s, interpret=True))
    np.testing.assert_allclose(_port(f1, f2, d, s), want, atol=1e-5)


def test_channel_order_is_dy_outer():
    """k = iy * n + ix with dy the outer index (T2): shifting f2 down by one
    row moves the peak to (iy, ix) = (d + 1, d)."""
    rng = np.random.default_rng(2)
    f1 = rng.standard_normal((1, 4, 12, 12)).astype(np.float32)
    f2 = np.roll(f1, 1, axis=2)  # f2[y + 1] = f1[y]
    out = C.correlation_reference(torch.from_numpy(f1), torch.from_numpy(f2), 2, 1).numpy()
    n = 5
    peak = out[0, :, 4:8, 4:8].mean((1, 2)).argmax()
    assert divmod(int(peak), n) == (2 + 1, 2)


def test_zero_halo_and_true_channel_divisor():
    f1 = torch.ones(1, 3, 2, 2)
    f2 = torch.ones(1, 3, 2, 2)
    out = C.correlation_reference(f1, f2, 1, 1)
    # centre displacement: every pixel sees f2 inside the frame -> 3 / 3
    assert torch.equal(out[0, 4], torch.ones(2, 2))
    # dy = -1 at the top row reads the zero halo
    assert torch.equal(out[0, 1, 0], torch.zeros(2))


def test_argument_checks():
    f = torch.zeros(1, 2, 3, 3)
    with pytest.raises(ValueError, match="multiple of stride"):
        C.correlation(f, f, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        C.correlation(f, f.to("meta"), 4, 1)


def test_channel_chunk_fits_the_shared_memory_budget():
    for d in (3, 4, 20):
        cc = C.channel_chunk(d, 441)
        assert 1 <= cc <= 32
        assert 4 * cc * (8 * 32 + (8 + 2 * d) * (32 + 2 * d)) <= 227 * 1024
    assert C.channel_chunk(4, 3) == 3
