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
from maua_style_tpu_torch import trace
from maua_style_tpu_torch.ops import correlation as C
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

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
    before = trace.counter("correlation.launches")
    out = C.correlation(t1, t2, d, s)  # CPU tensors: the plain version, no launch
    assert trace.counter("correlation.launches") == before
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


def _pwc_levels(height, width):
    h64, w64 = -(-height // 64) * 64, -(-width // 64) * 64
    return [(c, h64 >> lvl, w64 >> lvl) for lvl, c in ((6, 196), (5, 128), (4, 96), (3, 64), (2, 32))]


# (b, c, h, w, d, s): the PWC levels of 1024x576 and 1920x1088 pairs at B = 8,
# LiteFlowNet's d = 3, FlowNetC's d = 20 / s = 2, W % 4 in {1, 2, 3}, a 1 x 1
# level, and d = 20 / s = 1, whose 41 displacement columns take two groups
PLAN_CASES = (
    [(8, c, h, w, 4, 1) for c, h, w in _pwc_levels(576, 1024) + _pwc_levels(1088, 1920)]
    + [(1, 128, 68, 120, 3, 1), (1, 256, 48, 64, 20, 2), (2, 24, 20, 45, 20, 2), (1, 196, 1, 1, 4, 1),
       (3, 40, 17, 33, 3, 1), (1, 196, 17, 30, 4, 1), (1, 32, 13, 35, 4, 1), (1, 8, 10, 12, 20, 1), (1, 5, 8, 32, 4, 2)]
)


def _plan_blocks(p, b, h, w):
    """The blocks of a plan: (split, frame, h0, w0, iy0, ix0) for block
    (tile, gy, split·B + frame), gy = dx group·dy_blocks + dy block."""
    tiles_w, tiles_h = -(-w // p.tw), -(-h // p.th)
    for split in range(p.splits):
        for bi in range(b):
            for gy in range(p.dx_groups * p.dy_blocks):
                for tile in range(tiles_w * tiles_h):
                    yield (split, bi, tile // tiles_w * p.th, tile % tiles_w * p.tw,
                           gy % p.dy_blocks * p.rows * p.groups, gy // p.dy_blocks * p.nx)


@pytest.mark.parametrize("b,c,h,w,d,s", PLAN_CASES)
def test_launch_plan_covers_each_output_once_within_the_card_limits(b, c, h, w, d, s):
    p = C.launch_plan(b, c, h, w, d, s)
    n = 2 * d // s + 1
    # every (pixel, displacement) pair once per channel split, and the
    # splits cut [0, C) into disjoint ranges
    seen = np.zeros((p.splits, b, n, n, h, w), np.uint8)
    blocks = 0
    for split, bi, h0, w0, iy0, ix0 in _plan_blocks(p, b, h, w):
        seen[split, bi, iy0 : iy0 + p.rows * p.groups, ix0 : ix0 + p.nx, h0 : h0 + p.th, w0 : w0 + p.tw] += 1
        blocks += 1
    assert (seen == 1).all()
    assert blocks == p.blocks
    channels = [range(k * p.chunk_c, min(c, (k + 1) * p.chunk_c)) for k in range(p.splits)]
    assert [ch for r in channels for ch in r] == list(range(c)) and all(len(r) for r in channels)
    # shared memory, registers and threads within what an sm_90 block has
    assert p.smem_bytes <= 227 * 1024
    assert C.PX * p.rows * p.nx <= C.ACC_BUDGET
    quads = p.th * p.tw // C.PX
    assert p.tw % C.PX == 0 and quads * p.groups <= p.threads <= C.MAX_THREADS and p.threads % 32 == 0
    # the halo holds every f2 element a thread reads
    assert p.hh >= p.th + (p.rows * p.groups - 1) * s and p.hws >= p.tw + p.off + (p.nx - 1) * s
    assert (d + p.off) % 4 == 0 and p.hws % 4 == 0
    # TMA copies only where every row and halo origin is 16-byte aligned
    assert p.tma == (w % 4 == 0 and (p.dx_groups == 1 or p.nx * s % 4 == 0) and max(p.hh, p.hws) <= 256)


@pytest.mark.parametrize("frame", [(576, 1024), (1088, 1920)])
def test_launch_plan_fills_the_card_at_every_pwc_level(frame):
    """At least one block per SM of an H100 (132) at each level of 8 pairs,
    however few tiles the small levels have; one library for all five."""
    plans = [C.launch_plan(8, c, h, w, 4, 1) for c, h, w in _pwc_levels(*frame)]
    assert all(p.blocks >= 132 for p in plans)
    assert len({p.defines for p in plans}) == 1
    assert plans[0].splits > 1 and plans[-1].splits == 1  # channel splits only where the grid is small


def test_launch_plan_tile_follows_the_frame():
    """A 1 x 1 level stages a 1 x 4 tile and its 9 x 12 halo, not 8 x 32."""
    p = C.launch_plan(1, 196, 1, 1, 4, 1)
    assert (p.th, p.tw, p.hh, p.hws, p.tma) == (1, 4, 9, 12, False)
    assert C.launch_plan(1, 8, 16, 32, 4, 1, aligned=False).tma is False  # an unaligned base pointer: 4-byte copies


def test_launch_plan_rejects_a_halo_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        C.launch_plan(1, 8, 16, 32, 200, 400)


def _window(x, y0, x0, hh, ww):
    """x[:, y0 : y0 + hh, x0 : x0 + ww] with zeros outside x (cp.async's
    zero fill)."""
    c, h, w = x.shape
    out = np.zeros((c, hh, ww), x.dtype)
    ys, xs = max(y0, 0), max(x0, 0)
    ye, xe = min(y0 + hh, h), min(x0 + ww, w)
    if ys < ye and xs < xe:
        out[:, ys - y0 : ye - y0, xs - x0 : xe - x0] = x[:, ys:ye, xs:xe]
    return out


def _emulate(f1, f2, d, s, p):
    """csrc/correlation.cu's algorithm in numpy, float32, block by block as
    plan ``p`` cuts it: f1's tile and f2's halo staged with the rounded-down
    halo origin (x0 = w0 - d - off + ix0·s) and zero fill, each computing
    thread's rows·groups x nx displacements read at segment position
    off + pixel + column·s, channels summed in order chunk by chunk of cc,
    and the channel splits' partials summed in split order, then 1/C."""
    b, c, h, w = f1.shape
    n = 2 * d // s + 1
    rg = p.rows * p.groups
    part = np.zeros((p.splits, b, n, n, h, w), np.float32)
    rows_idx = np.arange(p.th)[None, :] + s * np.arange(rg)[:, None]  # (rg, th): halo row of (displacement row, pixel row)
    cols_idx = np.arange(p.tw)[None, :] + p.off + s * np.arange(p.nx)[:, None]  # (nx, tw)
    for split, bi, h0, w0, iy0, ix0 in _plan_blocks(p, b, h, w):
        c0, c1 = split * p.chunk_c, min(c, (split + 1) * p.chunk_c)
        tile = _window(f1[bi, c0:c1], h0, w0, p.th, p.tw)
        halo = _window(f2[bi, c0:c1], h0 - d + iy0 * s, w0 - d - p.off + ix0 * s, p.hh, p.hws)
        shifted = halo[:, rows_idx[:, None, :, None], cols_idx[None, :, None, :]]  # (channels, rg, nx, th, tw)
        acc = np.zeros(shifted.shape[1:], np.float32)
        for t in range(0, c1 - c0, p.cc):  # ring stages
            for ch in range(t, min(t + p.cc, c1 - c0)):
                acc = acc + tile[ch] * shifted[ch]
        iy1, ix1 = min(n, iy0 + rg), min(n, ix0 + p.nx)
        hh, ww = min(p.th, h - h0), min(p.tw, w - w0)
        part[split, bi, iy0:iy1, ix0:ix1, h0 : h0 + hh, w0 : w0 + ww] = acc[: iy1 - iy0, : ix1 - ix0, :hh, :ww]
    out = part[0]
    for k in range(1, p.splits):
        out = out + part[k]
    return (out * np.float32(1.0 / c)).reshape(b, n * n, h, w)


# (b, c, h, w, d, s, sm_count): sm_count sets how far the plan splits C
EMULATION_CASES = [
    (2, 20, 13, 20, 4, 1, 1),  # three ring chunks, no split, ragged H
    (1, 40, 9, 16, 4, 1, 132),  # channel splits (PWC level 6's shape at a small C)
    (1, 12, 9, 17, 3, 1, 1),  # W % 4 == 1, the rounded-up halo origin (d = 3, off = 1)
    (1, 12, 7, 18, 2, 1, 1),  # W % 4 == 2, off = 2
    (1, 12, 6, 19, 1, 1, 1),  # W % 4 == 3, off = 3
    (1, 6, 8, 32, 20, 2, 1),  # FlowNetC's d = 20, s = 2: seven dy-row blocks
    (1, 4, 6, 8, 20, 1, 1),  # d = 20, s = 1: two dx column groups
    (1, 5, 8, 12, 4, 2, 1),  # d = 4, s = 2
    (1, 196, 1, 1, 4, 1, 132),  # a 1 x 1 level, split 22 ways
]


@pytest.mark.parametrize("b,c,h,w,d,s,sms", EMULATION_CASES)
def test_blocked_algorithm_matches_reference_and_jax_oracle(b, c, h, w, d, s, sms):
    p = C.launch_plan(b, c, h, w, d, s, sm_count=sms)
    rng = np.random.default_rng(3)
    f1, f2 = (rng.standard_normal((b, c, h, w)).astype(np.float32) for _ in range(2))
    got = _emulate(f1, f2, d, s, p)
    ref = C.correlation_reference(torch.from_numpy(f1), torch.from_numpy(f2), d, s).numpy()
    oracle = np.asarray(correlation_xla(jnp.asarray(f1.transpose(0, 2, 3, 1)), jnp.asarray(f2.transpose(0, 2, 3, 1)), d, s))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, oracle.transpose(0, 3, 1, 2), atol=1e-5)


def test_emulation_cases_cover_the_schedule():
    """The cases above reach each part of the schedule."""
    plans = [C.launch_plan(b, c, h, w, d, s, sm_count=sms) for b, c, h, w, d, s, sms in EMULATION_CASES]
    assert any(p.splits > 1 for p in plans) and any(p.dy_blocks > 1 for p in plans)
    assert any(p.dx_groups > 1 for p in plans) and any(-(-p.chunk_c // p.cc) >= 3 for p in plans)
    assert {p.off for p in plans} == {0, 1, 2, 3} and {w % 4 for _, _, _, w, *_ in EMULATION_CASES} == {0, 1, 2, 3}
