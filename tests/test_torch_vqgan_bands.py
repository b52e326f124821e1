"""``spatial.banded_decode``: the VQGAN decoder on row bands of z, one per device
of a "space" mesh (CPU entries repeated), against JAX's ``vq.decode`` of
the same z and against the port's whole decode, forward and the gradient
with respect to z (JAX tests/test_parallel.py:164-182 holds its GSPMD
decode to the whole one).

Configs: JAX's test config (embed 8, ch 16, ch_mult (1, 2), attention at
4: the mid block's attention only, z_channels 256), whose 16-channel
level takes gcd(32, 16) = 16 groups, and a width of 24 channels, whose
GroupNorms take gcd(32, 24) = 8 groups, with attention at every block of
its first level.  Weights: JAX's threefry draws with biases and norm
gains perturbed by numpy, carried across by ``vqgan_params_from_jax``.

Bars: against JAX 1e-4 of max|output|, tests/test_torch_vqgan.py's decode
bar (f32 convolutions summed in another order through a dozen layers).
Against the port's whole decode, in f32, 1e-5 of max|output| and of
max|gradient|: the bands sum GroupNorm's statistics, the attention's
scores and the convolutions in another order (≈ 1e-7 relative a layer);
in f64 1e-12, the same sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_style_tpu.models import vqgan as jax_vq
from maua_style_tpu_torch.models import vqgan as vq
from maua_style_tpu_torch.parallel import build_mesh, spatial
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)
from test_torch_vqgan import _nchw, _nhwc, _perturbed, _rel

CPU = torch.device("cpu")
CONFIGS = {
    # JAX tests/test_parallel.py:170-172
    "jax": dict(embed_dim=8, n_embed=32, ch=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(4,),
                resolution=16),
    # GroupNorm on gcd(32, 24) = 8 groups; attention at the 8-px level's blocks too
    "gcd": dict(embed_dim=8, n_embed=32, ch=24, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                resolution=16, z_channels=24),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(config name, JAX config, JAX params (numpy), the port's VQGAN on them)."""
    jcfg = jax_vq.VQGANConfig(**CONFIGS[request.param])
    tree = _perturbed(jax_vq.init_vqgan_params(jcfg, seed=0), seed=1)
    model = vq.vqgan_from_state_dict(vq.vqgan_params_from_jax(tree), vq.VQGANConfig(**CONFIGS[request.param]))
    return request.param, jcfg, tree, model.eval().requires_grad_(False)


def _space(n):
    return build_mesh([CPU] * n, [("space", n)])


def test_group_norm_groups(pair):
    name, _, _, model = pair
    norms = {m.num_channels: m.num_groups for m in model.decoder.modules() if isinstance(m, torch.nn.GroupNorm)}
    assert norms == ({16: 16, 32: 32} if name == "jax" else {24: 8, 48: 16})


@pytest.mark.parametrize("bands", [2, 4])
def test_banded_decode_matches_jax(pair, bands):
    """z of JAX's test (1, 8, 8, 8) NHWC, decoded on ``bands`` bands, against
    JAX's whole ``vq.decode``: within 1e-4 of max|output|."""
    _, jcfg, tree, model = pair
    z = np.random.default_rng(3).standard_normal((1, 8, 8, 8)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, z: jax_vq.decode(p, z, jcfg))(tree, jnp.asarray(z)))
    with torch.no_grad():
        got = spatial.banded_decode(model, _nchw(z), _space(bands))
    assert got.shape == (1, 3, 16, 16)
    assert _rel(_nhwc(got), want) <= 1e-4


@pytest.mark.parametrize("bands, shape", [(2, (1, 8, 8, 8)), (4, (1, 8, 8, 8)), (3, (2, 8, 11, 6)), (4, (1, 8, 9, 5))])
def test_banded_decode_and_gradient_match_whole(pair, bands, shape):
    """The port's banded decode against its whole decode, and the gradient
    of a random projection with respect to z reaching every band: f32
    within 1e-5 of max|output| and max|gradient| (ragged bands at 9 and 11
    rows, a batch of 2)."""
    _, _, _, model = pair
    rng = np.random.default_rng(sum(shape) + bands)
    z = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    whole_z, band_z = z.clone().requires_grad_(True), z.clone().requires_grad_(True)
    want = model.decode(whole_z)
    got = spatial.banded_decode(model, band_z, _space(bands))
    proj = torch.from_numpy(rng.standard_normal(tuple(want.shape)).astype(np.float32))
    (gw,) = torch.autograd.grad((want * proj).sum(), whole_z)
    (gb,) = torch.autograd.grad((got * proj).sum(), band_z)
    assert _rel(got.detach(), want.detach()) <= 1e-5
    assert _rel(gb, gw) <= 1e-5
    assert all(float(gb[:, :, i].abs().max()) > 0 for i in range(shape[2]))  # every row of every band


def test_banded_decode_matches_whole_in_f64(pair):
    """The same in f64: the bands' sums are the whole image's in another
    order, so output and gradient agree to 1e-12."""
    _, _, _, model = pair
    model = vq.vqgan_from_state_dict(model.state_dict(), model.cfg).double().requires_grad_(False)
    z = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 8, 10, 7))).requires_grad_(True)
    proj = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 3, 20, 14)))
    (gw,) = torch.autograd.grad((model.decode(z) * proj).sum(), z)
    out = spatial.banded_decode(model, z, _space(3))
    (gb,) = torch.autograd.grad((out * proj).sum(), z)
    torch.testing.assert_close(out, model.decode(z), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gb, gw, rtol=1e-12, atol=1e-12)


def test_decode_without_a_space_axis_is_whole(pair):
    """No mesh, a "space" axis of 1, or a "frames" axis alone: the whole
    decode; "frames:2,space:2" bands on the first row's two devices; a
    "tensor" axis raises, as the engine does."""
    _, _, _, model = pair
    z = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 8, 8, 8)).astype(np.float32))
    with torch.no_grad():
        want = model.decode(z)
        for mesh in (None, build_mesh([CPU], [("space", 1)]), build_mesh([CPU] * 2, [("frames", 2)])):
            assert torch.equal(spatial.banded_decode(model, z, mesh), want)
        got = spatial.banded_decode(model, z, build_mesh([CPU] * 4, [("frames", 2), ("space", 2)]))
    assert _rel(got, want) <= 1e-5
    for axes in ([("tensor", 2)], [("space", 2), ("tensor", 2)]):
        mesh = build_mesh([CPU] * 4, axes)
        with pytest.raises(NotImplementedError, match="'tensor' axis is ROADMAP item 18e"):
            spatial.banded_decode(model, z, mesh)


def test_banded_decode_on_copies(pair, monkeypatch):
    """Bands on devices other than the weights' run on copies of the
    decoding modules (``spatial.replica``; distinct cards): forced here by
    hiding the modules' own device, the output and the gradient with respect to z against the
    whole decode (the f32 bar above), the copies made once and made again
    after the weights change in place."""
    _, _, _, model = pair
    model = vq.vqgan_from_state_dict(model.state_dict(), model.cfg).eval().requires_grad_(False)
    monkeypatch.setattr(spatial, "_device_of", lambda m: torch.device("meta"))
    rng = np.random.default_rng(11)
    z = torch.from_numpy(rng.standard_normal((1, 8, 8, 8)).astype(np.float32))
    proj = torch.from_numpy(rng.standard_normal((1, 3, 16, 16)).astype(np.float32))

    def check():
        whole_z, band_z = z.clone().requires_grad_(True), z.clone().requires_grad_(True)
        want, got = model.decode(whole_z), spatial.banded_decode(model, band_z, _space(2))
        (gw,) = torch.autograd.grad((want * proj).sum(), whole_z)
        (gb,) = torch.autograd.grad((got * proj).sum(), band_z)
        assert _rel(got.detach(), want.detach()) <= 1e-5 and _rel(gb, gw) <= 1e-5

    check()
    assert list(model.post_quant_conv._replicas) == [CPU]
    (stamp, copy_), = model.decoder._replicas.values()
    assert copy_ is not model.decoder
    weight = copy_.conv_in.weight
    assert weight.data_ptr() != model.decoder.conv_in.weight.data_ptr()
    assert torch.equal(weight, model.decoder.conv_in.weight)
    check()
    assert model.decoder._replicas[CPU][1] is copy_  # kept
    with torch.no_grad():
        model.decoder.conv_in.weight.mul_(1.5)
    check()  # made again from the new weights
    assert model.decoder._replicas[CPU][1] is not copy_
