"""The port's flow nets (models/flownets) against the JAX package's on the
CPU: SPyNet and PWC-Net forwards with the JAX init's weights carried across
by ``flow_params_from_jax``, the deconv on a 1 x 1 input, ``backward_warp``,
and sniklaus-named state dicts loaded natively against the JAX converters.
Bar: max|Δ| / max|flow| <= 1e-4 (float32 convolutions summed in another
order through a few dozen layers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_style_tpu.models.flownets import PWCNet as JaxPWC
from maua_style_tpu.models.flownets import SPyNet as JaxSPyNet
from maua_style_tpu.models.flownets import common as jax_common
from maua_style_tpu.models.flownets import pwc as jax_pwc
from maua_style_tpu.models.flownets import spynet as jax_spynet
from maua_style_tpu.models.flownets.pwc import convert_pwc_torch
from maua_style_tpu.models.flownets.spynet import convert_spynet_torch
from maua_style_tpu_torch.models.flownets import PWCNet, SPyNet, backward_warp, convert
from maua_style_tpu_torch.models.flownets.common import deconv
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)


def _np_params(kind, seed):
    """He-normal weights (and small biases) in the JAX nets' layouts, from
    numpy: the JAX nets' own init draws one eager jax.random op per layer
    shape, which costs a minute of compiles for PWC on a cold cache."""
    if kind == "pwc":
        layout = jax_pwc._layout()
    else:
        layout = [e for level in range(jax_spynet.N_LEVELS) for e in jax_spynet._level_layout(level)]
    rng = np.random.default_rng(seed)
    params = {}
    for name, cin, cout, k in layout:
        shape = (k, k, cout, cin) if k == 4 else (k, k, cin, cout)
        params[name] = {
            "w": (rng.standard_normal(shape) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32),
            "b": (rng.standard_normal(cout) * 0.01).astype(np.float32),
        }
    return params


def _jax_net(kind, params):
    net_cls = JaxSPyNet if kind == "spynet" else JaxPWC
    return net_cls({k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in params.items()})


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("kind", ["spynet", "pwc"])
@pytest.mark.parametrize("hw", [(64, 64), (128, 192)])
def test_forward_matches_jax(kind, hw):
    params = _np_params(kind, 3)
    jax_net = _jax_net(kind, params)
    net = SPyNet() if kind == "spynet" else PWCNet()
    net.load_state_dict(convert.flow_params_from_jax(kind, params))
    rng = np.random.default_rng(0)
    im1 = rng.random((2, *hw, 3), dtype=np.float32)
    im2 = np.roll(im1, 3, axis=2) * 0.9 + 0.05
    want = np.asarray(jax_net(jnp.asarray(im1), jnp.asarray(im2)))
    with torch.inference_mode():
        got = net(_nchw(im1), _nchw(im2)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, *hw, 2)
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= 1e-4, _rel(got, want)


@pytest.mark.parametrize("hw", [(1, 1), (3, 5)])
def test_deconv_layout_no_flip(hw):
    """The JAX deconv weight (k, k, out, in) is torch's ConvTranspose2d
    (in, out, k, k) by transpose(3, 2, 0, 1), with no spatial flip (T3);
    a 1 x 1 input (PWC level 6 at 64 x 64) shows any flip."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 4, 2, 5)).astype(np.float32)
    b = rng.standard_normal(2).astype(np.float32)
    x = rng.standard_normal((1, *hw, 5)).astype(np.float32)
    want = np.asarray(jax_common.deconv({"d": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}, "d", jnp.asarray(x)))
    m = deconv(5, 2)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        m.bias.copy_(torch.from_numpy(b))
        got = m(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (1, 2 * hw[0], 2 * hw[1], 2)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_backward_warp_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 13, 4)).astype(np.float32)
    flow = (rng.standard_normal((2, 9, 13, 2)) * 4).astype(np.float32)  # some samples leave the frame
    want = np.asarray(jax_common.backward_warp(jnp.asarray(x), jnp.asarray(flow)))
    got = backward_warp(_nchw(x), _nchw(flow)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # zero flow is the identity
    np.testing.assert_allclose(backward_warp(_nchw(x), torch.zeros(2, 2, 9, 13)).numpy(), _nchw(x).numpy(), atol=1e-5)


_LVL = {6: "Six", 5: "Fiv", 4: "Fou", 3: "Thr", 2: "Two", 1: "One"}
_DENSE = {1: "One", 2: "Two", 3: "Thr", 4: "Fou", 5: "Fiv"}


def _sniklaus_pwc(params) -> dict:
    """The JAX PWC parameters under the published pytorch-pwc names
    (``module*`` spelling), in torch layouts."""
    sd = {}
    for name, p in params.items():
        part, layer = name.split("/")
        if part.startswith("ext"):
            key = f"moduleExtractor.module{_LVL[int(part[3:])]}.{(int(layer[4:]) - 1) * 2}"
        elif part == "ctx":
            key = f"moduleRefiner.moduleMain.{(int(layer[4:]) - 1) * 2}"
        elif layer.startswith("up"):  # decoder L owns the upsamplers of decoder L + 1's outputs
            key = f"module{_LVL[int(part[3:]) - 1]}.moduleUp{layer[2:]}"
        else:
            sub = "Six" if layer == "flow" else _DENSE[int(layer[4:])]
            key = f"module{_LVL[int(part[3:])]}.module{sub}.0"
        sd[key + ".weight"] = torch.from_numpy(np.ascontiguousarray(p["w"].transpose(3, 2, 0, 1)))
        sd[key + ".bias"] = torch.from_numpy(p["b"].copy())
    return sd


def _sniklaus_spynet(params) -> dict:
    sd = {}
    for name, p in params.items():
        level, layer = name.split("/")
        key = f"netBasic.{int(level[5:])}.netBasic.{(int(layer[4:]) - 1) * 2}"
        sd[key + ".weight"] = torch.from_numpy(np.ascontiguousarray(p["w"].transpose(3, 2, 0, 1)))
        sd[key + ".bias"] = torch.from_numpy(p["b"].copy())
    return sd


@pytest.mark.parametrize("kind", ["spynet", "pwc"])
def test_native_torch_checkpoint_matches_jax_converter(kind):
    sd = (_sniklaus_spynet if kind == "spynet" else _sniklaus_pwc)(_np_params(kind, 4))
    jax_params = (convert_spynet_torch if kind == "spynet" else convert_pwc_torch)({k: v.numpy() for k, v in sd.items()})
    want = convert.flow_params_from_jax(kind, {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jax_params.items()})
    got = convert.flow_params_from_torch(kind, {"state_dict": sd})
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the loaded state dict fits the module exactly
    (SPyNet() if kind == "spynet" else PWCNet()).load_state_dict(got)


def test_checkpoint_drift_raises():
    sd = _sniklaus_pwc(_np_params("pwc", 5))
    sd["moduleSix.moduleOne.0.weight"] = torch.zeros(128, 80, 3, 3)
    with pytest.raises(ValueError, match="drift"):
        convert.flow_params_from_torch("pwc", sd)
    del sd["moduleSix.moduleOne.0.weight"]
    with pytest.raises(ValueError, match="did not cover"):
        convert.flow_params_from_torch("pwc", sd)


def test_random_init_is_seeded():
    a, b, c = PWCNet(seed=0), PWCNet(seed=0), PWCNet(seed=1)
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(), c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.convs["ext1_conv1"].weight, c.convs["ext1_conv1"].weight)
