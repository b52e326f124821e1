"""The port's feature nets against maua_style_tpu.models: activations and
input gradients with the same weights (the JAX init carried across by
params_from_jax), pooling edge cases, and the checkpoint formats."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_style_tpu.models import extractor as jax_ext
from maua_style_tpu.models import registry as jax_registry
from maua_style_tpu.models.convert import convert_torch_state_dict as jax_convert_pth
from maua_style_tpu.models.convert import load_npz_params as jax_load_npz
from maua_style_tpu.models.convert import save_npz_params as jax_save_npz
from maua_style_tpu_torch.models import Extractor, ExtractorSpec, Layer, init_params, select_model, truncate_spec
from maua_style_tpu_torch.models.convert import (
    load_npz_params,
    load_torch_state_dict,
    params_from_jax,
    save_npz_params,
)
from maua_style_tpu_torch.models.registry import load_params
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

HIGHEST = jax.lax.Precision.HIGHEST


def _np_params(params):
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in params.items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _close(got, want, rtol):
    """max |got - want| <= rtol * max |want|: f32 convolutions summed in
    another order (XLA vs oneDNN) differ by a few ulps per layer."""
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


VGG_LAYERS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu4_2", "relu5_1")


def test_vgg19_activations_match_jax():
    jspec = jax_registry.select_model("vgg19")
    params = jax_ext.init_params(jspec)
    x = np.random.default_rng(0).normal(0, 50, (1, 32, 48, 3)).astype(np.float32)
    want = jax_ext.apply_extractor(params, jnp.asarray(x), jspec, VGG_LAYERS, HIGHEST, pack_stem=False)
    ext = Extractor(select_model("vgg19"), params_from_jax(_np_params(params)))
    got = ext(_nchw(x), VGG_LAYERS)
    assert list(got) == list(VGG_LAYERS)
    for l in VGG_LAYERS:
        assert got[l].shape == _nchw(np.asarray(want[l])).shape
        _close(_nhwc(got[l]), np.asarray(want[l]), 1e-5)


@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_vgg_input_gradient_matches_jax(pooling):
    """Gradients through pools with inputs free of ties before the ReLU:
    tied zeros after it get no gradient either way."""
    jspec = jax_ext.truncate_spec(jax_registry.select_model("vgg19", pooling), ["relu3_1"])
    params = jax_ext.init_params(jspec)
    x = np.random.default_rng(1).normal(0, 50, (1, 20, 26, 3)).astype(np.float32)
    w = np.random.default_rng(2).normal(size=(1, 5, 6, 256)).astype(np.float32)

    def f(xx):
        a = jax_ext.apply_extractor(params, xx, jspec, ["relu3_1"], HIGHEST)["relu3_1"]
        return jnp.sum(a * w)

    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    ext = Extractor(truncate_spec(select_model("vgg19", pooling), ["relu3_1"]), params_from_jax(_np_params(params)))
    xt = _nchw(x).requires_grad_(True)
    (ext(xt, ["relu3_1"])["relu3_1"] * _nchw(w)).sum().backward()
    _close(_nhwc(xt.grad), want, 1e-5)


def _ceil_spec(kind):
    # NIN-shaped: 3x3/s2 ceil-mode pools and a 6x6/s1 ceil-mode avg pool
    conv = lambda n, o, k, p: Layer("conv", n, out_ch=o, kernel=(k, k), stride=(1, 1), pad=(p, p))
    return ExtractorSpec("ceil", (
        conv("c1", 8, 3, 1), Layer("relu", "r1"),
        Layer(kind, "p1", kernel=(3, 3), stride=(2, 2), ceil_mode=True),
        conv("c2", 12, 1, 0), Layer("relu", "r2"),
        Layer(kind, "p2", kernel=(3, 3), stride=(2, 2), ceil_mode=True),
        Layer("avgpool", "p3", kernel=(6, 6), stride=(1, 1), ceil_mode=True),
        Layer("softmax", "sm"),
    ))


@pytest.mark.parametrize("kind", ["maxpool", "avgpool"])
@pytest.mark.parametrize("hw", [(17, 23), (16, 20), (7, 9)])
def test_ceil_mode_pools_match_jax(kind, hw):
    spec = _ceil_spec(kind)
    jspec = jax_ext.ExtractorSpec(spec.arch, tuple(jax_ext.Layer(**vars(l)) for l in spec.layers))
    params = jax_ext.init_params(jspec, seed=3)
    x = np.random.default_rng(4).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    names = ("p1", "p2", "p3", "sm")
    want = jax_ext.apply_extractor(params, jnp.asarray(x), jspec, names, HIGHEST)
    got = Extractor(spec, params_from_jax(_np_params(params)))(_nchw(x), names)
    for l in names:
        assert _nhwc(got[l]).shape == np.asarray(want[l]).shape, l
        _close(_nhwc(got[l]), np.asarray(want[l]), 1e-5)


def test_nin_spec_runs_and_matches_names():
    spec = select_model("nin")
    assert spec.layer_names() == jax_registry.select_model("nin").layer_names()
    ext = Extractor(truncate_spec(spec, ["relu7"]), init_params(spec))
    out = ext(torch.zeros(1, 3, 67, 75), ["relu1", "relu7"])
    assert out["relu7"].shape[1] == 384


@pytest.mark.parametrize("name", ["vgg19", "vgg16", "sod", "fcn32s", "nyud", "prune", "nin"])
def test_specs_equal_jax(name):
    for pooling in ("max", "avg"):
        got, want = select_model(name, pooling), jax_registry.select_model(name, pooling)
        assert (got.arch, got.in_ch) == (want.arch, want.in_ch)
        assert [vars(l) for l in got.layers] == [vars(l) for l in want.layers]


def test_npz_round_trip_both_ways(tmp_path):
    spec = select_model("prune")
    jspec = jax_registry.select_model("prune")
    rng, in_ch, jparams = np.random.default_rng(5), 3, {}
    for layer in jspec.conv_layers:
        kh, kw = layer.kernel
        jparams[layer.name] = {"w": rng.normal(size=(kh, kw, in_ch, layer.out_ch)).astype(np.float32),
                               "b": rng.normal(size=layer.out_ch).astype(np.float32)}
        in_ch = layer.out_ch
    jax_save_npz(jparams, str(tmp_path / "jax.npz"))
    sd = load_npz_params(spec, str(tmp_path / "jax.npz"))
    for name, p in sd.items():
        assert p.dtype == torch.float32 and p.is_contiguous()
    want = params_from_jax(_np_params(jparams))
    assert set(sd) == set(want)
    for k in sd:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)

    save_npz_params(sd, str(tmp_path / "torch.npz"))
    back = jax_load_npz(jspec, str(tmp_path / "torch.npz"))
    for name in jparams:
        np.testing.assert_array_equal(np.asarray(back[name]["w"]), np.asarray(jparams[name]["w"]))
        np.testing.assert_array_equal(np.asarray(back[name]["b"]), np.asarray(jparams[name]["b"]))


def test_pth_loader_matches_jax_converter(tmp_path):
    spec = select_model("vgg16")
    sd = init_params(spec, seed=7)
    feats, i = {}, 0
    for layer in spec.layers:  # a reference-style nn.Sequential "features" dict
        if layer.kind == "conv":
            feats[f"features.{i}.weight"] = sd[f"{layer.name}.weight"]
            feats[f"features.{i}.bias"] = torch.randn(layer.out_ch)
        i += 1
    torch.save(feats, tmp_path / "vgg16.pth")
    got = load_torch_state_dict(spec, str(tmp_path / "vgg16.pth"))
    want = params_from_jax(_np_params(jax_convert_pth(jax_registry.select_model("vgg16"), str(tmp_path / "vgg16.pth"))))
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert load_params(spec, str(tmp_path / "vgg16.pth")).keys() == got.keys()


def test_missing_checkpoint_raises_unless_allowed(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MAUA_ALLOW_RANDOM_WEIGHTS", raising=False)
    spec = select_model("vgg19")
    with pytest.raises(FileNotFoundError, match="allow_random_weights"):
        load_params(spec, "vgg19")
    sd = load_params(spec, "vgg19", allow_random=True)
    monkeypatch.setenv("MAUA_ALLOW_RANDOM_WEIGHTS", "1")
    again = load_params(spec, "vgg19")
    for k in sd:
        torch.testing.assert_close(sd[k], again[k], rtol=0, atol=0)  # seeded: deterministic
    w = sd["conv3_1.weight"]
    assert abs(float(w.std()) - (2.0 / (9 * 128)) ** 0.5) < 0.01  # He-normal
