"""The port's UnFlow (FlowNetC) and LiteFlowNet against the JAX package's
on the CPU: forwards with numpy weights carried across by
``flow_params_from_jax``, the shape-ordered torch-checkpoint converter
against JAX's ``convert_flow_checkpoint``, the layout each net hands the
cost volume, and the flow ensemble over both nets against JAX's.
Bar: max|Δ| / max|flow| <= 1e-4 (float32 convolutions summed in another
order through a few dozen layers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_style_tpu import flow as jax_flow
from maua_style_tpu.models.flownets import LiteFlowNet as JaxLiteFlowNet
from maua_style_tpu.models.flownets import UnFlow as JaxUnFlow
from maua_style_tpu.models.flownets import liteflownet as jax_liteflownet
from maua_style_tpu.models.flownets import pwc as jax_pwc
from maua_style_tpu.models.flownets import spynet as jax_spynet
from maua_style_tpu.models.flownets import unflow as jax_unflow
from maua_style_tpu.models.flownets.convert import convert_flow_checkpoint
from maua_style_tpu_torch import flow
from maua_style_tpu_torch.models.flownets import LiteFlowNet, UnFlow, convert, liteflownet, unflow
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

KINDS = ["unflow", "liteflownet"]
_JAX = {"unflow": (JaxUnFlow, jax_unflow._layout), "liteflownet": (JaxLiteFlowNet, jax_liteflownet._layout)}
_PORT = {"unflow": (UnFlow, unflow), "liteflownet": (LiteFlowNet, liteflownet)}


def _jax_layout(kind):
    if kind == "spynet":
        return [e for level in range(jax_spynet.N_LEVELS) for e in jax_spynet._level_layout(level)]
    return jax_pwc._layout() if kind == "pwc" else _JAX[kind][1]()


def _np_params(kind, seed):
    """He-normal weights and small biases in the JAX layout, from numpy."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, cin, cout, k in _jax_layout(kind):
        shape = (k, k, cout, cin) if k == 4 else (k, k, cin, cout)
        params[name] = {
            "w": (rng.standard_normal(shape) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32),
            "b": (rng.standard_normal(cout) * 0.01).astype(np.float32),
        }
    return params


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def test_layouts_match_jax():
    for kind in KINDS:
        assert _PORT[kind][1].layout() == _JAX[kind][1]()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hw", [(64, 64), (128, 192)])
def test_forward_matches_jax(kind, hw):
    """At 64² UnFlow's deepest level is 1 x 1 and its deconvs start there."""
    params = _np_params(kind, 3)
    jax_net = _JAX[kind][0]({k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in params.items()})
    net = _PORT[kind][0]()
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


_UNFLOW_KEYS = {
    # sniklaus pytorch-unflow's FlowNetC (moduleFlownets.0): the decoder
    # registers each level's flow head and up-flow before the next deconv
    "feat/conv1": "moduleOne.0", "feat/conv2": "moduleTwo.0", "feat/conv3": "moduleThr.0",
    "redir": "moduleRedir.0", "conv3_1": "moduleFou.0", "conv4": "moduleFou.2", "conv4_1": "moduleFou.4",
    "conv5": "moduleFiv.0", "conv5_1": "moduleFiv.2", "conv6": "moduleSix.0", "conv6_1": "moduleSix.2",
    "flow6": "moduleUpconv.moduleSixOut", "upflow6": "moduleUpconv.moduleSixUp",
    "deconv5": "moduleUpconv.moduleFivNext.0", "flow5": "moduleUpconv.moduleFivOut",
    "upflow5": "moduleUpconv.moduleFivUp", "deconv4": "moduleUpconv.moduleFouNext.0",
    "flow4": "moduleUpconv.moduleFouOut", "upflow4": "moduleUpconv.moduleFouUp",
    "deconv3": "moduleUpconv.moduleThrNext.0", "flow3": "moduleUpconv.moduleThrOut",
    "upflow3": "moduleUpconv.moduleThrUp", "deconv2": "moduleUpconv.moduleTwoNext.0",
    "flow2": "moduleUpconv.moduleTwoOut",
}
_LVL = {1: "One", 2: "Two", 3: "Thr", 4: "Fou", 5: "Fiv", 6: "Six"}


def _sniklaus(kind, params) -> dict:
    """The JAX parameters as a torch state dict in a sniklaus module's
    insertion order and naming, torch layouts; UnFlow's CSS checkpoint also
    carries the refinement nets' tensors, which the converter leaves over."""
    sd = {}

    def put(key, p):
        sd[key + ".weight"] = torch.from_numpy(np.ascontiguousarray(p["w"].transpose(3, 2, 0, 1)))
        sd[key + ".bias"] = torch.from_numpy(p["b"].copy())

    if kind == "unflow":
        for layer, key in _UNFLOW_KEYS.items():
            put("moduleFlownets.0." + key, params[layer])
        rng = np.random.default_rng(7)
        sd["moduleFlownets.1.moduleOne.0.weight"] = torch.from_numpy(rng.standard_normal((64, 12, 7, 7)).astype(np.float32))
        sd["moduleFlownets.1.moduleUpconv.moduleSixUp.weight"] = torch.from_numpy(rng.standard_normal((2, 2, 4, 4)).astype(np.float32))
    else:
        for name in params:
            part, layer = name.split("/")
            unit, lvl = part[:-1], int(part[-1])
            group = {"enc": "netFeatures", "m": "netMatching", "s": "netSubpixel", "r": "netRegularization"}[unit]
            put(f"{group}.net{_LVL[lvl]}.{layer}", params[name])
    return sd


@pytest.mark.parametrize("kind", KINDS)
def test_torch_checkpoint_matches_jax_converter(kind):
    params = _np_params(kind, 4)
    sd = _sniklaus(kind, params)
    jax_params = convert_flow_checkpoint(kind, {"state_dict": sd})
    want = convert.flow_params_from_jax(kind, {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jax_params.items()})
    got = convert.flow_params_from_torch(kind, {"state_dict": sd})
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # every layer lands where it belongs, and the state dict fits the module
    placed = convert.flow_params_from_jax(kind, params)
    for k in placed:
        assert torch.equal(got[k], placed[k]), k
    _PORT[kind][0]().load_state_dict(got)


@pytest.mark.parametrize("kind", KINDS)
def test_wrong_shape_raises_in_both(kind):
    sd = _sniklaus(kind, _np_params(kind, 5))
    key = "moduleFlownets.0.moduleFou.0.weight" if kind == "unflow" else "netMatching.netSix.conv1.weight"
    sd[key] = torch.zeros(sd[key].shape[0], sd[key].shape[1] - 1, *sd[key].shape[2:])
    with pytest.raises(ValueError, match="unmatched layers"):
        convert_flow_checkpoint(kind, {k: v.numpy() for k, v in sd.items()})
    with pytest.raises(ValueError, match="unmatched layers"):
        convert.flow_params_from_torch(kind, sd)


@pytest.mark.parametrize("kind", KINDS)
def test_nets_hand_the_cost_volume_contiguous_nchw(kind, monkeypatch):
    """The CUDA kernel refuses a channels-last view: through the ensemble,
    every level's f1 and warped f2 (LiteFlowNet, d = 3, five levels) and
    the two towers (UnFlow, d = 20, s = 2, once) reach it contiguous."""
    module = _PORT[kind][1]
    seen = []
    real = module.correlation

    def checking(f1, f2, d=4, s=1):
        seen.append((f1.is_contiguous() and f2.is_contiguous(), d, s, f1.shape == f2.shape))
        return real(f1, f2, d, s)

    monkeypatch.setattr(module, "correlation", checking)
    net = _PORT[kind][0]().eval()
    frames = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 40, 70, 3), dtype=np.uint8))
    with torch.inference_mode():
        flow._ensemble([net], frames, frames.flip(2))
    want = [(True, 20, 2, True)] if kind == "unflow" else [(True, 3, 1, True)] * 5
    assert seen == want


def _write_modelzoo(d, kinds, seed=9):
    (d / "modelzoo").mkdir()
    for i, kind in enumerate(kinds):
        params = _np_params(kind, seed + i)
        np.savez(d / "modelzoo" / f"{kind}.npz",
                 **{f"{layer}/{k}": v for layer, p in params.items() for k, v in p.items()})


class _Args:
    allow_random_weights = False
    device = "cpu"

    def __init__(self, flow_models):
        self.flow_models = flow_models


@pytest.mark.parametrize("models", ["unflow,liteflownet", "spynet,pwc,unflow,liteflownet"])
def test_flow_ensemble_matches_jax(models, tmp_path, monkeypatch):
    """``get_flow_model`` over the two nets, and the pre-pass pair model
    over all four, against JAX's, every net read from one modelzoo npz;
    both net caches emptied so that no other test's net leaks in."""
    _write_modelzoo(tmp_path, models.split(","))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_flow, "_MODEL_CACHE", {})
    monkeypatch.setattr(flow, "_MODEL_CACHE", {})
    rng = np.random.default_rng(3)
    ims1 = rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)
    ims2 = np.roll(ims1, 2, axis=2)
    args = _Args(models)
    if models == "unflow,liteflownet":
        want = np.asarray(jax_flow.get_flow_model(args)(ims1[0], ims2[0]))
        got = flow.get_flow_model(args)(ims1[0], ims2[0])
        assert got.shape == want.shape == (40, 56, 2)
        assert np.abs(want).max() > 0
        assert _rel(got, want) <= 1e-4, _rel(got, want)
        return
    want = jax_flow.get_flow_pair_model(args).batched(ims1, ims2)
    got = flow.get_flow_pair_model(args).batched(ims1, ims2)
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape == (2, 40, 56, 2)
        assert _rel(g, w) <= 1e-4, _rel(g, w)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_random_init_is_seeded(kind):
    cls = _PORT[kind][0]
    a, b, c = cls(seed=0), cls(seed=0), cls(seed=1)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    first = next(iter(a.state_dict()))
    assert not torch.equal(a.state_dict()[first], c.state_dict()[first])
