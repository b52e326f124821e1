"""The port's weight provisioning (``io/download.py`` and the converter
entry points it calls) against the JAX package's, with the network cut.

- ``SOURCES`` (names, raw files, URLs, converter kinds), ``names_for_args``
  and ``--list`` equal JAX's.
- ``ensure_weights`` with ``download`` / ``download_drive`` stubbed to
  write a synthetic raw file, in both packages: NIN (the cheapest
  full-shape feature net) from a reference-style ``features.N`` ``.pth``,
  SPyNet from a sniklaus state dict, CLIP ViT and RN at tiny widths from
  OpenAI-keyed state dicts.  The port writes an npz tensor-equal to JAX's
  (the same keys, dtypes and values), and the port's loaders read it.
- A present npz is a no-op, ``enabled=False`` skips the fetch, a present
  raw file converts without a fetch.
- ``--download_weights`` on the port's config reaches ``ensure_weights``.

``urllib.request.urlretrieve`` / ``urlopen`` are patched to fail in every
test, so none can reach the network."""

import os
import shutil
import urllib.request

import jax
import numpy as np
import pytest
import torch

from maua_style_tpu.io import download as jax_dl
from maua_style_tpu.models.clip import model as jax_model
from maua_style_tpu_torch import config, flow
from maua_style_tpu_torch.io import download as dl
from maua_style_tpu_torch.models import init_params, load_params, select_model
from maua_style_tpu_torch.models.clip import convert as clip_convert
from test_torch_clip import TINY
from test_torch_clip_resnet import _jax_tree, _openai_sd
from test_torch_flownets import _np_params, _sniklaus_spynet
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(*a, **k):
        raise OSError("no network in tests")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def test_sources_equal():
    assert list(dl.SOURCES) == list(jax_dl.SOURCES)
    for name, (raw, url, conv) in dl.SOURCES.items():
        jraw, jurl, jconv = jax_dl.SOURCES[name]
        assert (raw, url, conv.__name__) == (jraw, jurl, jconv.__name__), name
    assert dl.MODELZOO == jax_dl.MODELZOO == "modelzoo"


@pytest.mark.parametrize("args", [
    dict(model_file="vgg19"), dict(model_file="modelzoo/vgg16-prune.pth"), dict(model_file="NIN"),
    dict(model_file="nyud-fcn32s-color-heavy.pth"), dict(model_file="something"),
    dict(model_file="vgg19", transfer_type="vid_img", flow_models="spynet,pwc"),
    dict(model_file="vgg16", transfer_type="vid_img", flow_models=["unflow", "liteflownet", "farneback"]),
    dict(model_file="vgg19", transfer_type="img_vid", flow_models="spynet"),
])
def test_names_for_args_equal(args):
    import argparse

    ns = argparse.Namespace(**args)
    assert dl.names_for_args(ns) == jax_dl.names_for_args(ns)


def test_list_equal(capsys):
    dl.main(["--list"])
    got = capsys.readouterr().out
    jax_dl.main(["--list"])
    assert got == capsys.readouterr().out and "clip_vitb32" in got


def _raw_nin(path):
    spec = select_model("nin")
    sd, feats, i = init_params(spec, seed=3), {}, 0
    for layer in spec.layers:  # a reference-style nn.Sequential "features" dict
        if layer.kind == "conv":
            feats[f"features.{i}.weight"] = sd[f"{layer.name}.weight"]
            feats[f"features.{i}.bias"] = torch.randn(layer.out_ch, generator=torch.Generator().manual_seed(i))
        i += 1
    torch.save(feats, path)


def _raw_spynet(path):
    torch.save(_sniklaus_spynet(_np_params("spynet", 6)), path)


def _raw_clip_vit(path):
    tree = jax.tree_util.tree_map(np.asarray, jax_model.init_clip_params(TINY, seed=2))
    sd = dict(clip_convert.clip_params_from_jax(tree))
    sd["logit_scale"] = torch.tensor(4.6)
    torch.save(sd, path)


def _raw_clip_rn(path):
    torch.save(_openai_sd(_jax_tree(seed=5), shift=True), path)


RAW = {"nin": _raw_nin, "spynet": _raw_spynet, "clip_vitb32": _raw_clip_vit, "clip_rn50": _raw_clip_rn}


def _stub_fetch(monkeypatch, module, raw_dir, calls):
    def fetch(source, output_path, *a, **k):
        calls.append(source)
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
        shutil.copy(raw_dir / os.path.basename(output_path), output_path)
        return output_path

    monkeypatch.setattr(module, "download", fetch)
    monkeypatch.setattr(module, "download_drive", fetch)


@pytest.mark.parametrize("name", sorted(RAW))
def test_ensure_weights_writes_jaxs_npz(name, tmp_path, monkeypatch):
    raw_dir = tmp_path / "raw"
    raw_dir.mkdir()
    RAW[name](raw_dir / dl.SOURCES[name][0])
    calls = {"jax": [], "port": []}
    _stub_fetch(monkeypatch, jax_dl, raw_dir, calls["jax"])
    _stub_fetch(monkeypatch, dl, raw_dir, calls["port"])
    for side, mod in (("jax", jax_dl), ("port", dl)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        assert mod.ensure_weights([name]) == [name]
    assert calls["jax"] == calls["port"] == [dl.SOURCES[name][1]]
    with np.load(tmp_path / "jax" / "modelzoo" / f"{name}.npz") as want, \
            np.load(tmp_path / "port" / "modelzoo" / f"{name}.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k

    # the port's loaders read it
    monkeypatch.chdir(tmp_path / "port")
    monkeypatch.delenv("MAUA_ALLOW_RANDOM_WEIGHTS", raising=False)
    if name == "nin":
        sd = load_params(select_model("nin"))
        assert torch.equal(sd["conv1.weight"], torch.load(raw_dir / "nin.pth", weights_only=True)["features.0.weight"])
    elif name == "spynet":
        monkeypatch.setattr(flow, "_MODEL_CACHE", {})
        net = flow._get_net("spynet", torch.device("cpu"), allow_random=False)
        assert sum(p.numel() for p in net.parameters()) > 0
    else:
        tree = clip_convert.load_clip_npz(f"modelzoo/{name}.npz")
        model = clip_convert.clip_from_state_dict(clip_convert.clip_params_from_jax(tree),
                                                  TINY if name == "clip_vitb32" else None)
        raw = torch.load(raw_dir / dl.SOURCES[name][0], weights_only=True)
        key = "visual.conv1.weight"
        assert torch.equal(model.state_dict()[key], raw[key])


def test_present_and_disabled_are_no_ops(tmp_path, monkeypatch):
    calls = []
    raw_dir = tmp_path / "raw"
    raw_dir.mkdir()
    _raw_nin(raw_dir / "nin.pth")
    _stub_fetch(monkeypatch, dl, raw_dir, calls)
    monkeypatch.chdir(tmp_path)
    os.makedirs("modelzoo")
    np.savez("modelzoo/vgg19.npz", x=np.zeros(1))
    assert dl.ensure_weights(["vgg19"]) == [] and calls == []
    assert dl.ensure_weights(["vgg16", "coco"], enabled=False) == [] and calls == []
    assert not os.path.exists("modelzoo/vgg16.npz")
    # a raw file already there converts without a fetch; a data artifact is done
    shutil.copy(raw_dir / "nin.pth", "modelzoo/nin.pth")
    open("modelzoo/coco.ckpt", "wb").close()
    assert dl.ensure_weights(["nin", "coco"]) == ["nin"] and calls == []
    assert os.path.exists("modelzoo/nin.npz")
    with pytest.raises(ValueError, match="unknown weight artifact"):
        dl.ensure_weights(["vgg20"])


def test_fetch_without_network_fails_loud(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(OSError, match="no network"):
        dl.ensure_weights(["vgg19"])
    with pytest.raises(OSError, match="no network"):
        dl.ensure_weights(["prune"])


def test_download_weights_flag_reaches_ensure_weights(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(dl, "ensure_weights", lambda names, enabled=True: seen.append(list(names)) or [])
    monkeypatch.chdir(tmp_path)
    config.get_args(["--content", "c.png", "--style", "s.png", "--download_weights", "--gpu", "c",
                     "--transfer_type", "vid_img", "--flow_models", "spynet,pwc", "--scaling_args", "none.json"])
    assert seen == [["vgg19", "spynet", "pwc"]]
