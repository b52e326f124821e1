"""The port's ResNet CLIP (``models/clip/resnet.py``, its converters and
the clip_vqgan engine on it) against the JAX package's on the CPU.

- The visual tower at a tiny config (blocks (1, 1, 1, 1), width 8,
  resolution 64, and 72, where stage 3 pools an odd side of 9 to 4) on
  JAX's ``init_resnet_visual`` tree carried across by
  ``clip_params_from_jax``, and the text tower on JAX's text tree: image
  and text embeddings within max|Δ| / max|embedding| <= 1e-4, and the
  image tower's input gradient within max|Δ| / max|g| <= 1e-4 (float32
  convolutions and products summed in another order).
- BatchNorm from running statistics only: an image's embedding alone and
  inside a batch of 4 agree within 1e-5 (relative), in train mode too.
- OpenAI-keyed state dicts, with the shortcut at ``downsample.0/1`` and at
  ``.1/.2``: JAX's converter and the port's give the same embeddings
  (1e-4) and infer the same backbone name.
- ``_load_clip`` on a JAX-written ``modelzoo/clip_rn50.npz``, with RN50's
  configs set to the tiny ones on both sides (1e-4).
- The clip_vqgan engine on the tiny backbone: loss log and image within
  max|Δ| <= 1e-4 of JAX's, on JAX's cutout draws replayed
  (``test_torch_clip_vqgan``'s replay), at Adam's learning rate 1e-4.
  At the default 0.05 Adam turns gradient entries of float-noise size
  into full steps and the random codebook's near-ties flip codes, so the
  log is chaotic after two iterations (at one torch thread, iteration 3
  was 2.5e-3 off, at eight it agreed); 1e-4 keeps z inside its codes'
  cells, and the tower's gradient is held to JAX's above."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_style_tpu.models import vqgan as jax_vq
from maua_style_tpu.models.clip import convert as jax_convert
from maua_style_tpu.models.clip import model as jax_model
from maua_style_tpu.models.clip import resnet as jax_resnet
from maua_style_tpu.models.clip.tokenizer import tokenize
from maua_style_tpu.pipelines import clip_vqgan as jax_cv
from maua_style_tpu_torch.models import vqgan as vq
from maua_style_tpu_torch.models.clip import convert, model, resnet
from maua_style_tpu_torch.pipelines import clip_vqgan as cv
from test_torch_grads_cutouts import _Replay
from test_torch_clip_vqgan import TINY_VQ, _close, _draws
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

TEXT = (64, 1, 2)  # text width, heads, layers
TEXTS = ["a painting of a lighthouse", "noise", ""]


def _rn_cfg(res=64):
    return dict(layers=(1, 1, 1, 1), width=8, embed_dim=16, image_resolution=res, heads=4)


def _text_cfg(res=64):
    tw, th, tl = TEXT
    return jax_model.CLIPConfig(image_resolution=res, embed_dim=16, text_width=tw, text_heads=th, text_layers=tl)


def _jax_tree(res=64, seed=0):
    """JAX's random RN tree, numpy leaves: the visual tower from
    ``init_resnet_visual``, the text tower from ``init_clip_params``."""
    tree = {**jax_resnet.init_resnet_visual(jax_resnet.ResNetConfig(**_rn_cfg(res)), seed),
            "text": jax_model.init_clip_params(_text_cfg(res), seed + 1)["text"]}
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _images(res, b=3, seed=0):
    x = np.random.default_rng(seed).random((b, res, res, 3)).astype(np.float32)
    return (x - model.CLIP_MEAN) / model.CLIP_STD


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _patch_rn50(monkeypatch, res=64):
    """RN50's configs set to the tiny ones in both packages."""
    monkeypatch.setitem(jax_resnet.RESNET_CONFIGS, "RN50", jax_resnet.ResNetConfig(**_rn_cfg(res)))
    monkeypatch.setitem(jax_resnet.CLIPResNet.TEXT_CFGS, "RN50", TEXT)
    monkeypatch.setitem(resnet.RESNET_CONFIGS, "RN50", resnet.ResNetConfig(**_rn_cfg(res)))
    monkeypatch.setitem(resnet.TEXT_CFGS, "RN50", TEXT)


@pytest.fixture
def tiny_rn50(monkeypatch):
    _patch_rn50(monkeypatch)


def _openai_sd(tree, shift: bool) -> dict:
    """The tree as an OpenAI RN checkpoint: torch layouts, BatchNorms with
    ``num_batches_tracked``, ``logit_scale``; the shortcut at
    ``downsample.0/1``, or at ``.1/.2`` when ``shift``."""
    sd = dict(convert.clip_params_from_jax(tree))
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k.replace(".running_var", ".num_batches_tracked")] = torch.tensor(0)
    if shift:
        sd = {k.replace(".downsample.1.", ".downsample.2.").replace(".downsample.0.", ".downsample.1."): v
              for k, v in sd.items()}
    sd["logit_scale"] = torch.tensor(4.6)
    return sd


@pytest.mark.parametrize("res", [64, 72])
def test_towers_match_jax(monkeypatch, res):
    """Image and text embeddings of the whole CLIPResNet; at 72 the stages
    run 36 -> 18 -> 18 / 9 / 4 / 2, an odd side pooled with a floor."""
    _patch_rn50(monkeypatch, res)
    tree = _jax_tree(res)
    ref = jax_resnet.CLIPResNet("RN50", jax.tree_util.tree_map(jnp.asarray, tree))
    port = resnet.CLIPResNet.from_backbone("RN50").eval()
    port.load_state_dict(convert.clip_params_from_jax(tree))
    assert port.input_resolution == ref.input_resolution == res and port.backbone == "RN50"
    x = _images(res)
    want = np.asarray(ref.encode_image(jnp.asarray(x)))
    toks = tokenize(TEXTS)
    want_txt = np.asarray(ref.encode_text(toks))
    with torch.no_grad():
        got = port.encode_image(_nchw(x)).numpy()
        got_txt = port.encode_text(toks).numpy()
    assert got.shape == want.shape == (3, 16) and got_txt.shape == want_txt.shape == (3, 16)
    assert _rel(got, want) <= 1e-4, _rel(got, want)
    assert _rel(got_txt, want_txt) <= 1e-4, _rel(got_txt, want_txt)
    # the input gradient through the tower, as the engine's backward takes it
    cot = np.random.default_rng(1).standard_normal((3, 16)).astype(np.float32)
    want_g = np.asarray(jax.grad(lambda xj: jnp.sum(ref.encode_image(xj) * cot))(jnp.asarray(x)))
    xt = _nchw(x).requires_grad_(True)
    (port.encode_image(xt) * torch.from_numpy(cot)).sum().backward()
    got_g = xt.grad.numpy().transpose(0, 2, 3, 1)
    assert _rel(got_g, want_g) <= 1e-4, _rel(got_g, want_g)


def test_batchnorm_never_sees_batch_statistics():
    """One image's embedding alone equals its row in a batch of 4, with the
    module in train mode: BatchNorm reads only its running statistics."""
    tree = _jax_tree(seed=2)
    sd = convert.clip_params_from_jax(tree)
    # non-trivial running statistics, so that batch statistics would differ
    rng = np.random.default_rng(5)
    for k in [k for k in sd if k.endswith("running_mean")]:
        sd[k] = torch.from_numpy(rng.standard_normal(sd[k].shape).astype(np.float32) * 0.1)
        var = k.replace("running_mean", "running_var")
        sd[var] = torch.from_numpy(rng.uniform(0.5, 2.0, sd[var].shape).astype(np.float32))
    port = convert.clip_from_state_dict(sd).train()
    x = _nchw(_images(64, b=4, seed=3))
    with torch.no_grad():
        batch = port.encode_image(x).numpy()
        alone = port.encode_image(x[1:2]).numpy()
    assert _rel(alone, batch[1:2]) <= 1e-5, _rel(alone, batch[1:2])
    assert not np.allclose(batch[0], batch[1])


@pytest.mark.parametrize("shift", [False, True], ids=["downsample.0-1", "downsample.1-2"])
def test_openai_state_dict_through_both_converters(tiny_rn50, shift):
    tree = _jax_tree(seed=4)
    sd = _openai_sd(tree, shift)
    jax_params, jax_name = jax_convert.convert_clip_resnet_state_dict({k: v.numpy() for k, v in sd.items()})
    port = convert.clip_from_state_dict(sd).eval()
    assert port.backbone == jax_name == "RN50"
    assert port.rn_cfg == resnet.ResNetConfig(**_rn_cfg()) and port.cfg.text_width == 64
    ref = jax_resnet.CLIPResNet(jax_name, jax_params)
    x, toks = _images(64, seed=6), tokenize(TEXTS)
    with torch.no_grad():
        got, got_txt = port.encode_image(_nchw(x)).numpy(), port.encode_text(toks).numpy()
    assert _rel(got, np.asarray(ref.encode_image(jnp.asarray(x)))) <= 1e-4
    assert _rel(got_txt, np.asarray(ref.encode_text(toks))) <= 1e-4


def test_backbone_names_inferred_alike():
    """Without a known config both converters name the backbone by its
    block counts; RN50x4's shapes give "RN50x4" in both."""
    sd = _openai_sd(_jax_tree(), False)
    _, jax_name = jax_convert.convert_clip_resnet_state_dict({k: v.numpy() for k, v in sd.items()})
    rn, _ = convert.resnet_config_from_state_dict(sd)
    assert resnet.backbone_name(rn) == jax_name == "RN(1, 1, 1, 1)"
    for name in resnet.RESNET_CONFIGS:
        assert resnet.backbone_name(resnet.RESNET_CONFIGS[name]) == name
        assert resnet.RESNET_CONFIGS[name].__dict__ == jax_resnet.RESNET_CONFIGS[name].__dict__
        assert resnet.TEXT_CFGS[name] == jax_resnet.CLIPResNet.TEXT_CFGS[name]


def test_load_clip_reads_jax_npz(tiny_rn50, tmp_path, monkeypatch):
    tree = _jax_tree(seed=8)
    (tmp_path / "modelzoo").mkdir()
    jax_convert.save_clip_npz(tree, str(tmp_path / "modelzoo" / "clip_rn50.npz"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MAUA_ALLOW_RANDOM_WEIGHTS", raising=False)
    ref, port = jax_cv._load_clip("RN50"), cv._load_clip("RN50").eval()
    assert isinstance(port, resnet.CLIPResNet) and port.rn_cfg == resnet.ResNetConfig(**_rn_cfg())
    x, toks = _images(64, seed=9), tokenize(TEXTS)
    with torch.no_grad():
        got, got_txt = port.encode_image(_nchw(x)).numpy(), port.encode_text(toks).numpy()
    assert _rel(got, np.asarray(ref.encode_image(jnp.asarray(x)))) <= 1e-4
    assert _rel(got_txt, np.asarray(ref.encode_text(toks))) <= 1e-4
    # no file for RN101: an error, or seeded random weights when allowed
    with pytest.raises(FileNotFoundError, match="clip_rn101.npz"):
        cv._load_clip("RN101")
    monkeypatch.setitem(resnet.RESNET_CONFIGS, "RN101", resnet.ResNetConfig(**_rn_cfg()))
    monkeypatch.setitem(resnet.TEXT_CFGS, "RN101", TEXT)
    monkeypatch.setenv("MAUA_ALLOW_RANDOM_WEIGHTS", "1")
    a, b = cv._load_clip("RN101"), resnet.init_clip_resnet("RN101", 0)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k


def test_init_clip_resnet_seeded(tiny_rn50):
    a, b, c = (resnet.init_clip_resnet("RN50", seed) for seed in (0, 0, 1))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.visual.conv1.weight, c.visual.conv1.weight)
    # the JAX package's scales: convs sqrt(2 / fan_in), identity BatchNorms, attnpool width^-1/2
    w = a.visual.layer1[0].conv2.weight
    assert abs(float(w.detach().std()) - np.sqrt(2.0 / (8 * 9))) < 0.03
    assert torch.equal(a.visual.bn1.weight, torch.ones(4)) and not a.visual.bn1.running_mean.any()
    pool = a.visual.attnpool
    assert pool.q_proj.weight.shape == (256, 256) and abs(float(pool.q_proj.weight.detach().std()) - 256 ** -0.5) < 0.005
    assert not pool.c_proj.bias.any() and pool.positional_embedding.shape == (5, 256)


CUTN, LR = 4, 1e-4


def test_engine_matches_jax(tiny_rn50):
    """The clip_vqgan engine with the tiny RN backbone (cuts of 64 from a
    70x66 canvas) and JAX's tiny VQGAN: a style image and a style text,
    3 iterations in one chunk; the port replays JAX's cutout draws."""
    rng = np.random.default_rng(11)
    init = rng.random((1, 70, 66, 3)).astype(np.float32)
    style = rng.random((1, 64, 64, 3)).astype(np.float32)
    vq_cfg = jax_vq.VQGANConfig(**TINY_VQ)
    vq_tree = jax.tree_util.tree_map(np.asarray, jax_vq.init_vqgan_params(vq_cfg, 0))
    clip_tree = _jax_tree(seed=12)
    keys = []
    orig_next_key = jax_cv.ClipVQGANEngine._next_key

    def recording_next_key(self):
        keys.append(orig_next_key(self))
        return keys[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vq, "load_vqgan", lambda d, s=0: (jax.tree_util.tree_map(jnp.asarray, vq_tree), vq_cfg))
        mp.setattr(jax_cv, "_load_clip", lambda b: jax_resnet.CLIPResNet(b, jax.tree_util.tree_map(jnp.asarray, clip_tree)))
        mp.setattr(jax_cv.ClipVQGANEngine, "_next_key", recording_next_key)
        eng = jax_cv.ClipVQGANEngine("tiny", "RN50", cutn=CUTN, learning_rate=LR)
        want = eng.optimize(init, init.copy(), [style], None, None, "a style", iterations=3)
        want_log = eng.last_loss_log

    def port_clip(backbone):
        m = resnet.CLIPResNet.from_backbone(backbone)
        m.load_state_dict(convert.clip_params_from_jax(clip_tree))
        return m

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vq, "load_vqgan", lambda d, s=0: vq.vqgan_from_state_dict(vq.vqgan_params_from_jax(vq_tree),
                                                                             vq.VQGANConfig(**TINY_VQ)))
        mp.setattr(cv, "_load_clip", port_clip)
        draws = _Replay(_draws(keys, [1, 1, 3]))
        port = cv.ClipVQGANEngine("tiny", "RN50", cutn=CUTN, learning_rate=LR, device="cpu", draws=draws)
        got = port.optimize(init, init.copy(), [style], None, None, "a style", iterations=3)
    assert not draws.items and port.cut_size == 64 and isinstance(port.clip, resnet.CLIPResNet)
    assert port.last_loss_log.shape == want_log.shape == (3, 4)
    _close(port.last_loss_log, want_log)
    _close(got, want)
