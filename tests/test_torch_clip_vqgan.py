"""The port's CLIP + VQGAN engine and CLI (``pipelines/clip_vqgan.py``)
against the JAX package's on the CPU, on JAX's tiny test configs
(``tests/test_clip_vqgan.py``'s) and JAX's own weights and draws.

JAX's engines run once, in a module fixture: a styled text-guided run with
an odd-sized init (35x33, cropped to 34x32) in two chunks, then
``optimize_cached``; a masked run with both texts on a second engine; and
the CLI.  Their threefry keys are recorded as the engines draw them and
replayed to the port as (phase, offsets) cutout draws, in the order the
port asks for them.

Bars: loss logs and images within 1e-4 (max|Δ|; both start from the same
quantised latent and take the same Adam steps, float32 sums in another
order); the CLI's artifact name and log lines equal in form, their
numbers within rtol 1e-4, its JPEG within the repo's u8 drift bounds
(max <= 6, mean <= 0.5)."""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from maua_style_tpu.models import vqgan as jax_vq
from maua_style_tpu.models.clip import model as jax_clip_model
from maua_style_tpu.pipelines import clip_vqgan as jax_cv
from maua_style_tpu_torch.models import vqgan as vq
from maua_style_tpu_torch.models.clip import model as clip_model
from maua_style_tpu_torch.models.clip.convert import clip_from_state_dict, clip_params_from_jax
from maua_style_tpu_torch.pipelines import clip_vqgan as cv
from test_torch_grads_cutouts import _Replay, jax_cutout_draw
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

TINY_VQ = dict(embed_dim=8, n_embed=32, ch=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
               resolution=16, z_channels=8)
TINY_CLIP = dict(image_resolution=32, patch_size=16, vision_width=32, vision_layers=2, vision_heads=2,
                 embed_dim=16, text_width=32, text_heads=2, text_layers=2)
CUTN, PHASES = 4, 4


def _draws(keys, layout, cutn=CUTN):
    """Replay items for recorded keys: ``layout`` says, key by key, whether
    it was one cutout call (1) or a chunk's parent key split into n."""
    items = []
    for key, n in zip(keys, layout):
        subkeys = [key] if n == 1 else list(jax.random.split(key, n))
        items += [jax_cutout_draw(k, cutn, PHASES) for k in subkeys]
    return items


@pytest.fixture(scope="module")
def ref():
    """Weights, inputs, and JAX's results and recorded keys."""
    rng = np.random.default_rng(0)
    vq_cfg, clip_cfg = jax_vq.VQGANConfig(**TINY_VQ), jax_clip_model.CLIPConfig(**TINY_CLIP)
    vq_tree = jax.tree_util.tree_map(np.asarray, jax_vq.init_vqgan_params(vq_cfg, 0))
    clip_tree = jax.tree_util.tree_map(np.asarray, jax_clip_model.init_clip_params(clip_cfg, 0))
    data = {
        "init": rng.random((1, 35, 33, 3)).astype(np.float32),
        "style": rng.random((1, 32, 32, 3)).astype(np.float32),
        "init2": rng.random((1, 32, 32, 3)).astype(np.float32),
        "content2": rng.random((1, 32, 32, 3)).astype(np.float32),
        "mask": rng.random((1, 20, 24, 1)).astype(np.float32),
    }
    keys = []
    orig_next_key = jax_cv.ClipVQGANEngine._next_key

    def recording_next_key(self):
        keys.append(orig_next_key(self))
        return keys[-1]

    out = {"vq_tree": vq_tree, "clip_tree": clip_tree, **data}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAUA_ALLOW_RANDOM_WEIGHTS", "1")
        mp.setattr(jax_vq, "load_vqgan", lambda d, s=0: (jax.tree_util.tree_map(jnp.asarray, vq_tree), vq_cfg))
        mp.setattr(jax_cv, "_load_clip", lambda b: jax_cv.CLIP(jax.tree_util.tree_map(jnp.asarray, clip_tree), cfg=clip_cfg))
        mp.setattr(jax_cv.ClipVQGANEngine, "_next_key", recording_next_key)

        eng = jax_cv.ClipVQGANEngine("tiny", "ViT-B/32", cutn=CUTN)
        saves = []
        out["styled"] = eng.optimize(data["init"], data["init"].copy(), [data["style"]], None, None, "a style",
                                     iterations=4, save_every=2, save_callback=lambda img, i: saves.append((i, img)))
        out["styled_log"], out["styled_saves"] = eng.last_loss_log, saves
        out["styled_draws"] = _draws(keys, [1, 1, 2, 2])
        del keys[:]
        out["cached"] = eng.optimize_cached(data["init"], data["init"], [data["style"]], None, None, "a style",
                                            1.0, 1.0, 1.0, 2)
        out["cached_log"] = eng.last_loss_log
        out["cached_draws"] = _draws(keys, [1, 1, 2])
        del keys[:]

        eng2 = jax_cv.ClipVQGANEngine("tiny", "ViT-B/32", cutn=CUTN, seed=1)
        out["masked"] = eng2.optimize(data["init2"], data["content2"], None, data["mask"], "a content", "a style",
                                      content_weight=0.5, style_weight=1.0, text_weight=2.0, iterations=3)
        out["masked_log"] = eng2.last_loss_log
        out["masked_draws"] = _draws(keys, [1, 3])
        del keys[:]
    return out


def _patch_port_loaders(ref, monkeypatch):
    """The port's loaders hand out JAX's tiny weights."""
    vq_cfg, clip_cfg = vq.VQGANConfig(**TINY_VQ), clip_model.CLIPConfig(**TINY_CLIP)
    monkeypatch.setattr(vq, "load_vqgan", lambda d, s=0: vq.vqgan_from_state_dict(vq.vqgan_params_from_jax(ref["vq_tree"]), vq_cfg))
    monkeypatch.setattr(cv, "_load_clip", lambda b: clip_from_state_dict(clip_params_from_jax(ref["clip_tree"]), clip_cfg))


def _port_engine(ref, monkeypatch, draws, seed=0):
    _patch_port_loaders(ref, monkeypatch)
    return cv.ClipVQGANEngine("tiny", "ViT-B/32", cutn=CUTN, seed=seed, device="cpu", draws=draws)


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol, err


def test_engine_matches_jax_on_odd_sized_init(ref, monkeypatch):
    """35x33 is cropped to 34x32 (multiples of the factor 2); 4 iterations
    in two chunks of 2; log terms: content, one style, from (0), to."""
    draws = _Replay(ref["styled_draws"])
    eng = _port_engine(ref, monkeypatch, draws)
    saves = []
    out = eng.optimize(ref["init"], ref["init"].copy(), [ref["style"]], None, None, "a style",
                       iterations=4, save_every=2, save_callback=lambda img, i: saves.append((i, img)))
    assert not draws.items
    assert out.shape == (1, 34, 32, 3) and out.min() >= 0 and out.max() <= 1
    assert eng.last_loss_log.shape == (4, 4) and not eng.last_loss_log[:, 2].any()
    _close(eng.last_loss_log, ref["styled_log"])
    _close(out, ref["styled"])
    assert [i for i, _ in saves] == [i for i, _ in ref["styled_saves"]] == [2, 4]
    for (_, got), (_, want) in zip(saves, ref["styled_saves"]):
        _close(got, want)


def test_optimize_cached_matches_jax(ref, monkeypatch):
    """The same engine after the styled run: the cached targets embed the
    style once (its draw comes first), then the run."""
    draws = _Replay(ref["styled_draws"] + ref["cached_draws"])
    eng = _port_engine(ref, monkeypatch, draws)
    eng.optimize(ref["init"], ref["init"].copy(), [ref["style"]], None, None, "a style", iterations=4, save_every=2)
    out = eng.optimize_cached(ref["init"], ref["init"], [ref["style"]], None, None, "a style", 1.0, 1.0, 1.0, 2)
    assert not draws.items and eng.target_embeds is not None
    _close(eng.last_loss_log, ref["cached_log"])
    _close(out, ref["cached"])


def test_masked_run_matches_jax(ref, monkeypatch):
    """A (20, 24) mask resampled to the latent grid, gradient through
    replace_grad(z, z·mask); both texts; weights 0.5 / 1 / 2."""
    draws = _Replay(ref["masked_draws"])
    eng = _port_engine(ref, monkeypatch, draws, seed=1)
    out = eng.optimize(ref["init2"], ref["content2"], None, ref["mask"], "a content", "a style",
                       content_weight=0.5, style_weight=1.0, text_weight=2.0, iterations=3)
    assert not draws.items
    assert eng.last_loss_log.shape == (3, 3) and (eng.last_loss_log[:, 1] < 0).all()  # the from term, weight -2
    _close(eng.last_loss_log, ref["masked_log"])
    _close(out, ref["masked"])


def _cli_argv(out_dir, style_path):
    return ["--content", "random", "--content_text", "A red", "--style", style_path, "--style_text", "blue sky",
            "--image_size", "32", "--iterations", "3", "--seed", "5", "--out_dir", out_dir, "--allow_random_weights"]


def test_cli_matches_jax(ref, monkeypatch, tmp_path):
    """``main`` with ``--gpu c``: the JAX CLI's artifact name, log lines and
    image, on JAX's draws for the CLI's engine (seed 5)."""
    style_path = str(tmp_path / "Style.png")
    Image.fromarray((ref["style"][0] * 255).astype(np.uint8)).save(style_path)
    vq_cfg, clip_cfg = jax_vq.VQGANConfig(**TINY_VQ), jax_clip_model.CLIPConfig(**TINY_CLIP)
    keys = []
    orig_next_key = jax_cv.ClipVQGANEngine._next_key

    def recording_next_key(self):
        keys.append(orig_next_key(self))
        return keys[-1]

    monkeypatch.setattr(jax_vq, "load_vqgan", lambda d, s=0: (jax.tree_util.tree_map(jnp.asarray, ref["vq_tree"]), vq_cfg))
    monkeypatch.setattr(jax_cv, "_load_clip", lambda b: jax_cv.CLIP(jax.tree_util.tree_map(jnp.asarray, ref["clip_tree"]), cfg=clip_cfg))
    monkeypatch.setattr(jax_cv.ClipVQGANEngine, "_next_key", recording_next_key)
    jax_out = io.StringIO()
    with contextlib.redirect_stdout(jax_out):
        jax_cv.main(_cli_argv(str(tmp_path / "jax"), style_path))

    draws = _Replay(_draws(keys, [1, 1, 3], cutn=64))  # the CLI's engine has the default cutn
    _patch_port_loaders(ref, monkeypatch)
    monkeypatch.setattr(cv, "CutoutDraws", lambda seed: draws if seed == 5 else pytest.fail(f"seed {seed}"))
    port_out = io.StringIO()
    with contextlib.redirect_stdout(port_out):
        cv.main(_cli_argv(str(tmp_path / "port"), style_path) + ["--gpu", "c"])
    assert not draws.items

    name = "random-a-red-style-blue-sky-imagenet_16384.jpg"
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [name]

    def lines(text, d):
        return [ln.replace(str(tmp_path / d), "OUT") for ln in text.splitlines() if ln.startswith(("i: ", "saved "))]

    got, want = lines(port_out.getvalue(), "port"), lines(jax_out.getvalue(), "jax")
    assert len(got) == len(want) == 3 and got[-1] == want[-1] == f"saved OUT/{name}"
    for g, w in zip(got[:-1], want[:-1]):
        def numbers(ln):
            return [float(v) for v in ln.replace("[", " ").replace("]", " ").replace(",", " ").split()[1:] if v != "loss:"]

        assert g.split(",")[0] == w.split(",")[0] == "i: 3"
        np.testing.assert_allclose(numbers(g), numbers(w), rtol=1e-4, atol=1e-6)
    a = np.asarray(Image.open(tmp_path / "port" / name), np.float64)
    b = np.asarray(Image.open(tmp_path / "jax" / name), np.float64)
    d = np.abs(a - b)
    assert a.shape == (32, 32, 3) and d.max() <= 6 and d.mean() <= 0.5, (d.max(), d.mean())


def test_missing_checkpoints_fail_loud(monkeypatch, tmp_path):
    monkeypatch.delenv("MAUA_ALLOW_RANDOM_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)  # no modelzoo/ here
    with pytest.raises(FileNotFoundError, match="allow_random_weights"):
        vq.load_vqgan("imagenet_16384")
    with pytest.raises(FileNotFoundError, match="allow_random_weights"):
        cv._load_clip("ViT-B/32")
    with pytest.raises(FileNotFoundError, match="allow_random_weights"):
        cv.main(["--content", "random", "--style_text", "x", "--gpu", "c"])
    with pytest.raises(FileNotFoundError, match="no source for RN101"):
        cv._load_clip("RN101")


class _Asked(Exception):
    pass


@pytest.mark.parametrize("backbone", ["ViT-B/32", "RN50", "RN101", "RN50x4"])
@pytest.mark.parametrize("vqgan_dir", ["imagenet_16384", "some/local_dir"])
def test_download_weights_names(monkeypatch, tmp_path, backbone, vqgan_dir):
    """``--download_weights`` asks ``io/download.ensure_weights`` for the
    backbone's CLIP checkpoint, the BPE vocabulary and the VQGAN checkpoint
    when ``vqgan_dir`` names a source.  JAX's CLI asks for the same names
    for ViT-B/32 and RN50; for RN101 it asks for ViT-B/32's file and for
    RN50x4 for RN50's, neither of which those backbones read: the port
    asks for no CLIP file there (none has a source), and ``_load_clip``
    names the one that stays missing."""
    from maua_style_tpu.io import download as jax_dl
    from maua_style_tpu_torch.io import download as dl

    monkeypatch.chdir(tmp_path)
    asked = {}

    def stub(key):
        def ensure_weights(names, enabled=True):
            asked[key] = list(names)
            raise _Asked

        return ensure_weights

    monkeypatch.setattr(dl, "ensure_weights", stub("port"))
    monkeypatch.setattr(jax_dl, "ensure_weights", stub("jax"))
    argv = ["--content", "random", "--style_text", "x", "--download_weights", "--clip_backbone", backbone,
            "--vqgan_dir", vqgan_dir]
    with pytest.raises(_Asked):
        cv.main([*argv, "--gpu", "c"])
    with pytest.raises(_Asked):
        jax_cv.main(argv)
    tail = ["bpe_vocab"] + (["imagenet_16384"] if vqgan_dir == "imagenet_16384" else [])
    assert asked["port"] == {"ViT-B/32": ["clip_vitb32"], "RN50": ["clip_rn50"]}.get(backbone, []) + tail
    if backbone in ("ViT-B/32", "RN50"):
        assert asked["port"] == asked["jax"]
    else:
        assert asked["jax"] == [{"RN101": "clip_vitb32", "RN50x4": "clip_rn50"}[backbone]] + tail


def test_gpu_is_the_default(monkeypatch):
    """Without ``--gpu c`` / ``device="cpu"`` the engine and the CLI ask for
    CUDA, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="gpu c"):
        cv.ClipVQGANEngine("tiny")
    with pytest.raises(RuntimeError, match="gpu c"):
        cv.main(["--content", "random", "--style_text", "x", "--allow_random_weights"])


def test_get_engine_is_one_per_process(ref, monkeypatch):
    _patch_port_loaders(ref, monkeypatch)
    monkeypatch.setattr(cv, "_ENGINE", None)
    a = cv.get_engine("tiny", "ViT-B/32", device="cpu")
    assert cv.get_engine("tiny", "ViT-B/32", device="cpu") is a and a.device == torch.device("cpu")


@pytest.mark.parametrize("size,max_dim,scale_up", [((640, 480), 256, False), ((200, 300), 256, False),
                                                    ((200, 300), 256, True), ((300, 301), 256, True)])
def test_size_to_fit(size, max_dim, scale_up):
    assert cv.size_to_fit(size, max_dim, scale_up) == jax_cv.size_to_fit(size, max_dim, scale_up)
