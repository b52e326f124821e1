"""The port's CLIP (``models/clip``) against the JAX package's on the CPU.

- Tokenizer: the same ids for the same text, on the hash fallback and on
  small merge tables the tests write (16e6 text and gzip formats, Hugging
  Face merges.txt + vocab.json), through ``SimpleTokenizer`` and through
  ``tokenize``'s ``modelzoo/`` search.
- ViT-B/32's towers at a tiny config (two layers, widths 128 and 64) on
  JAX's threefry weights carried across by ``clip_params_from_jax``: image
  and text embeddings within max|Δ| / max|embedding| <= 1e-4 (float32
  products summed in another order).
- Loads: the JAX package's ``.npz``, its tree and an OpenAI-keyed state
  dict give the same module, and JAX's converter reads that state dict to
  the same embeddings (1e-4)."""

import dataclasses
import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_style_tpu.models.clip import convert as jax_convert
from maua_style_tpu.models.clip import model as jax_model
from maua_style_tpu.models.clip import tokenizer as jax_tok
from maua_style_tpu_torch.models.clip import convert, model, resnet, tokenizer
from maua_style_tpu_torch.pipelines import clip_vqgan
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

TINY = model.CLIPConfig(image_resolution=32, patch_size=16, vision_width=128, vision_layers=2, vision_heads=2,
                        embed_dim=32, text_width=64, text_heads=1, text_layers=2)
TEXTS = ["a painting of a cat", "Hello,   world!", "the  THE the", "", "an oil painting in the style of " * 12]
MERGES = ["t h", "th e</w>", "p a", "i n", "in t", "pa int", "in g</w>", "paint ing</w>", "c a", "ca t</w>",
          "o f</w>", "o i", "oi l</w>", "h e", "l l", "he ll", "w o", "r l", "rl d</w>"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.fixture(scope="module")
def jax_clip():
    params = jax_model.init_clip_params(TINY, seed=3)
    return jax_model.CLIP(params, cfg=TINY)


def _tree(jax_clip):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax_clip.params)


@pytest.fixture(scope="module")
def port_clip(jax_clip):
    return convert.clip_from_state_dict(convert.clip_params_from_jax(_tree(jax_clip)), TINY).eval()


def _images(seed=0, b=3):
    x = np.random.default_rng(seed).random((b, 32, 32, 3)).astype(np.float32)
    return (x - model.CLIP_MEAN) / model.CLIP_STD


def _embed_image(m, x_nhwc):
    with torch.no_grad():
        return m.encode_image(torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))).numpy()


def _embed_text(m, toks):
    with torch.no_grad():
        return m.encode_text(toks).numpy()


# ---------------------------------------------------------------------------
# tokenizer


def test_tokenize_fallback_equal():
    got, want = tokenizer.tokenize(TEXTS), jax_tok.tokenize(TEXTS)
    assert got.dtype == want.dtype == np.int32 and got.shape == (len(TEXTS), 77)
    np.testing.assert_array_equal(got, want)
    assert got[-1, -1] == tokenizer.EOT  # truncated to the context


def _write_tables(d, fmt):
    """A merge table in ``fmt`` under ``d``; returns (bpe_path, vocab_json)."""
    body = "\n".join(["#version: 0.2", *MERGES]) + "\n\n"
    if fmt == "16e6.txt.gz":
        path = os.path.join(d, "bpe_simple_vocab_16e6.txt.gz")
        with gzip.open(path, "wb") as f:
            f.write(body.encode("utf-8"))
        return path, None
    if fmt == "16e6.txt":
        path = os.path.join(d, "bpe_simple_vocab_16e6.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write(body)
        return path, None
    path = os.path.join(d, "merges.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(body)
    # an HF vocab.json: the table's tokens under shuffled ids
    toks = list(jax_tok.SimpleTokenizer(bpe_path=path, vocab_json="").encoder)
    ids = np.random.default_rng(0).permutation(len(toks)) + 7
    vocab = os.path.join(d, "vocab.json")
    with open(vocab, "w", encoding="utf-8") as f:
        json.dump({t: int(i) for t, i in zip(toks, ids)}, f)
    return path, vocab


@pytest.mark.parametrize("fmt", ["16e6.txt", "16e6.txt.gz", "hf"])
def test_tokenizer_merge_tables_equal(tmp_path, monkeypatch, fmt):
    d = tmp_path / "modelzoo"
    d.mkdir()
    path, vocab = _write_tables(str(d), fmt)
    port, ref = tokenizer.SimpleTokenizer(bpe_path=path, vocab_json=vocab), jax_tok.SimpleTokenizer(bpe_path=path, vocab_json=vocab)
    assert port.has_vocab and port.bpe_ranks == ref.bpe_ranks and port.encoder == ref.encoder
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text)
    assert port.bpe("painting") == "painting</w>"  # the merge loop ran to one symbol
    # tokenize() finds the table under modelzoo/ (vocab.json too, for the HF table)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tokenizer, "_TOKENIZER", None)
    monkeypatch.setattr(jax_tok, "_TOKENIZER", None)
    np.testing.assert_array_equal(tokenizer.tokenize(TEXTS), jax_tok.tokenize(TEXTS))
    assert tokenizer._TOKENIZER.has_vocab


def test_tokenizer_fallback_warns_once(capsys, monkeypatch):
    monkeypatch.setattr(tokenizer, "_WARNED_NO_VOCAB", False)
    monkeypatch.setattr(tokenizer, "_VOCAB_CANDIDATES", ("/nonexistent/a", "/nonexistent/b"))
    tokenizer.SimpleTokenizer()
    out = capsys.readouterr().out
    assert "Warning" in out and "hash" in out
    tokenizer.SimpleTokenizer()
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# the two towers


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_image_matches_jax(jax_clip, port_clip, seed):
    x = _images(seed)
    want = np.asarray(jax_clip.encode_image(jnp.asarray(x)))
    got = _embed_image(port_clip, x)
    assert got.shape == want.shape == (3, TINY.embed_dim)
    assert _rel(got, want) <= 1e-4, _rel(got, want)


def test_encode_text_matches_jax(jax_clip, port_clip):
    toks = jax_tok.tokenize(TEXTS)
    want = np.asarray(jax_clip.encode_text(toks))
    got = _embed_text(port_clip, toks)
    assert got.shape == want.shape == (len(TEXTS), TINY.embed_dim)
    assert _rel(got, want) <= 1e-4, _rel(got, want)


def test_text_pools_at_eot_under_the_causal_mask(port_clip):
    """Ids after the EOT change nothing (the mask hides later positions and
    the pooling reads the EOT's); ids before it do."""
    toks = jax_tok.tokenize(["a painting of a cat"])
    eot = int(np.argmax(toks[0]))
    after, before = toks.copy(), toks.copy()
    after[0, eot + 1:] = 1234
    before[0, 1] = 4321
    base = _embed_text(port_clip, toks)
    np.testing.assert_array_equal(_embed_text(port_clip, after), base)
    assert np.abs(_embed_text(port_clip, before) - base).max() > 1e-3


# ---------------------------------------------------------------------------
# loads


def test_loads_give_the_same_embeddings(jax_clip, port_clip, tmp_path):
    x, toks = _images(2, 2), jax_tok.tokenize(TEXTS[:2])
    want_img, want_txt = _embed_image(port_clip, x), _embed_text(port_clip, toks)

    npz = str(tmp_path / "clip.npz")
    jax_convert.save_clip_npz(jax_clip.params, npz)
    from_npz = convert.clip_from_state_dict(convert.clip_params_from_jax(convert.load_clip_npz(npz)))
    assert from_npz.cfg == TINY  # inferred from the shapes (heads = width / 64)

    # an OpenAI-keyed state dict, with the keys the port's module does not hold
    sd = {**port_clip.state_dict(), "logit_scale": torch.tensor(4.6052), "input_resolution": torch.tensor(32),
          "context_length": torch.tensor(77), "vocab_size": torch.tensor(49408)}
    from_openai = convert.clip_from_state_dict(sd)
    assert from_openai.cfg == TINY
    for m in (from_npz.eval(), from_openai.eval()):
        np.testing.assert_array_equal(_embed_image(m, x), want_img)
        np.testing.assert_array_equal(_embed_text(m, toks), want_txt)

    # the JAX package reads the same state dict to the same embeddings
    params, cfg = jax_convert.convert_clip_state_dict(sd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(TINY)
    ref = jax_model.CLIP(params, cfg=cfg)
    assert _rel(want_img, np.asarray(ref.encode_image(jnp.asarray(x)))) <= 1e-4
    assert _rel(want_txt, np.asarray(ref.encode_text(toks))) <= 1e-4


def test_converted_keys_are_openai_keys(jax_clip, port_clip):
    sd = convert.clip_params_from_jax(_tree(jax_clip))
    assert set(sd) == set(port_clip.state_dict())
    assert sd["visual.conv1.weight"].shape == (128, 3, 16, 16)
    np.testing.assert_array_equal(sd["visual.conv1.weight"].numpy(),
                                  np.transpose(np.asarray(jax_clip.params["visual"]["conv1_w"]), (3, 2, 0, 1)))
    missing = dict(sd)
    missing.pop("visual.proj")
    with pytest.raises(RuntimeError, match="visual.proj"):
        convert.clip_from_state_dict(missing, TINY)


def test_init_clip_seeded():
    a, b, c = (model.init_clip(TINY, seed).requires_grad_(False) for seed in (0, 0, 1))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.visual.conv1.weight, c.visual.conv1.weight)
    # the JAX package's scales
    assert abs(float(a.token_embedding.weight.std()) - 0.02) < 1e-3
    assert abs(float(a.visual.proj.std()) - 128 ** -0.5) < 0.01
    blk = a.transformer.resblocks[0]
    assert abs(float(blk.mlp.c_fc.weight.std()) - 64 ** -0.5) < 0.01 and not blk.mlp.c_fc.bias.any()
    assert torch.equal(blk.ln_1.weight, torch.ones(64)) and blk.ln_1.eps == 1e-5


@pytest.mark.parametrize("backbone", ["RN50", "RN101", "RN50x4"])
def test_resnet_backbones_not_ported(backbone, monkeypatch, tmp_path):
    """The ResNet backbones, once refused here, are ported: with no
    checkpoint ``_load_clip`` raises naming the backbone's npz unless random
    weights are allowed, and an OpenAI state dict's shapes give the
    backbone's configs and name through the JAX package's inference."""
    monkeypatch.delenv("MAUA_ALLOW_RANDOM_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match=f"clip_{backbone.lower()}.npz"):
        clip_vqgan._load_clip(backbone)
    rn = resnet.RESNET_CONFIGS[backbone]
    tw, th, tl = resnet.TEXT_CFGS[backbone]
    c = rn.width * 32
    shapes = {"visual.conv1.weight": (rn.width // 2, 3, 3, 3), "visual.attnpool.c_proj.weight": (rn.embed_dim, c),
              "visual.attnpool.positional_embedding": ((rn.image_resolution // 32) ** 2 + 1, c),
              "ln_final.weight": (tw,), "text_projection": (tw, rn.embed_dim), "token_embedding.weight": (49408, tw),
              "positional_embedding": (77, tw)}
    shapes.update({f"visual.layer{s + 1}.{i}.conv1.weight": (1,) for s, n in enumerate(rn.layers) for i in range(n)})
    shapes.update({f"transformer.resblocks.{i}.ln_1.weight": (tw,) for i in range(tl)})
    sd = {k: torch.zeros(()).expand(v) for k, v in shapes.items()}
    got, cfg = convert.resnet_config_from_state_dict(sd)
    assert got == rn and resnet.backbone_name(got) == backbone
    assert (cfg.text_width, cfg.text_heads, cfg.text_layers, cfg.embed_dim, cfg.image_resolution) == \
        (tw, th, tl, rn.embed_dim, rn.image_resolution)
