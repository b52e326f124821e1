"""The port's VQGAN (``models/vqgan.py``) against the JAX package's on the
CPU, on JAX's threefry weights (with biases and norm gains perturbed by
numpy, so that every parameter matters) carried across by
``vqgan_params_from_jax``.

Bars: group norm and each block within 1e-5 of max|output|; encode and
decode at two tiny configs within 1e-4 of max|output| (float32
convolutions summed in another order through a dozen layers); quantize's
indices equal and its straight-through gradient exact; the taming-key
converter and ``load_vqgan``'s candidates load the same weights in both
packages (decode within 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_style_tpu.models import vqgan as jax_vq
from maua_style_tpu.models.clip.convert import save_clip_npz
from maua_style_tpu_torch.models import vqgan as vq
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

CONFIGS = {
    # the JAX engine test's config: GroupNorm falls back to gcd groups
    "tiny": vq.VQGANConfig(embed_dim=8, n_embed=32, ch=16, ch_mult=(1, 2), num_res_blocks=1,
                           attn_resolutions=(8,), resolution=16, z_channels=8),
    # 32 groups, two blocks a level, attention at the last of three levels
    "small": vq.VQGANConfig(embed_dim=16, n_embed=64, ch=32, ch_mult=(1, 1, 2), num_res_blocks=2,
                            attn_resolutions=(4,), resolution=16, z_channels=16),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x, np.float32), (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _perturbed(tree, seed):
    """JAX's params with random biases and norm gains, as numpy."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        v = np.asarray(v, np.float32)
        name = getattr(path[-1], "key", None)
        if name in ("b", "g"):
            return v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
        return v

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(config name, JAX params (numpy), the port's VQGAN on them)."""
    cfg = CONFIGS[request.param]
    jcfg = jax_vq.VQGANConfig(**cfg.__dict__)
    tree = _perturbed(jax_vq.init_vqgan_params(jcfg, seed=1), seed=2)
    model = vq.vqgan_from_state_dict(vq.vqgan_params_from_jax(tree), cfg).eval().requires_grad_(False)
    return request.param, jcfg, tree, model


@pytest.mark.parametrize("c", [16, 24, 32, 64])
def test_group_norm(c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((2, 5, 6, c)).astype(np.float32) * 3 + 1
    p = {"g": rng.standard_normal(c).astype(np.float32), "b": rng.standard_normal(c).astype(np.float32)}
    want = np.asarray(jax_vq.group_norm(p, jnp.asarray(x)))
    norm = vq.Normalize(c)
    norm.load_state_dict({"weight": torch.from_numpy(p["g"]), "bias": torch.from_numpy(p["b"])})
    assert norm.eps == 1e-6 and norm.num_groups == (32 if c % 32 == 0 else np.gcd(32, c))
    with torch.no_grad():
        got = _nhwc(norm(_nchw(x)))
    assert _rel(got, want) <= 1e-5, _rel(got, want)


def _load(module, tree):
    module.load_state_dict(vq.vqgan_params_from_jax(tree), strict=True)
    return module.eval()


@pytest.mark.parametrize("block", ["resnet", "resnet_shortcut", "attn", "downsample", "upsample"])
def test_blocks(pair, block):
    _, jcfg, tree, _ = pair
    enc = tree["encoder"]
    if block == "resnet":
        p, jfn, module, cin = enc["down"][0]["block"][0], jax_vq.resnet_block, vq.ResnetBlock(jcfg.ch, jcfg.ch), jcfg.ch
    elif block == "resnet_shortcut":
        p = enc["down"][1]["block"][0]
        cin, cout = jcfg.ch * jcfg.ch_mult[0], jcfg.ch * jcfg.ch_mult[1]
        jfn, module = jax_vq.resnet_block, vq.ResnetBlock(cin, cout)
    elif block == "attn":
        cin = jcfg.ch * jcfg.ch_mult[-1]
        p, jfn, module = enc["mid"]["attn_1"], jax_vq.attn_block, vq.AttnBlock(cin)
    elif block == "downsample":
        p, jfn, module, cin = enc["down"][0]["downsample"], jax_vq.downsample, vq.Downsample(jcfg.ch), jcfg.ch
    else:
        up = tree["decoder"]["up"][1]
        cin = jcfg.ch * jcfg.ch_mult[1]
        p, jfn, module = up["upsample"], jax_vq.upsample, vq.Upsample(cin)
    x = np.random.default_rng(5).standard_normal((2, 7, 9, cin)).astype(np.float32)
    want = np.asarray(jfn(p, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(_load(module, p)(_nchw(x)))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5, _rel(got, want)


@pytest.mark.parametrize("hw", [(16, 16), (24, 40)])
def test_encode(pair, hw):
    """Attention sits where the config's resolution counter says, whatever
    the input's size."""
    _, jcfg, tree, model = pair
    x = np.random.default_rng(hw[1]).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_vq.encode(tree, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = _nhwc(model.encode(_nchw(x)))
    f = jcfg.downsample_factor
    assert got.shape == want.shape == (2, hw[0] // f, hw[1] // f, jcfg.embed_dim)
    assert _rel(got, want) <= 1e-4, _rel(got, want)


@pytest.mark.parametrize("hw", [(2, 2), (3, 5)])
def test_decode(pair, hw):
    _, jcfg, tree, model = pair
    rng = np.random.default_rng(hw[1])
    idx = rng.integers(0, jcfg.n_embed, (2, *hw))
    z_q = np.asarray(tree["codebook"])[idx]
    want = np.asarray(jax_vq.decode(tree, jnp.asarray(z_q), jcfg))
    with torch.no_grad():
        got = _nhwc(model.decode(model.lookup(torch.from_numpy(idx))))
    f = jcfg.downsample_factor
    assert got.shape == want.shape == (2, hw[0] * f, hw[1] * f, 3)
    assert _rel(got, want) <= 1e-4, _rel(got, want)


def test_quantize_indices_and_straight_through(pair):
    _, jcfg, tree, model = pair
    rng = np.random.default_rng(9)
    z = rng.standard_normal((2, 3, 4, jcfg.embed_dim)).astype(np.float32) * 0.05
    cot = rng.standard_normal(z.shape).astype(np.float32)
    cb = jnp.asarray(tree["codebook"])
    want = np.asarray(jax_vq.quantize(jnp.asarray(z), cb))
    d = jnp.sum(jnp.asarray(z) ** 2, -1, keepdims=True) + jnp.sum(cb ** 2, 1) - 2 * jnp.einsum("...d,nd->...n", z, cb)
    want_idx = np.asarray(jnp.argmin(d, -1))
    want_g = np.asarray(jax.grad(lambda zz: jnp.sum(jax_vq.quantize(zz, cb) * cot))(jnp.asarray(z)))

    zt = _nchw(z).requires_grad_(True)
    np.testing.assert_array_equal(model.code_indices(zt).numpy(), want_idx)
    assert len(np.unique(want_idx)) > 4
    out = model.quantize_st(zt)
    np.testing.assert_array_equal(_nhwc(out), want)
    (out * _nchw(cot)).sum().backward()
    np.testing.assert_array_equal(_nhwc(zt.grad), want_g)
    np.testing.assert_array_equal(want_g, cot)


def _taming_dict(model):
    """A taming checkpoint's state dict: prefixed keys, and the loss's and
    other modules' keys beside the first stage's."""
    sd = {"first_stage_model." + k: v.clone() for k, v in model.state_dict().items()}
    sd["first_stage_model.loss.discriminator.main.0.weight"] = torch.randn(4, 3, 4, 4)
    sd["first_stage_model.loss.logvar"] = torch.zeros(())
    sd["cond_stage_model.embedding.weight"] = torch.randn(5, 2)
    return sd


def test_taming_converter(pair):
    _, jcfg, tree, model = pair
    sd = _taming_dict(model)
    conv = vq.convert_vqgan_state_dict(sd)
    assert set(conv) == set(model.state_dict())
    again = vq.vqgan_from_state_dict(conv, model.cfg).eval()
    idx = torch.from_numpy(np.random.default_rng(3).integers(0, jcfg.n_embed, (1, 2, 3)))
    with torch.no_grad():
        want = model.decode(model.lookup(idx))
        np.testing.assert_array_equal(again.decode(again.lookup(idx)).numpy(), want.numpy())
    # JAX's converter reads the same dict to the same decoder
    jtree = jax_vq.convert_vqgan_state_dict(sd, jcfg)
    z_q = np.asarray(jtree["codebook"])[idx.numpy()]
    ref = np.asarray(jax_vq.decode(jtree, jnp.asarray(z_q), jcfg))
    assert _rel(_nhwc(want), ref) <= 1e-4


def test_load_vqgan_candidates(pair, tmp_path, monkeypatch):
    """``modelzoo/vqgan_<preset>.npz`` (JAX's tree) first, then
    ``modelzoo/<preset>.ckpt`` (taming); both packages load each alike."""
    name, jcfg, tree, model = pair
    monkeypatch.setitem(vq.PRESETS, name, model.cfg)
    monkeypatch.setitem(jax_vq.PRESETS, name, jcfg)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "modelzoo").mkdir()
    idx = np.random.default_rng(4).integers(0, jcfg.n_embed, (1, 2, 2))

    def decoded(m):
        with torch.no_grad():
            return _nhwc(m.decode(m.lookup(torch.from_numpy(idx))))

    def jax_decoded():
        params, cfg = jax_vq.load_vqgan(name)
        return np.asarray(jax_vq.decode(params, jnp.asarray(np.asarray(params["codebook"])[idx]), cfg))

    want = decoded(model)
    save_clip_npz(tree, f"modelzoo/vqgan_{name}.npz")
    torch.save({"state_dict": _taming_dict(vq.init_vqgan(model.cfg, seed=7))}, f"modelzoo/{name}.ckpt")
    np.testing.assert_array_equal(decoded(vq.load_vqgan(name)), want)  # the .npz wins
    assert _rel(jax_decoded(), want) <= 1e-4
    (tmp_path / "modelzoo" / f"vqgan_{name}.npz").unlink()
    from_ckpt = decoded(vq.load_vqgan(name))
    np.testing.assert_array_equal(from_ckpt, decoded(vq.init_vqgan(model.cfg, seed=7)))
    assert _rel(jax_decoded(), from_ckpt) <= 1e-4


def test_init_vqgan_seeded():
    cfg = CONFIGS["small"]
    a, b, c = (vq.init_vqgan(cfg, seed).requires_grad_(False) for seed in (0, 0, 1))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.codebook, c.codebook)
    assert float(a.codebook.abs().max()) <= 1.0 / cfg.n_embed
    w = a.decoder.conv_in.weight
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * cfg.z_channels))) < 0.02 and not a.decoder.conv_in.bias.any()
